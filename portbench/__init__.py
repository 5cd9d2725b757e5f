"""The benchmark of the PyTorch / CUDA port on one NVIDIA H100.

``run.py`` runs one cell once; everything a cell, a configuration, a traffic
mix or a metric needs is a file of its own here, found by the name that
``BENCHMARK.json`` gives it.  Nothing here imports JAX or the JAX package.
"""
