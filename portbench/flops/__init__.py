"""Frozen operation and byte counts of the benchmark, by layer, from shapes
alone: they read the same work whatever kernel, fusion or library call the
program puts in its place."""
