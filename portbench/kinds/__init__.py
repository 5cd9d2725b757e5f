"""The drivers of the request kinds a traffic mix names (``"kind"``).

A driver is built on a :class:`portbench.core.Run` and has ``setup()``
(inputs from the seed, the system under test, warm-up of the cell's shapes),
``reference_s`` (the seconds of set-up spent on the reference's own work,
which ``setup_s`` leaves out), ``request(i)`` (one timed request; returns
``(ok, work counts)`` once its answer is on the host), ``flops_per(unit)``
(useful operations of one unit of work, or None), ``probe(layer)`` (a call
of one layer at the cell's batch and dtype with its frozen counts, or None),
``release()`` (frees the program's state) and ``check(control=None)`` (the
numbers compared with the reference; with ``control``, the reference at
that precision in the program's place).
"""
