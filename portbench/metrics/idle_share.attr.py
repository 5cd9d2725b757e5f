"""Percent of the traced window in which no operation ran on the card (the
union of the device operations' intervals in the profiler's trace)."""

from portbench.metrics._shares import idle_share as read  # noqa: F401
