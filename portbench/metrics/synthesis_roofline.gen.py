"""Synthesis' bound (frozen counts, at the cell's batch and dtype: forward and
backward to w+ in a solve, forward in generation) over its device time, percent."""


def read(run):
    return run.layer_share("synthesis")
