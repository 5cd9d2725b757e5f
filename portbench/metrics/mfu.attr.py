"""Whole solve step's share of the card's peak: chain-steps of the traced
window x useful operations a chain-step (synthesis and LPIPS, forward and
backward) / the traced window's seconds / the peak of the cell's dtype."""

from portbench.metrics._shares import mfu


def read(run):
    return mfu(run, "chain_steps")
