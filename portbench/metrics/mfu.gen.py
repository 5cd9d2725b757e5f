"""Whole request's share of the card's peak: images of the traced window x
synthesis forward operations an image / the traced window's seconds / the
peak of the cell's dtype."""

from portbench.metrics._shares import mfu


def read(run):
    return mfu(run, "images")
