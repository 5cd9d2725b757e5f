"""The BigGAN-deep generator's SAGAN attention block's bound (frozen counts,
alone, forward and backward to its input at the solve's chains, at its own
shape) over its device time, percent."""


def read(run):
    return run.layer_share("attention")
