"""The BigGAN-deep generator's bound (frozen counts, forward and backward to z
at the solve's chains and dtype) over its device time, percent."""


def read(run):
    return run.layer_share("biggan")
