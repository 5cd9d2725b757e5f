"""LPIPS-VGG16's bound (frozen counts, forward and backward to the image at the
solve's batch and dtype) over its device time, percent."""


def read(run):
    return run.layer_share("lpips")
