"""Operations and bytes of LPIPS-VGG16 (Zhang et al., arXiv:1801.03924) to
relu5_3 on an image of side ``img_size``, counted from shapes.

The thirteen 3x3 convs count as direct convolutions, two operations a
multiply-add; ReLU, pools, the unit normalization and the lin heads are
elementwise and are not counted.  The backward to the image repeats every
conv once (its input gradient, conv1_1's included); the weights get no
gradient.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)


def convs(img_size: int) -> List[Tuple[int, int, int]]:
    """(cin, cout, side) of every conv."""
    out, cin, side = [], 3, img_size
    for item in VGG16_PLAN:
        if item == "M":
            side //= 2
            continue
        out.append((cin, item, side))
        cin = item
    return out


def forward_flops(img_size: int) -> float:
    return sum(2.0 * 9 * cin * cout * s * s for cin, cout, s in convs(img_size))


def n_params(img_size: int) -> int:
    return sum(9 * cin * cout + cout for cin, cout, _ in convs(img_size)) + sum(LPIPS_CHANNELS)


def feature_elems(img_size: int) -> int:
    """Elements of one image's five normalized feature maps (a target's)."""
    sides = (img_size, img_size // 2, img_size // 4, img_size // 8, img_size // 16)
    return sum(c * s * s for c, s in zip(LPIPS_CHANNELS, sides))


def lpips(img_size: int, batch: int, dtype: str, backward: bool) -> Dict[str, float]:
    """Operations and boundary bytes of ``batch`` distances against one
    target's cached features: the images in, the float32 weights read once,
    the target's features read once, the distances out; with the backward
    the images' gradient out."""
    esz = 4 if dtype == "float32" else 2
    img = batch * img_size * img_size * 3
    flops = batch * forward_flops(img_size) * (2 if backward else 1)
    nbytes = 4.0 * n_params(img_size) + esz * (feature_elems(img_size) + img * (2 if backward else 1)) + 4.0 * batch
    return {"flops": flops, "bytes": nbytes}
