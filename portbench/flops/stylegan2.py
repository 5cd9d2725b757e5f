"""Operations and bytes of StyleGAN2's synthesis network (Karras et al.,
arXiv:1912.04958; rosinality's layout), counted from shapes.

Every convolution counts as a direct convolution: two operations a
multiply-add, over the non-zero inputs only (a stride-2 transposed 3x3 conv
multiplies each input sample by 9 taps).  The 4-tap FIRs count 16 taps an
output (the post-conv blur) and 4 an output plus the add (the ToRGB skip
upsample).  The modulation, demodulation, noise, bias and activation are
elementwise and are not counted.  The backward to w+ repeats every
convolution and FIR once (their input gradients); the weights get no
gradient.
"""

from __future__ import annotations

import math
from typing import Dict


def channel_map(channel_multiplier: int = 2, channel_max: int = 512) -> Dict[int, int]:
    """Channels at each resolution (rosinality ``Generator.channels``), capped."""
    base = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
            256: 64 * channel_multiplier, 512: 32 * channel_multiplier, 1024: 16 * channel_multiplier}
    return {k: min(v, channel_max) for k, v in base.items()}


def forward_flops(cfg: dict) -> Dict[str, float]:
    """Operations of one image's synthesis forward, by kind: ``conv`` (the
    modulated convs and ToRGBs), ``fir`` (blurs and skip upsamples),
    ``style`` (the affine maps to the styles)."""
    ch = channel_map(cfg["channel_multiplier"], cfg["channel_max"])
    d = cfg["style_dim"]
    conv = 2.0 * 9 * ch[4] * ch[4] * 16 + 2.0 * ch[4] * 3 * 16
    style = 2.0 * d * ch[4] * 2
    fir = 0.0
    cin = ch[4]
    for k in range(3, int(math.log2(cfg["img_size"])) + 1):
        r, cout = 1 << k, ch[1 << k]
        conv += 2.0 * 9 * cin * cout * (r // 2) ** 2  # transposed conv, stride 2
        fir += 2.0 * 16 * cout * r * r  # blur after it
        conv += 2.0 * 9 * cout * cout * r * r
        conv += 2.0 * cout * 3 * r * r  # ToRGB
        fir += (2.0 * 4 + 1) * 3 * r * r  # skip upsample and its add
        style += 2.0 * d * (cin + cout + cout)
        cin = cout
    return {"conv": conv, "fir": fir, "style": style}


def n_params(cfg: dict) -> int:
    """Elements of the generator's parameters that synthesis reads."""
    ch = channel_map(cfg["channel_multiplier"], cfg["channel_max"])
    d = cfg["style_dim"]

    def mod_conv(cin, cout, k):
        return k * k * cin * cout + d * cin + cin

    total = 16 * ch[4] + mod_conv(ch[4], ch[4], 3) + 1 + ch[4] + mod_conv(ch[4], 3, 1) + 3
    cin = ch[4]
    for k in range(3, int(math.log2(cfg["img_size"])) + 1):
        cout = ch[1 << k]
        total += mod_conv(cin, cout, 3) + 1 + cout + mod_conv(cout, cout, 3) + 1 + cout + mod_conv(cout, 3, 1) + 3
        cin = cout
    return total


def noise_elems(img_size: int) -> int:
    return sum((1 << ((i + 5) // 2)) ** 2 for i in range((int(math.log2(img_size)) - 2) * 2 + 1))


def synthesis(cfg: dict, batch: int, dtype: str, backward: bool) -> Dict[str, float]:
    """Operations and boundary bytes of synthesis at ``batch`` images in
    ``dtype``, forward or forward + backward to w+.  Bytes: w+ in, the image
    out, the float32 weights and noise read once; with the backward the
    image's cotangent in and w+'s gradient out as well."""
    f = forward_flops(cfg)
    flops = batch * sum(f.values()) * (2 if backward else 1)
    esz = 4 if dtype == "float32" else 2
    n_lat = 2 * int(math.log2(cfg["img_size"])) - 2
    lat = batch * n_lat * cfg["style_dim"]
    img = batch * cfg["img_size"] ** 2 * 3
    nbytes = 4.0 * (n_params(cfg) + noise_elems(cfg["img_size"])) + esz * (lat + img) * (2 if backward else 1)
    return {"flops": flops, "bytes": nbytes}
