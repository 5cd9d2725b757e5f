"""InceptionV3 pool3 features (2048-d) for FID.

Counterpart of the reference package's ``eval/inception.py``: torchvision's
``inception_v3`` up to the global average pool, with pytorch-fid's
``Mixed_7c`` (its pool branch a 3x3 max pool, ``FIDInceptionE_2``).  Functions
on a parameter tree in the reference's layout: per ``BasicConv2d`` an HWIO
weight ``w`` and the frozen batch-norm statistics ``gamma``, ``beta``,
``mean``, ``var`` (eps 1e-3), folded to a per-channel scale and bias in
float32 at the call.  The network runs in NCHW (cuDNN's layout) and takes and
returns NHWC at its boundary.  Random weights (:func:`init_inception_params`)
make an honest but only ordinal FID; :func:`params_from_torch_state_dict`
reads a local torchvision / pytorch-fid file.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from ..utils.tree import tree_to

Params = Dict[str, Any]
BN_EPS = 1e-3


def _conv_bn(x: torch.Tensor, p: Dict[str, torch.Tensor], stride: int = 1, padding=0) -> torch.Tensor:
    """BasicConv2d on NCHW: conv (no bias), frozen BN as scale and bias, ReLU."""
    y = F.conv2d(x, p["w"].to(x.dtype).permute(3, 2, 0, 1), stride=stride, padding=padding)
    root = torch.sqrt(p["var"] + BN_EPS)
    scale = (p["gamma"] / root).to(y.dtype)
    bias = (p["beta"] - p["mean"] * p["gamma"] / root).to(y.dtype)
    return torch.relu(y * scale[:, None, None] + bias[:, None, None])


def _avgpool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def _inception_a(x, p):
    b1 = _conv_bn(x, p["b1x1"])
    b5 = _conv_bn(_conv_bn(x, p["b5_1"]), p["b5_2"], padding=2)
    b3 = _conv_bn(_conv_bn(_conv_bn(x, p["b3_1"]), p["b3_2"], padding=1), p["b3_3"], padding=1)
    bp = _conv_bn(_avgpool(x), p["bpool"])
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(x, p):
    b3 = _conv_bn(x, p["b3"], stride=2)
    bd = _conv_bn(_conv_bn(_conv_bn(x, p["bd_1"]), p["bd_2"], padding=1), p["bd_3"], stride=2)
    return torch.cat([b3, bd, _maxpool(x)], dim=1)


def _inception_c(x, p):
    b1 = _conv_bn(x, p["b1x1"])
    b7 = _conv_bn(x, p["b7_1"])
    b7 = _conv_bn(b7, p["b7_2"], padding=(0, 3))
    b7 = _conv_bn(b7, p["b7_3"], padding=(3, 0))
    bd = _conv_bn(x, p["bd_1"])
    bd = _conv_bn(bd, p["bd_2"], padding=(3, 0))
    bd = _conv_bn(bd, p["bd_3"], padding=(0, 3))
    bd = _conv_bn(bd, p["bd_4"], padding=(3, 0))
    bd = _conv_bn(bd, p["bd_5"], padding=(0, 3))
    bp = _conv_bn(_avgpool(x), p["bpool"])
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(x, p):
    b3 = _conv_bn(_conv_bn(x, p["b3_1"]), p["b3_2"], stride=2)
    b7 = _conv_bn(x, p["b7_1"])
    b7 = _conv_bn(b7, p["b7_2"], padding=(0, 3))
    b7 = _conv_bn(b7, p["b7_3"], padding=(3, 0))
    b7 = _conv_bn(b7, p["b7_4"], stride=2)
    return torch.cat([b3, b7, _maxpool(x)], dim=1)


def _inception_e(x, p, pool: str):
    b1 = _conv_bn(x, p["b1x1"])
    b3 = _conv_bn(x, p["b3_1"])
    b3 = torch.cat([_conv_bn(b3, p["b3_2a"], padding=(0, 1)), _conv_bn(b3, p["b3_2b"], padding=(1, 0))], dim=1)
    bd = _conv_bn(_conv_bn(x, p["bd_1"]), p["bd_2"], padding=1)
    bd = torch.cat([_conv_bn(bd, p["bd_3a"], padding=(0, 1)), _conv_bn(bd, p["bd_3b"], padding=(1, 0))], dim=1)
    # pytorch-fid's FIDInceptionE_2 pools by max (stride 1, -inf padding) in Mixed_7c
    bp = F.max_pool2d(x, 3, 1, 1) if pool == "max" else _avgpool(x)
    return torch.cat([b1, b3, bd, _conv_bn(bp, p["bpool"])], dim=1)


def inception_features(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] in [-1, 1] (299 px for FID) -> [B, 2048] pool3 features."""
    y = x.permute(0, 3, 1, 2)
    y = _conv_bn(y, params["c1a"], stride=2)
    y = _conv_bn(y, params["c2a"])
    y = _conv_bn(y, params["c2b"], padding=1)
    y = _maxpool(y)
    y = _conv_bn(y, params["c3b"])
    y = _conv_bn(y, params["c4a"])
    y = _maxpool(y)
    for name in ("m5b", "m5c", "m5d"):
        y = _inception_a(y, params[name])
    y = _inception_b(y, params["m6a"])
    for name in ("m6b", "m6c", "m6d", "m6e"):
        y = _inception_c(y, params[name])
    y = _inception_d(y, params["m7a"])
    y = _inception_e(y, params["m7b"], pool="avg")
    y = _inception_e(y, params["m7c"], pool="max")
    return torch.mean(y, dim=(2, 3))


def preprocess(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """[-1, 1] NHWC at any size -> size x size, resized bilinearly in [0, 1] and
    mapped back to [-1, 1] (pytorch-fid's recipe).  Half-pixel centres; a
    downscale widens the triangle kernel (antialiased, as the reference's
    ``jax.image.resize``), an upscale does not."""
    x01 = ((images + 1.0) / 2.0).permute(0, 3, 1, 2)
    down = x01.shape[2] > size or x01.shape[3] > size
    x01 = F.interpolate(x01, size=(size, size), mode="bilinear", align_corners=False, antialias=down)
    return x01.permute(0, 2, 3, 1) * 2.0 - 1.0


# ---------------------------------------------------------------------------
# init / conversion
# ---------------------------------------------------------------------------

# (cin, cout, (kh, kw)) per BasicConv2d, in the reference's order of parameter draws
def _spec() -> Dict[str, Any]:
    def a_block(cin, pool_feat):
        return {"b1x1": (cin, 64, 1), "b5_1": (cin, 48, 1), "b5_2": (48, 64, 5), "b3_1": (cin, 64, 1),
                "b3_2": (64, 96, 3), "b3_3": (96, 96, 3), "bpool": (cin, pool_feat, 1)}

    def c_block(c7):
        return {"b1x1": (768, 192, 1), "b7_1": (768, c7, 1), "b7_2": (c7, c7, (1, 7)), "b7_3": (c7, 192, (7, 1)),
                "bd_1": (768, c7, 1), "bd_2": (c7, c7, (7, 1)), "bd_3": (c7, c7, (1, 7)),
                "bd_4": (c7, c7, (7, 1)), "bd_5": (c7, 192, (1, 7)), "bpool": (768, 192, 1)}

    def e_block(cin):
        return {"b1x1": (cin, 320, 1), "b3_1": (cin, 384, 1), "b3_2a": (384, 384, (1, 3)),
                "b3_2b": (384, 384, (3, 1)), "bd_1": (cin, 448, 1), "bd_2": (448, 384, 3),
                "bd_3a": (384, 384, (1, 3)), "bd_3b": (384, 384, (3, 1)), "bpool": (cin, 192, 1)}

    return {
        "c1a": (3, 32, 3), "c2a": (32, 32, 3), "c2b": (32, 64, 3), "c3b": (64, 80, 1), "c4a": (80, 192, 3),
        "m5b": a_block(192, 32), "m5c": a_block(256, 64), "m5d": a_block(288, 64),
        "m6a": {"b3": (288, 384, 3), "bd_1": (288, 64, 1), "bd_2": (64, 96, 3), "bd_3": (96, 96, 3)},
        "m6b": c_block(128), "m6c": c_block(160), "m6d": c_block(160), "m6e": c_block(192),
        "m7a": {"b3_1": (768, 192, 1), "b3_2": (192, 320, 3), "b7_1": (768, 192, 1), "b7_2": (192, 192, (1, 7)),
                "b7_3": (192, 192, (7, 1)), "b7_4": (192, 192, 3)},
        "m7b": e_block(1280), "m7c": e_block(2048),
    }


def _basic_conv(generator: Optional[torch.Generator], cin: int, cout: int, k) -> Dict[str, torch.Tensor]:
    kh, kw = (k, k) if isinstance(k, int) else k
    return {"w": torch.randn((kh, kw, cin, cout), generator=generator) * math.sqrt(2.0 / (cin * kh * kw)),
            "gamma": torch.ones((cout,)), "beta": torch.zeros((cout,)), "mean": torch.zeros((cout,)),
            "var": torch.ones((cout,))}


def init_inception_params(generator: Optional[torch.Generator] = None, device="cuda") -> Params:
    """Random He-init weights with identity BN statistics, drawn in the
    reference's order from ``generator`` (another stream than its PRNG key),
    on the card unless the caller asks for ``"cpu"``."""
    def build(spec):
        if isinstance(spec, tuple):
            return _basic_conv(generator, *spec)
        return {k: build(v) for k, v in spec.items()}

    return tree_to(build(_spec()), resolve_device(device))


def params_from_jax(tree: Any, device) -> Params:
    """The reference package's Inception params (same layout) -> tensors on ``device``."""
    return tree_to(tree, device)


_TORCH_BLOCK_MAP = {
    "c1a": "Conv2d_1a_3x3", "c2a": "Conv2d_2a_3x3", "c2b": "Conv2d_2b_3x3",
    "c3b": "Conv2d_3b_1x1", "c4a": "Conv2d_4a_3x3",
    "m5b": "Mixed_5b", "m5c": "Mixed_5c", "m5d": "Mixed_5d",
    "m6a": "Mixed_6a", "m6b": "Mixed_6b", "m6c": "Mixed_6c",
    "m6d": "Mixed_6d", "m6e": "Mixed_6e",
    "m7a": "Mixed_7a", "m7b": "Mixed_7b", "m7c": "Mixed_7c",
}


def _branch_names(short: str) -> Dict[str, str]:
    """A block's (parameter key -> torchvision branch) names."""
    if short in ("m5b", "m5c", "m5d"):
        return {"b1x1": "branch1x1", "b5_1": "branch5x5_1", "b5_2": "branch5x5_2", "b3_1": "branch3x3dbl_1",
                "b3_2": "branch3x3dbl_2", "b3_3": "branch3x3dbl_3", "bpool": "branch_pool"}
    if short == "m6a":
        return {"b3": "branch3x3", "bd_1": "branch3x3dbl_1", "bd_2": "branch3x3dbl_2", "bd_3": "branch3x3dbl_3"}
    if short in ("m6b", "m6c", "m6d", "m6e"):
        return {"b1x1": "branch1x1", "b7_1": "branch7x7_1", "b7_2": "branch7x7_2", "b7_3": "branch7x7_3",
                "bd_1": "branch7x7dbl_1", "bd_2": "branch7x7dbl_2", "bd_3": "branch7x7dbl_3",
                "bd_4": "branch7x7dbl_4", "bd_5": "branch7x7dbl_5", "bpool": "branch_pool"}
    if short == "m7a":
        return {"b3_1": "branch3x3_1", "b3_2": "branch3x3_2", "b7_1": "branch7x7x3_1", "b7_2": "branch7x7x3_2",
                "b7_3": "branch7x7x3_3", "b7_4": "branch7x7x3_4"}
    return {"b1x1": "branch1x1", "b3_1": "branch3x3_1", "b3_2a": "branch3x3_2a", "b3_2b": "branch3x3_2b",
            "bd_1": "branch3x3dbl_1", "bd_2": "branch3x3dbl_2", "bd_3a": "branch3x3dbl_3a",
            "bd_3b": "branch3x3dbl_3b", "bpool": "branch_pool"}


def torch_name_pairs() -> Iterator[Tuple[str, Optional[str], str]]:
    """(block, parameter key or None, torchvision prefix) for every
    BasicConv2d of the network."""
    spec = _spec()
    for short, tname in _TORCH_BLOCK_MAP.items():
        if isinstance(spec[short], tuple):
            yield short, None, tname
        else:
            names = _branch_names(short)
            for leaf in spec[short]:
                yield short, leaf, f"{tname}.{names[leaf]}"


def params_from_torch_state_dict(sd: Dict[str, Any], device="cuda") -> Params:
    """torchvision / pytorch-fid ``inception_v3`` names (``<prefix>.conv.weight``
    OIHW, ``<prefix>.bn.{weight,bias,running_mean,running_var}``) -> the tree, on
    ``device``."""
    def conv(prefix):
        return {"w": np.transpose(np.asarray(sd[f"{prefix}.conv.weight"], np.float32), (2, 3, 1, 0)),
                "gamma": np.asarray(sd[f"{prefix}.bn.weight"], np.float32),
                "beta": np.asarray(sd[f"{prefix}.bn.bias"], np.float32),
                "mean": np.asarray(sd[f"{prefix}.bn.running_mean"], np.float32),
                "var": np.asarray(sd[f"{prefix}.bn.running_var"], np.float32)}

    out: Params = {}
    for short, leaf, prefix in torch_name_pairs():
        if leaf is None:
            out[short] = conv(prefix)
        else:
            out.setdefault(short, {})[leaf] = conv(prefix)
    return tree_to(out, resolve_device(device))
