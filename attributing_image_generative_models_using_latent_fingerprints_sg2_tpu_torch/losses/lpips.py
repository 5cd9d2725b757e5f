"""LPIPS-VGG16 perceptual distance, NHWC.

Counterpart of the VGG path of the reference package's ``losses/lpips.py``:
scaling layer, VGG16 slices relu1_2 / relu2_2 / relu3_3 / relu4_3 /
relu5_3, per-channel unit normalization, squared differences through the
1x1 lin heads, spatial mean, sum over the five slices.

The backbone runs through the port's kernels: slice 1 (conv1_1 + conv1_2)
through ``vgg_slice1``, every square conv through ``conv3x3_relu``; the
three channel-changing convs (conv2_1, conv3_1, conv4_1) are plain
``F.conv2d`` + ReLU, as the reference computes them outside Pallas.  On a
CPU tensor the kernels' plain versions run instead.  The tensor-core kernels
read the weights in a packed form that ``ops/tf32.py`` caches per weight
tensor, so the parameters here stay plain HWIO tensors and nothing is packed
per call.

The solver's distance head (:func:`distance_from_raw_features`) has the
reference's analytic backward: it recomputes the normalize/diff chain from
the raw feature and the saved norm, and treats the cached target features
and the lin heads as constants.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.pool import maxpool2x2
from ..ops.vgg_cuda import conv3x3_plain, conv3x3_relu
from ..ops.vgg_slice_cuda import vgg_slice1
from ..utils.tree import tree_to

VGG16_PLAN: Tuple[Any, ...] = (
    64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512
)
SLICE_END_CONV = (1, 3, 6, 9, 12)  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
LPIPS_CHANNELS = (64, 128, 256, 512, 512)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def scaling_layer(x: torch.Tensor) -> torch.Tensor:
    """(x - shift) / scale on [-1, 1] RGB, channels last."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    return (x - shift) / scale


def vgg16_features(params: Sequence[Dict[str, torch.Tensor]], x: torch.Tensor) -> List[torch.Tensor]:
    """Scaled [B, H, W, 3] -> the five post-ReLU slice outputs."""
    x = vgg_slice1(x, params[0]["weight"], params[0]["bias"],
                   params[1]["weight"], params[1]["bias"])
    feats = [x]
    conv_i = 2
    for item in VGG16_PLAN[2:]:
        if item == "M":
            x = maxpool2x2(x)
            continue
        p = params[conv_i]
        if p["weight"].shape[2] == p["weight"].shape[3]:
            x = conv3x3_relu(x, p["weight"], p["bias"])
        else:
            x = torch.relu(conv3x3_plain(x, p["weight"], p["bias"]))
        if conv_i in SLICE_END_CONV:
            feats.append(x)
        conv_i += 1
    return feats


def normalize_feat(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True))
    return f / (norm + eps)


def extract_raw_features(params: Dict[str, Any], img: torch.Tensor) -> List[torch.Tensor]:
    """[-1, 1] NHWC image -> un-normalized VGG16 slice outputs."""
    return vgg16_features(params["vgg"], scaling_layer(img))


def extract_features(params: Dict[str, Any], img: torch.Tensor) -> List[torch.Tensor]:
    return [normalize_feat(f) for f in extract_raw_features(params, img)]


def distance_from_features(params, feats0, feats1):
    """Per-sample LPIPS distance from pre-normalized features."""
    total = None
    for f0, f1, lin_w in zip(feats0, feats1, params["lin"]):
        d = torch.mean(torch.sum((f0 - f1) ** 2 * lin_w, dim=-1), dim=(-2, -1))
        total = d if total is None else total + d
    return total


def lpips(params, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    return distance_from_features(params, extract_features(params, img0),
                                  extract_features(params, img1))


class _FusedSliceDistance(torch.autograd.Function):
    """d = mean_hw sum_c lin_c (normalize(f) - t)^2 with the reference's
    hand-derived backward; ``t`` and ``lin`` get no gradient."""

    @staticmethod
    def forward(ctx, f, t, lin, eps):
        norm = torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True))
        fn = f / (norm + eps)
        d = torch.mean(torch.sum((fn - t) ** 2 * lin, dim=-1), dim=(-2, -1))
        ctx.save_for_backward(f, t, lin, norm)
        ctx.eps = eps
        return d

    @staticmethod
    def backward(ctx, g):
        f, t, lin, norm = ctx.saved_tensors
        denom = norm + ctx.eps
        e = f / denom - t
        hw = f.shape[-3] * f.shape[-2]
        u = e * (lin * (2.0 / hw)) * g[..., None, None, None]
        s = torch.sum(u * f, dim=-1, keepdim=True)
        df = u / denom - f * (s / (norm * denom * denom))
        return df, None, None, None


def distance_from_raw_features(params, raw_feats, target_norm_feats, eps: float = 1e-10):
    """LPIPS distance of RAW features against cached NORMALIZED target
    features (broadcast over leading dims), with the fused analytic backward."""
    total = None
    for f, t, lin_w in zip(raw_feats, target_norm_feats, params["lin"]):
        d = _FusedSliceDistance.apply(f, t, lin_w, eps)
        total = d if total is None else total + d
    return total


def init_lpips_params(generator: Optional[torch.Generator] = None, device="cpu") -> Dict[str, Any]:
    """Random-backbone LPIPS (He-init convs, uniform lin heads): the
    degraded-but-valid mode when no pretrained VGG16 weights are on disk."""
    vgg, cin = [], 3
    for item in VGG16_PLAN:
        if item == "M":
            continue
        cout = int(item)
        w = torch.randn((3, 3, cin, cout), generator=generator) * math.sqrt(2.0 / (cin * 9))
        vgg.append({"weight": w, "bias": torch.zeros((cout,))})
        cin = cout
    lin = [torch.ones((c,)) / c for c in LPIPS_CHANNELS]
    return tree_to({"vgg": vgg, "lin": lin}, device)


def params_from_jax(tree: Any, device="cpu") -> Dict[str, Any]:
    """The JAX package's VGG LPIPS params ({'vgg': convs HWIO, 'lin': heads}),
    same layout, -> tensors on ``device``."""
    return tree_to({"vgg": tree["vgg"], "lin": tree["lin"]}, device)


def vgg16_params_from_torch_state_dict(sd: Dict[str, Any]) -> List[Dict[str, np.ndarray]]:
    """torchvision vgg16 ``features.{i}.weight`` [O, I, 3, 3] -> HWIO list."""
    indices, i = [], 0
    for item in VGG16_PLAN:
        if item == "M":
            i += 1
        else:
            indices.append(i)
            i += 2
    return [
        {"weight": np.transpose(np.asarray(sd[f"features.{li}.weight"], np.float32), (2, 3, 1, 0)),
         "bias": np.asarray(sd[f"features.{li}.bias"], np.float32)}
        for li in indices
    ]


def lin_weights_from_torch_state_dict(sd: Dict[str, Any], n_layers: int = 5) -> List[np.ndarray]:
    """LPIPS lin-head blob (``lin{k}.model.1.weight`` [1, C, 1, 1]) -> [C] vectors."""
    return [np.asarray(sd[f"lin{k}.model.1.weight"], np.float32).reshape(-1) for k in range(n_layers)]


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().float().numpy() for k, v in sd.items()}


def build_lpips_params(generator: Optional[torch.Generator] = None, device="cpu",
                       vgg_path: Optional[str] = None, lin_path: Optional[str] = None):
    """Random LPIPS, with the torchvision VGG16 backbone and/or the LPIPS
    lin heads (``vgg.pth``) loaded from disk where given."""
    params = init_lpips_params(generator, device)
    if vgg_path is not None:
        params["vgg"] = tree_to(vgg16_params_from_torch_state_dict(_load_state_dict(vgg_path)), device)
    if lin_path is not None:
        params["lin"] = tree_to(lin_weights_from_torch_state_dict(_load_state_dict(lin_path)), device)
    return params

