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
the raw feature, and treats the cached target features and the lin heads as
constants.  On a CUDA tensor each direction is one launch of
``ops/lpips_head_cuda.py``'s kernel; on the CPU its plain chain.

The backbone may instead be the trained StyleGAN2 discriminator
(``losses/disc_percept.py``, params with a ``"disc"`` key), or the
reference's two other LPIPS nets, AlexNet (relu1..relu5, params ``{"net":
[5 convs]}``) and SqueezeNet1.1 (relu1..relu7, params ``{"net": {"conv0",
"fires"}}``): the same heads, distance and solver path take their feature
maps.  Those two are plain ``F.conv2d`` in NCHW (the reference computes them
outside Pallas), their weights HWIO as the reference stores them and cast to
the input's dtype.  Beside the lin-head distance sit the reference's other
distance modes: :func:`mse_per_sample`, :func:`lpips_net_mode` (no lin heads)
and :func:`dssim_per_sample`.

In bfloat16 (the solver's bf16 mode) the backbone runs in the image's dtype;
norms, squares and sums are taken in float32 and the normalized features are
rounded back to the feature dtype, where the reference rounds them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.lpips_head_cuda import (
    lpips_head_backward,
    lpips_head_forward,
    lpips_head_plain_backward,
    lpips_head_plain_forward,
)
from ..ops.pool import maxpool2x2
from ..ops.vgg_cuda import conv3x3_relu
from ..ops.vgg_slice_cuda import vgg_slice1
from ..utils.device import resolve_device
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


def _conv3x3_in_dtype(x: torch.Tensor, w_hwio: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """conv2d(x, w, pad 1) + b in x's dtype (cuDNN): the three channel-changing
    convs, run as the reference runs them in the feature dtype (the conv's
    output rounded, then the bias added in that dtype)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.to(x.dtype).permute(3, 2, 0, 1), bias.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1)


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
            x = torch.relu(_conv3x3_in_dtype(x, p["weight"], p["bias"]))
        if conv_i in SLICE_END_CONV:
            feats.append(x)
        conv_i += 1
    return feats


# ---------------------------------------------------------------------------
# AlexNet and SqueezeNet1.1 (the reference's other LPIPS nets)
# ---------------------------------------------------------------------------

ALEX_CHANNELS = (64, 192, 384, 256, 256)
SQUEEZE_CHANNELS = (64, 128, 256, 384, 384, 512, 512)
# torchvision alexnet .features convs: (cout, k, stride, pad)
_ALEX_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
# squeezenet1_1 fire modules (squeeze, expand1x1, expand3x3), at .features 3, 4, 6, 7, 9, 10, 11, 12
_SQUEEZE_FIRES = ((16, 64, 64), (16, 64, 64), (32, 128, 128), (32, 128, 128),
                  (48, 192, 192), (48, 192, 192), (64, 256, 256), (64, 256, 256))
_SQUEEZE_FIRE_INDICES = (3, 4, 6, 7, 9, 10, 11, 12)
_ALEX_CONV_INDICES = (0, 3, 6, 8, 10)


def _conv2d(x: torch.Tensor, p: Dict[str, torch.Tensor], stride: int = 1, pad: int = 0) -> torch.Tensor:
    """NCHW conv with HWIO weights cast to x's dtype, then the bias in the
    output's dtype (the reference's ``_conv2d``)."""
    y = F.conv2d(x, p["weight"].to(x.dtype).permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y + p["bias"].to(y.dtype)[:, None, None]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def alexnet_features(params: Sequence[Dict[str, torch.Tensor]], x: torch.Tensor) -> List[torch.Tensor]:
    """Scaled [B, H, W, 3] -> AlexNet .features relu1..relu5 (NHWC); 3x3 / 2
    max pools before convs 1 and 2."""
    x, feats = x.permute(0, 3, 1, 2), []
    for i, (_, _, stride, pad) in enumerate(_ALEX_CONVS):
        if i in (1, 2):
            x = F.max_pool2d(x, 3, 2)
        x = torch.relu(_conv2d(x, params[i], stride, pad))
        feats.append(_nhwc(x))
    return feats


def _fire(x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    """SqueezeNet Fire: 1x1 squeeze, ReLU, (1x1 expand || 3x3 expand), ReLU, channel concat."""
    s = torch.relu(_conv2d(x, p["squeeze"]))
    return torch.cat([torch.relu(_conv2d(s, p["expand1x1"])), torch.relu(_conv2d(s, p["expand3x3"], pad=1))], dim=1)


def _pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """3x3 / 2 max pool in ceil mode: a partial last window (the reference pads
    the high side with -inf)."""
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


def squeezenet_features(params: Dict[str, Any], x: torch.Tensor) -> List[torch.Tensor]:
    """Scaled [B, H, W, 3] -> SqueezeNet1.1 .features relu1..relu7 (NHWC)."""
    fires = params["fires"]
    x = torch.relu(_conv2d(x.permute(0, 3, 1, 2), params["conv0"], stride=2))
    feats = [x]
    x = _fire(_fire(_pool_ceil(x), fires[0]), fires[1])
    feats.append(x)
    x = _fire(_fire(_pool_ceil(x), fires[2]), fires[3])
    feats.append(x)
    x = _fire(_pool_ceil(x), fires[4])
    feats.append(x)
    for fire in fires[5:]:
        x = _fire(x, fire)
        feats.append(x)
    return [_nhwc(f) for f in feats]


def normalize_feat(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit norm over channels, the norm accumulated in float32; in f's dtype."""
    f32 = f.float()
    norm = torch.sqrt(torch.sum(f32 * f32, dim=-1, keepdim=True))
    return (f32 / (norm + eps)).to(f.dtype)


def extract_raw_features(params: Dict[str, Any], img: torch.Tensor) -> List[torch.Tensor]:
    """[-1, 1] NHWC image -> un-normalized backbone feature maps, NHWC.  The
    backbone follows the params' structure: ``"disc"`` the trained
    discriminator (``losses/disc_percept.py``; [-1, 1] in, no scaling layer),
    ``"vgg"`` the VGG16 slices, else ``"net"``: SqueezeNet1.1 where it holds
    ``"fires"``, AlexNet otherwise."""
    if "disc" in params:
        from .disc_percept import disc_features

        return disc_features(params["disc"], img)
    x = scaling_layer(img)
    if "vgg" in params:
        return vgg16_features(params["vgg"], x)
    net = params["net"]
    if isinstance(net, dict) and "fires" in net:
        return squeezenet_features(net, x)
    return alexnet_features(net, x)


def backbone_in(params: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """``params`` with a discriminator backbone's feature layers cast to
    ``dtype`` once (``disc_percept.disc_features`` casts them on every call
    otherwise); a VGG backbone as it is."""
    if "disc" in params:
        from .disc_percept import cast_features

        return dict(params, disc=cast_features(params["disc"], dtype))
    return params


def extract_features(params: Dict[str, Any], img: torch.Tensor) -> List[torch.Tensor]:
    return [normalize_feat(f) for f in extract_raw_features(params, img)]


def distance_from_features(params, feats0, feats1, ret_per_layer: bool = False):
    """Per-sample LPIPS distance from pre-normalized features; with
    ``ret_per_layer`` also the list of per-layer distances."""
    total, per_layer = None, []
    for f0, f1, lin_w in zip(feats0, feats1, params["lin"]):
        d = torch.mean(torch.sum((f0 - f1).float() ** 2 * lin_w, dim=-1), dim=(-2, -1))
        per_layer.append(d)
        total = d if total is None else total + d
    if ret_per_layer:
        return total, per_layer
    return total


def lpips(params, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    return distance_from_features(params, extract_features(params, img0),
                                  extract_features(params, img1))


class _FusedSliceDistance(torch.autograd.Function):
    """d = mean_hw sum_c lin_c (normalize(f) - t)^2 with the reference's
    hand-derived backward; ``t`` and ``lin`` get no gradient.  The norm, the
    squares and the sums are float32; the normalized feature is rounded to
    f's dtype and the difference taken there, as the reference does (d is
    float32, df in f's dtype).  A CUDA ``f`` runs one launch of
    ``ops/lpips_head_cuda.py``'s kernel each way (the backward recomputes the
    norm from f); on the CPU the plain chain runs and keeps the norm."""

    @staticmethod
    def forward(ctx, f, t, lin, eps):
        ctx.eps, ctx.plain = eps, f.device.type == "cpu"
        if ctx.plain:
            d, norm = lpips_head_plain_forward(f, t, lin, eps)
            ctx.save_for_backward(f, t, lin, norm)
            return d
        f = f.contiguous()
        ctx.save_for_backward(f, t, lin)
        return lpips_head_forward(f, t, lin, eps)

    @staticmethod
    def backward(ctx, g):
        if ctx.plain:
            df = lpips_head_plain_backward(*ctx.saved_tensors, g, ctx.eps)
        else:
            df = lpips_head_backward(*ctx.saved_tensors, g, ctx.eps)
        return df, None, None, None


def distance_from_raw_features(params, raw_feats, target_norm_feats, eps: float = 1e-10):
    """LPIPS distance of RAW features against cached NORMALIZED target
    features (broadcast over leading dims), with the fused analytic backward."""
    total = None
    for f, t, lin_w in zip(raw_feats, target_norm_feats, params["lin"]):
        d = _FusedSliceDistance.apply(f, t, lin_w, eps)
        total = d if total is None else total + d
    return total


def _he_conv(generator: Optional[torch.Generator], k: int, cin: int, cout: int) -> Dict[str, torch.Tensor]:
    w = torch.randn((k, k, cin, cout), generator=generator) * math.sqrt(2.0 / (cin * k * k))
    return {"weight": w, "bias": torch.zeros((cout,))}


def init_lpips_params(generator: Optional[torch.Generator], device) -> Dict[str, Any]:
    """Random-backbone LPIPS (He-init convs, uniform lin heads): the
    degraded-but-valid mode when no pretrained VGG16 weights are on disk."""
    vgg, cin = [], 3
    for cout in (int(item) for item in VGG16_PLAN if item != "M"):
        vgg.append(_he_conv(generator, 3, cin, cout))
        cin = cout
    lin = [torch.ones((c,)) / c for c in LPIPS_CHANNELS]
    return tree_to({"vgg": vgg, "lin": lin}, device)


def init_alex_params(generator: Optional[torch.Generator], device) -> List[Dict[str, torch.Tensor]]:
    """Random He-init AlexNet backbone (the degraded mode, as init_lpips_params)."""
    convs, cin = [], 3
    for cout, k, _, _ in _ALEX_CONVS:
        convs.append(_he_conv(generator, k, cin, cout))
        cin = cout
    return tree_to(convs, device)


def init_squeeze_params(generator: Optional[torch.Generator], device) -> Dict[str, Any]:
    """Random He-init SqueezeNet1.1 backbone (the degraded mode)."""
    conv0, fires, cin = _he_conv(generator, 3, 3, 64), [], 64
    for s, e1, e3 in _SQUEEZE_FIRES:
        fires.append({"squeeze": _he_conv(generator, 1, cin, s), "expand1x1": _he_conv(generator, 1, s, e1),
                      "expand3x3": _he_conv(generator, 3, s, e3)})
        cin = e1 + e3
    return tree_to({"conv0": conv0, "fires": fires}, device)


def _hwio(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """torchvision conv ``<prefix>.weight`` [O, I, kh, kw] / ``.bias`` -> HWIO."""
    return {"weight": np.transpose(np.asarray(sd[f"{prefix}.weight"], np.float32), (2, 3, 1, 0)),
            "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def alexnet_params_from_torch_state_dict(sd: Dict[str, Any]) -> List[Dict[str, np.ndarray]]:
    """torchvision alexnet ``features.{0,3,6,8,10}`` convs -> HWIO list."""
    return [_hwio(sd, f"features.{i}") for i in _ALEX_CONV_INDICES]


def squeezenet_params_from_torch_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """torchvision squeezenet1_1 ``features.*`` -> {"conv0", "fires"} (HWIO)."""
    return {"conv0": _hwio(sd, "features.0"),
            "fires": [{name: _hwio(sd, f"features.{i}.{name}") for name in ("squeeze", "expand1x1", "expand3x3")}
                      for i in _SQUEEZE_FIRE_INDICES]}


def params_from_jax(tree: Any, device) -> Dict[str, Any]:
    """The JAX package's LPIPS params, same layout (HWIO convs), -> tensors on
    ``device``: ``{"vgg", "lin"}``, or ``{"net", "lin"}`` for AlexNet (a
    tuple of convs) and SqueezeNet ({"conv0", "fires"})."""
    name = "vgg" if "vgg" in tree else "net"
    return tree_to({name: tree[name], "lin": tree["lin"]}, device)


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


def build_lpips_params(generator: Optional[torch.Generator] = None, device="cuda",
                       vgg_path: Optional[str] = None, lin_path: Optional[str] = None, net: str = "vgg"):
    """Random LPIPS on backbone ``net`` ("vgg" | "alex" | "squeeze"), with the
    torchvision backbone (``vgg_path``, whichever net is selected) and/or the
    LPIPS lin heads (``{vgg,alex,squeeze}.pth``) loaded from local files where
    given.  On the card unless the caller asks for ``"cpu"``
    (``utils.device.resolve_device``)."""
    device = resolve_device(device)
    if net in ("vgg", "vgg16"):
        params, chans = init_lpips_params(generator, device), LPIPS_CHANNELS
        if vgg_path is not None:
            params["vgg"] = tree_to(vgg16_params_from_torch_state_dict(_load_state_dict(vgg_path)), device)
    elif net in ("alex", "squeeze"):
        init, convert, chans = {"alex": (init_alex_params, alexnet_params_from_torch_state_dict, ALEX_CHANNELS),
                                "squeeze": (init_squeeze_params, squeezenet_params_from_torch_state_dict,
                                            SQUEEZE_CHANNELS)}[net]
        params = {"net": init(generator, device), "lin": tree_to([np.ones(c) / c for c in chans], device)}
        if vgg_path is not None:
            params["net"] = tree_to(convert(_load_state_dict(vgg_path)), device)
    else:
        raise ValueError(f"unknown LPIPS net {net!r} (vgg | alex | squeeze)")
    if lin_path is not None:
        params["lin"] = tree_to(lin_weights_from_torch_state_dict(_load_state_dict(lin_path), len(chans)), device)
    return params


# ---------------------------------------------------------------------------
# The reference's other distance modes ("L2", "net", "SSIM")
# ---------------------------------------------------------------------------


def mse_per_sample(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """"L2" mode: the per-sample mean squared difference [B]."""
    return torch.mean((img0 - img1) ** 2, dim=(1, 2, 3))


def lpips_net_mode(params: Dict[str, Any], img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """"net" mode: squared differences of the normalized features summed over
    channels, averaged over space, summed over layers; no lin heads [B]."""
    total = None
    for a, b in zip(extract_features(params, img0), extract_features(params, img1)):
        d = torch.mean(torch.sum((a.float() - b.float()) ** 2, dim=-1), dim=(-2, -1))
        total = d if total is None else total + d
    return total


def dssim_per_sample(img0: torch.Tensor, img1: torch.Tensor, data_range: float = 2.0,
                     win: int = 7) -> torch.Tensor:
    """(1 - SSIM) / 2 on [-1, 1] NHWC images [B]: uniform ``win`` x ``win``
    window, VALID, constants from ``data_range``."""
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    c = img0.shape[-1]
    k = torch.full((c, 1, win, win), 1.0 / (win * win), dtype=img0.dtype, device=img0.device)

    def avg(v):
        return F.conv2d(v.permute(0, 3, 1, 2), k, groups=c)

    mu0, mu1 = avg(img0), avg(img1)
    s00 = avg(img0 * img0) - mu0 * mu0
    s11 = avg(img1 * img1) - mu1 * mu1
    s01 = avg(img0 * img1) - mu0 * mu1
    ssim_map = ((2 * mu0 * mu1 + c1) * (2 * s01 + c2)) / ((mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2))
    return (1.0 - torch.mean(ssim_map, dim=(1, 2, 3))) / 2.0
