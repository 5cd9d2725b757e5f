"""BigGAN-deep generator in PyTorch: NCHW activations, parameters in
``pytorch_pretrained_biggan``'s own layout.

Counterpart of the reference package's ``models/biggan.py`` (the reference's
second model family, ``BigGAN.from_pretrained('biggan-deep-256')``), with the
same architecture and algebra:

- cond = concat(z, class_embedding(one_hot))  [B, 256];
- gen_z: linear -> [B, 4, 4, 16*ch] (the package's view), then NCHW;
- deep residual blocks (1x1 -> 3x3 -> 3x3 -> 1x1, conditional batch norm and
  ReLU before each conv, nearest 2x upsample inside; the skip drops channels
  BEFORE it is upsampled), one self-attention block before layer
  ``attention_layer_position``;
- batch norm reads running statistics stored at ``n_stats`` truncations and
  blends the two around the truncation in use, with the package's inverted
  weights (``_interp_stats``);
- final batch norm -> ReLU -> 3x3 conv -> tanh; the image comes back NHWC,
  as every other image of the port.

Parameters: conv weights [O, I, kh, kw], linear weights [out, in], batch-norm
gains [C, cond_dim], spectral norm folded.  ``params_from_torch_state_dict``
reads a ``pytorch_pretrained_biggan`` state dict; ``params_from_jax`` carries
the JAX package's NHWC/HWIO tree across, so no other module sees that layout.
The convs are cuDNN's (``F.conv2d``) and the attention two ``torch.bmm``:
the reference package runs them outside any Pallas kernel too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.pool import maxpool2x2
from ..utils.tree import tree_to

Params = Dict[str, Any]

# biggan-deep-256 (pytorch_pretrained_biggan config.json): (up_sample, in_mult, out_mult) per layer
BIGGAN_DEEP_256_LAYERS = (
    (False, 16, 16), (True, 16, 16), (False, 16, 16), (True, 16, 8),
    (False, 8, 8), (True, 8, 8), (False, 8, 8), (True, 8, 4),
    (False, 4, 4),  # attention sits before this layer (position 8)
    (True, 4, 2), (False, 2, 2), (True, 2, 1),
)


@dataclasses.dataclass(frozen=True)
class BigGANConfig:
    z_dim: int = 128
    class_embed_dim: int = 128
    channel_width: int = 128
    num_classes: int = 1000
    output_dim: int = 256
    attention_layer_position: int = 8
    layers: Tuple[Tuple[bool, int, int], ...] = BIGGAN_DEEP_256_LAYERS
    n_stats: int = 51  # running statistics stored for truncations linspace(0, 1, n_stats)

    @property
    def cond_dim(self) -> int:
        return self.z_dim + self.class_embed_dim

    @property
    def img_size(self) -> int:
        """Side of the generated image: 4, doubled by every upsampling layer."""
        return 4 * 2 ** sum(1 for up, _, _ in self.layers if up)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _interp_stats(stats: torch.Tensor, truncation: float, n_stats: int) -> torch.Tensor:
    """Running statistics [n_stats, C] at ``truncation``, as
    pytorch_pretrained_biggan's BigGANBatchNorm computes them, quirk included:
    ``coef, start = modf(truncation / step)`` and
    ``stats[start] * coef + stats[start + 1] * (1 - coef)``, so the NEARER grid
    point gets the SMALLER weight.  The pretrained checkpoints were used with
    that formula, so it is reproduced, not fixed."""
    pos = truncation * (n_stats - 1)
    lo = int(math.floor(pos))
    frac = pos - lo
    if frac == 0.0 or lo >= n_stats - 1:
        return stats[min(lo, n_stats - 1)]
    return stats[lo] * frac + stats[lo + 1] * (1.0 - frac)


def _normalize(x: torch.Tensor, p: Params, truncation: float, n_stats: int, gain: torch.Tensor,
               bias: torch.Tensor, eps: float) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * gain + bias as one multiply-add over x;
    ``gain`` / ``bias`` are [B, C] or [C]."""
    mean = _interp_stats(p["running_means"], truncation, n_stats)
    inv = torch.rsqrt(_interp_stats(p["running_vars"], truncation, n_stats) + eps)
    scale = inv * gain
    shift = bias - mean * scale
    if scale.ndim == 1:
        scale, shift = scale[None], shift[None]
    return torch.addcmul(shift[:, :, None, None], x, scale[:, :, None, None])


def cond_batch_norm(x: torch.Tensor, cond: torch.Tensor, p: Params, truncation: float, n_stats: int,
                    eps: float = 1e-4) -> torch.Tensor:
    """Conditional batch norm of NCHW ``x``: running statistics at
    ``truncation``, gain ``1 + cond @ scale`` and bias ``cond @ offset``."""
    return _normalize(x, p, truncation, n_stats, 1.0 + F.linear(cond, p["scale_w"]),
                      F.linear(cond, p["offset_w"]), eps)


def batch_norm(x: torch.Tensor, p: Params, truncation: float, n_stats: int, eps: float = 1e-4) -> torch.Tensor:
    return _normalize(x, p, truncation, n_stats, p["weight"], p["bias"], eps)


def _conv(x: torch.Tensor, p: Params, padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, p["w"], p.get("b"), padding=padding)


def _upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def gen_block(x: torch.Tensor, cond: torch.Tensor, p: Params, *, up: bool, drop_to: Optional[int],
              truncation: float, n_stats: int) -> torch.Tensor:
    h = F.relu(cond_batch_norm(x, cond, p["bn0"], truncation, n_stats))
    h = _conv(h, p["conv0"])  # 1x1 reduce
    h = F.relu(cond_batch_norm(h, cond, p["bn1"], truncation, n_stats))
    if up:
        h = _upsample2x_nearest(h)
    h = _conv(h, p["conv1"], padding=1)
    h = F.relu(cond_batch_norm(h, cond, p["bn2"], truncation, n_stats))
    h = _conv(h, p["conv2"], padding=1)
    h = F.relu(cond_batch_norm(h, cond, p["bn3"], truncation, n_stats))
    h = _conv(h, p["conv3"])  # 1x1 expand
    skip = x if drop_to is None else x[:, :drop_to]
    if up:
        skip = _upsample2x_nearest(skip)
    return h + skip


def _pool_flat(y: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool of NCHW ``y`` (through the NHWC ``maxpool2x2``) -> [B, C, H*W/4]."""
    pooled = maxpool2x2(y.permute(0, 2, 3, 1))
    return pooled.permute(0, 3, 1, 2).reshape(y.shape[0], y.shape[1], -1)


def self_attention(x: torch.Tensor, p: Params) -> torch.Tensor:
    """SAGAN attention: theta / phi / g 1x1 convs, phi and g max-pooled 2x,
    softmax over the pooled positions in float32."""
    b, _, h, w = x.shape
    theta = _conv(x, p["theta"]).reshape(b, -1, h * w)  # [B, C/8, HW]
    phi = _pool_flat(_conv(x, p["phi"]))  # [B, C/8, HW/4]
    g = _pool_flat(_conv(x, p["g"]))  # [B, C/2, HW/4]
    attn = torch.softmax(torch.bmm(theta.transpose(1, 2), phi), dim=-1)  # [B, HW, HW/4]
    o = torch.bmm(g, attn.transpose(1, 2)).reshape(b, -1, h, w)
    return x + p["gamma"] * _conv(o, p["o_conv"])


# ---------------------------------------------------------------------------
# generator forward
# ---------------------------------------------------------------------------


def class_embedding(params: Params, class_onehot: torch.Tensor) -> torch.Tensor:
    """one-hot [B, num_classes] -> [B, embed_dim] (linear, no bias)."""
    return F.linear(class_onehot, params["embeddings"])


def generate(params: Params, z: torch.Tensor, class_onehot: torch.Tensor, truncation: float,
             cfg: BigGANConfig = BigGANConfig()) -> torch.Tensor:
    """z [B, z_dim] (truncated noise), one-hot [B, num_classes], truncation a
    host float -> image [B, H, W, 3] in [-1, 1] (the reference's
    ``g_ema(latent, class_vector, truncation)``).  A bf16 ``z`` (the solver's
    bf16 mode) is widened where it meets the float32 class embedding, as the
    reference's ``concatenate`` promotes it: from there the generator runs in
    the parameters' float32, so its image is float32."""
    cond = torch.cat([z, class_embedding(params, class_onehot)], dim=1)
    ch = cfg.channel_width
    h = F.linear(cond, params["gen_z"]["w"], params["gen_z"]["b"])
    h = h.reshape(z.shape[0], 4, 4, 16 * ch).permute(0, 3, 1, 2).contiguous()
    for i, (up, in_m, out_m) in enumerate(cfg.layers):
        if i == cfg.attention_layer_position:
            h = self_attention(h, params["attn"])
        h = gen_block(h, cond, params["layers"][i], up=up, drop_to=out_m * ch if in_m != out_m else None,
                      truncation=truncation, n_stats=cfg.n_stats)
    h = F.relu(batch_norm(h, params["bn_out"], truncation, cfg.n_stats))
    h = _conv(h, params["conv_out"], padding=1)
    return torch.tanh(h).permute(0, 2, 3, 1).contiguous()


def truncated_noise(batch: int, truncation: float, dim: int = 128,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """truncnorm(-2, 2) * truncation, [batch, dim] (the pip package's
    ``truncated_noise_sample``), by the inverse CDF of a uniform draw from
    ``generator`` (on the CPU)."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand((batch, dim), generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
    return (torch.clamp(z, -2.0, 2.0) * truncation).float()


# A compact label resolver in place of ``one_hot_from_names`` (the pip package
# resolves names through nltk's wordnet); integer class ids pass straight through.
IMAGENET_LABELS = {
    "golden retriever": 207,
    "labrador retriever": 208,
    "tabby": 281,
    "tabby cat": 281,
    "egyptian cat": 285,
    "samoyed": 258,
    "pembroke": 263,
    "corgi": 263,
    "siberian husky": 250,
    "beagle": 162,
    "pug": 254,
    "lion": 291,
    "tiger": 292,
    "zebra": 340,
    "giant panda": 388,
    "panda": 388,
    "goldfish": 1,
    "daisy": 985,
    "coffee mug": 504,
    "sports car": 817,
    "pizza": 963,
    "volcano": 980,
}


def one_hot_from_name(name: str, num_classes: int = 1000, batch_size: int = 1) -> np.ndarray:
    """Label (or an integer-valued string, a class id) -> one-hot [batch, num_classes]."""
    key = name.strip().lower()
    if key.lstrip("-").isdigit():
        idx = int(key)
    elif key in IMAGENET_LABELS:
        idx = IMAGENET_LABELS[key]
    else:
        raise ValueError(f"unknown label {name!r}; pass an integer class id or extend IMAGENET_LABELS")
    return one_hot_from_int(idx, num_classes, batch_size)


def one_hot_from_int(idx: int, num_classes: int = 1000, batch_size: int = 1) -> np.ndarray:
    if not 0 <= int(idx) < num_classes:
        raise ValueError(f"class id {idx} out of range for {num_classes} classes")
    out = np.zeros((batch_size, num_classes), np.float32)
    out[:, int(idx)] = 1.0
    return out


# ---------------------------------------------------------------------------
# init / conversion
# ---------------------------------------------------------------------------


def _init_bn(g, c, cond_dim, n_stats, conditional=True) -> Params:
    p = {"running_means": torch.zeros((n_stats, c)), "running_vars": torch.ones((n_stats, c))}
    if conditional:
        p["scale_w"] = torch.randn((c, cond_dim), generator=g) * 0.02
        p["offset_w"] = torch.randn((c, cond_dim), generator=g) * 0.02
    else:
        p["weight"] = torch.ones((c,))
        p["bias"] = torch.zeros((c,))
    return p


def _init_conv(g, cin, cout, k, bias=True, std=None) -> Params:
    std = math.sqrt(2.0 / (cin * k * k)) if std is None else std
    p = {"w": torch.randn((cout, cin, k, k), generator=g) * std}
    if bias:
        p["b"] = torch.zeros((cout,))
    return p


def init_biggan_params(cfg: BigGANConfig, generator: torch.Generator, device) -> Params:
    """Random weights (the reference package's distributions: He-normal convs,
    N(0, 0.02) linears and batch-norm gains, zero attention gamma), drawn on
    the CPU from ``generator`` and moved to ``device``."""
    g, ch = generator, cfg.channel_width
    params: Params = {
        "embeddings": torch.randn((cfg.class_embed_dim, cfg.num_classes), generator=g) * 0.02,
        "gen_z": {"w": torch.randn((4 * 4 * 16 * ch, cfg.cond_dim), generator=g) * 0.02,
                  "b": torch.zeros((4 * 4 * 16 * ch,))},
    }
    layers = []
    for _, in_m, out_m in cfg.layers:
        cin, cout = in_m * ch, out_m * ch
        mid = cin // 4
        layers.append({
            "bn0": _init_bn(g, cin, cfg.cond_dim, cfg.n_stats), "conv0": _init_conv(g, cin, mid, 1),
            "bn1": _init_bn(g, mid, cfg.cond_dim, cfg.n_stats), "conv1": _init_conv(g, mid, mid, 3),
            "bn2": _init_bn(g, mid, cfg.cond_dim, cfg.n_stats), "conv2": _init_conv(g, mid, mid, 3),
            "bn3": _init_bn(g, mid, cfg.cond_dim, cfg.n_stats), "conv3": _init_conv(g, mid, cout, 1),
        })
    params["layers"] = layers
    # channels at the attention position: the output of the layer before it
    pre = cfg.layers[: cfg.attention_layer_position]
    c = (pre[-1][2] if pre else 16) * ch
    params["attn"] = {
        "theta": _init_conv(g, c, c // 8, 1, bias=False, std=0.02),
        "phi": _init_conv(g, c, c // 8, 1, bias=False, std=0.02),
        "g": _init_conv(g, c, c // 2, 1, bias=False, std=0.02),
        "o_conv": _init_conv(g, c // 2, c, 1, bias=False, std=0.02),
        "gamma": torch.zeros(()),
    }
    out_ch = cfg.layers[-1][2] * ch
    params["bn_out"] = _init_bn(g, out_ch, cfg.cond_dim, cfg.n_stats, conditional=False)
    params["conv_out"] = _init_conv(g, out_ch, 3, 3)
    return tree_to(params, device)


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def params_from_torch_state_dict(sd: Mapping[str, Any], cfg: BigGANConfig = BigGANConfig(), *,
                                 device) -> Params:
    """A ``pytorch_pretrained_biggan`` state dict (tensors or arrays) -> the
    port's tree on ``device``.

    Spectral-norm parametrizations store ``weight_orig`` / ``weight_u``; the
    inference weight is weight_orig / sigma with sigma = u^T W v and
    v = W^T u / |W^T u|, folded here (in numpy, as the reference package
    does).  The package's ``conv_to_rgb`` has ``channel_width`` outputs of
    which the first 3 are the image: the rest are cut."""
    sd = {k: _np(v) for k, v in sd.items()}

    def eff_weight(prefix):
        if f"{prefix}.weight" in sd:
            return sd[f"{prefix}.weight"]
        w, u = sd[f"{prefix}.weight_orig"], sd[f"{prefix}.weight_u"]
        wm = w.reshape(w.shape[0], -1)
        v = wm.T @ u
        v = v / (np.linalg.norm(v) + 1e-12)
        return w / float(u @ (wm @ v))

    def layer(prefix):  # a linear or a conv: the package's layout is the port's
        p = {"w": eff_weight(prefix)}
        if f"{prefix}.bias" in sd:
            p["b"] = sd[f"{prefix}.bias"]
        return p

    def bn(prefix, conditional):
        p = {"running_means": sd[f"{prefix}.running_means"], "running_vars": sd[f"{prefix}.running_vars"]}
        if conditional:
            p["scale_w"] = eff_weight(f"{prefix}.scale")
            p["offset_w"] = eff_weight(f"{prefix}.offset")
        else:
            p["weight"], p["bias"] = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
        return p

    params: Params = {"embeddings": eff_weight("embeddings"), "gen_z": layer("generator.gen_z")}
    layers = []
    for i in range(len(cfg.layers) + 1):  # + 1: the attention block takes one slot
        base = f"generator.layers.{i}"
        if f"{base}.theta.weight_orig" in sd or f"{base}.theta.weight" in sd:
            params["attn"] = {**{k: layer(f"{base}.{k}") for k in ("theta", "phi", "g", "o_conv")},
                              "gamma": sd[f"{base}.gamma"].reshape(())}
            continue
        if f"{base}.conv_0.weight_orig" not in sd and f"{base}.conv_0.weight" not in sd:
            break
        layers.append({**{f"bn{j}": bn(f"{base}.bn_{j}", True) for j in range(4)},
                       **{f"conv{j}": layer(f"{base}.conv_{j}") for j in range(4)}})
    params["layers"] = layers
    params["bn_out"] = bn("generator.bn", False)
    rgb = layer("generator.conv_to_rgb")
    params["conv_out"] = {k: v[:3] for k, v in rgb.items()}
    return tree_to(params, device)


def params_from_jax(tree: Mapping[str, Any], device) -> Params:
    """The JAX package's BigGAN tree (numpy or JAX leaves; HWIO convs,
    [in, out] linears, [cond_dim, C] gains) -> the port's tree on ``device``."""

    def lin(p):
        return {"w": np.asarray(p["w"]).T, **({"b": p["b"]} if "b" in p else {})}

    def conv(p):
        return {"w": np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)), **({"b": p["b"]} if "b" in p else {})}

    def bn(p):
        out = {k: p[k] for k in ("running_means", "running_vars", "weight", "bias") if k in p}
        for k in ("scale_w", "offset_w"):
            if k in p:
                out[k] = np.asarray(p[k]).T
        return out

    params: Params = {
        "embeddings": np.asarray(tree["embeddings"]).T,
        "gen_z": lin(tree["gen_z"]),
        "layers": [{k: bn(v) if k.startswith("bn") else conv(v) for k, v in layer.items()}
                   for layer in tree["layers"]],
        "bn_out": bn(tree["bn_out"]),
        "conv_out": conv(tree["conv_out"]),
    }
    if "attn" in tree:
        a = tree["attn"]
        params["attn"] = {**{k: conv(a[k]) for k in ("theta", "phi", "g", "o_conv")}, "gamma": a["gamma"]}
    return tree_to(params, device)
