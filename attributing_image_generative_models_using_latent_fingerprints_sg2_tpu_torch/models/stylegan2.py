"""StyleGAN2 generator (default path) in PyTorch, NHWC activations, HWIO weights.

Counterpart of the reference package's ``models/stylegan2.py`` with the
same parameter tree (nested dicts/lists of tensors, same names) and the same
algebra:

- modulated conv by the scaling identity: ``d_o * conv(x * s_i, scale * W)``
  with the demodulation ``d`` in closed form, so one shared-weight conv
  serves the whole batch;
- upsample layers store their weight pre-flipped spatially (the reference
  realises the stride-2 transposed conv as a dilated conv); here the weight
  is flipped back once, at use, for ``F.conv_transpose2d``;
- the post-transpose blur (pad (1, 1), gain 4) and the ToRGB skip upsample
  run through ``ops.upfirdn2d``, i.e. the ``blur4`` / ``upblur4`` CUDA
  kernels on a CUDA tensor.

Convolutions run on NCHW views of the NHWC tensors (``channels_last``
memory), so no layout copies are made around them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.fused_act import fused_leaky_relu
from ..ops.upfirdn2d import make_kernel, upfirdn2d, upsample2x_add
from ..utils.tree import tree_to

Params = Dict[str, Any]


def channel_map(channel_multiplier: int = 2, channel_max: int = 512) -> Dict[int, int]:
    """Per-resolution channel counts (ref ``src/model.py:418-428``), capped."""
    base = {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
        256: 64 * channel_multiplier, 512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }
    return {k: min(v, channel_max) for k, v in base.items()}


def num_noise_layers(size: int) -> int:
    return (int(math.log2(size)) - 2) * 2 + 1


def noise_shapes(size: int) -> List[Tuple[int, int, int, int]]:
    """NHWC noise map shapes [1, res, res, 1] per layer."""
    return [(1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1) for i in range(num_noise_layers(size))]


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def equal_linear(x: torch.Tensor, p: Params, lr_mul: float = 1.0, activation: bool = False):
    """Equalized-LR linear; ``p['weight']`` is [in, out]."""
    scale = (1.0 / math.sqrt(p["weight"].shape[0])) * lr_mul
    out = x @ (p["weight"] * scale)
    bias = p.get("bias")
    if activation:
        return fused_leaky_relu(out, None if bias is None else bias * lr_mul)
    if bias is not None:
        out = out + bias * lr_mul
    return out


def modulated_conv2d(
    x: torch.Tensor,
    w_latent: torch.Tensor,
    p: Params,
    *,
    upsample: bool = False,
    demodulate: bool = True,
    blur_kernel: Sequence[int] = (1, 3, 3, 1),
    eps: float = 1e-8,
) -> torch.Tensor:
    """Style-modulated conv of NHWC ``x``; ``p['weight']`` is [kh, kw, I, O]."""
    weight = p["weight"]
    kh, kw, cin, cout = weight.shape
    scale = 1.0 / math.sqrt(cin * kh * kw)
    style = equal_linear(w_latent, p["mod"])  # [B, I]
    xs = (x * style[:, None, None, :]).permute(0, 3, 1, 2)  # NCHW view, channels_last
    w = weight * scale
    if upsample:
        # stored pre-flipped: flip back for the transposed conv, [I, O, kh, kw]
        wt = torch.flip(w, (0, 1)).permute(2, 3, 0, 1)
        y = F.conv_transpose2d(xs, wt, stride=2).permute(0, 2, 3, 1)  # [B, 2H+1, 2W+1, O]
        factor = 2
        pp = (len(blur_kernel) - factor) - (kh - 1)
        pad0 = (pp + 1) // 2 + factor - 1
        pad1 = pp // 2 + 1
        y = upfirdn2d(y, make_kernel(blur_kernel) * (factor ** 2), pad=(pad0, pad1))
    else:
        y = F.conv2d(xs, w.permute(3, 2, 0, 1), padding=kh // 2).permute(0, 2, 3, 1)
    if demodulate:
        w2 = torch.sum(w * w, dim=(0, 1))  # [I, O]
        y = y * torch.rsqrt((style * style) @ w2 + eps)[:, None, None, :]
    return y


def styled_conv(x, w_latent, p: Params, noise: Optional[torch.Tensor], *, upsample=False,
                blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """Modulated conv + noise injection + fused bias/LeakyReLU."""
    y = modulated_conv2d(x, w_latent, p, upsample=upsample, blur_kernel=blur_kernel)
    if noise is not None:
        y = y + p["noise_weight"] * noise
    return fused_leaky_relu(y, p["act_bias"])


def to_rgb(x, w_latent, p: Params, skip: Optional[torch.Tensor] = None, *,
           blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """1x1 modulated conv (no demod) + bias + upsampled skip."""
    y = modulated_conv2d(x, w_latent, p, demodulate=False) + p["bias"]
    if skip is not None:
        y = upsample2x_add(y, skip, blur_kernel)
    return y


def mapping_network(params: Params, z: torch.Tensor, lr_mlp: float = 0.01) -> torch.Tensor:
    """z -> w: PixelNorm then n_mlp EqualLinear + fused LeakyReLU layers."""
    x = pixel_norm(z)
    for layer in params["style"]:
        x = equal_linear(x, layer, lr_mul=lr_mlp, activation=True)
    return x


def synthesis(params: Params, latent: torch.Tensor,
              noise: Optional[Sequence[Optional[torch.Tensor]]], *,
              blur_kernel: Sequence[int] = (1, 3, 3, 1)) -> torch.Tensor:
    """W+ latent [B, n_latent, style_dim] -> image [B, H, W, 3]."""
    if noise is None:
        noise = [None] * (1 + 2 * len(params["to_rgbs"]))
    const = params["input"]
    out = const.expand(latent.shape[0], *const.shape[1:])
    out = styled_conv(out, latent[:, 0], params["conv1"], noise[0], blur_kernel=blur_kernel)
    skip = to_rgb(out, latent[:, 1], params["to_rgb1"], None, blur_kernel=blur_kernel)
    i = 1
    for idx, p_rgb in enumerate(params["to_rgbs"]):
        out = styled_conv(out, latent[:, i], params["convs"][2 * idx], noise[1 + 2 * idx],
                          upsample=True, blur_kernel=blur_kernel)
        out = styled_conv(out, latent[:, i + 1], params["convs"][2 * idx + 1], noise[2 + 2 * idx],
                          blur_kernel=blur_kernel)
        skip = to_rgb(out, latent[:, i + 2], p_rgb, skip, blur_kernel=blur_kernel)
        i += 2
    return skip


def generate(params: Params, styles: Sequence[torch.Tensor], cfg: ModelConfig, *,
             noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
             input_is_latent: bool = False) -> torch.Tensor:
    """One style for every layer: ``styles[0]`` is z (mapped here) or, with
    ``input_is_latent``, w.  Style mixing and truncation are not ported."""
    if len(styles) != 1:
        raise NotImplementedError("style mixing is not yet ported")
    s = styles[0]
    if not input_is_latent:
        s = mapping_network(params, s, cfg.lr_mlp)
    latent = s[:, None, :].expand(-1, cfg.n_latent, -1)
    return synthesis(params, latent, noise, blur_kernel=cfg.blur_kernel)


def make_noise(size: int, generator: torch.Generator, device) -> List[torch.Tensor]:
    """Per-layer noise maps [1, res, res, 1], drawn from ``generator`` (CPU)."""
    return [torch.randn(s, generator=generator).to(device) for s in noise_shapes(size)]


def _init_equal_linear(g, in_dim, out_dim, lr_mul=1.0, bias_init=0.0) -> Params:
    return {"weight": torch.randn((in_dim, out_dim), generator=g) / lr_mul,
            "bias": torch.full((out_dim,), float(bias_init))}


def _init_mod_conv(g, in_ch, out_ch, k, style_dim) -> Params:
    return {"weight": torch.randn((k, k, in_ch, out_ch), generator=g),
            "mod": _init_equal_linear(g, style_dim, in_ch, bias_init=1.0)}


def _init_styled_conv(g, in_ch, out_ch, k, style_dim) -> Params:
    p = _init_mod_conv(g, in_ch, out_ch, k, style_dim)
    p["noise_weight"] = torch.zeros(())
    p["act_bias"] = torch.zeros((out_ch,))
    return p


def _init_to_rgb(g, in_ch, style_dim) -> Params:
    p = _init_mod_conv(g, in_ch, 3, 1, style_dim)
    p["bias"] = torch.zeros((3,))
    return p


def init_generator_params(cfg: ModelConfig, generator: torch.Generator, device) -> Params:
    """Random generator weights (the reference constructor's distributions),
    drawn on the CPU from ``generator`` and moved to ``device``."""
    g = generator
    chans = channel_map(cfg.channel_multiplier, cfg.channel_max)
    log_size = int(math.log2(cfg.img_size))
    params: Params = {
        "style": [_init_equal_linear(g, cfg.style_dim, cfg.style_dim, lr_mul=cfg.lr_mlp)
                  for _ in range(cfg.n_mlp)],
        "input": torch.randn((1, 4, 4, chans[4]), generator=g),
        "conv1": _init_styled_conv(g, chans[4], chans[4], 3, cfg.style_dim),
        "to_rgb1": _init_to_rgb(g, chans[4], cfg.style_dim),
    }
    convs, to_rgbs = [], []
    in_ch = chans[4]
    for i in range(3, log_size + 1):
        out_ch = chans[2 ** i]
        convs.append(_init_styled_conv(g, in_ch, out_ch, 3, cfg.style_dim))
        convs.append(_init_styled_conv(g, out_ch, out_ch, 3, cfg.style_dim))
        to_rgbs.append(_init_to_rgb(g, out_ch, cfg.style_dim))
        in_ch = out_ch
    params["convs"] = convs
    params["to_rgbs"] = to_rgbs
    params["noises"] = [torch.randn(s, generator=g) for s in noise_shapes(cfg.img_size)]
    return tree_to(params, device)
