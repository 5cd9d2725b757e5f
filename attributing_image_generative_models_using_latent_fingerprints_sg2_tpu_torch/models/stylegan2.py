"""StyleGAN2 generator and discriminator in PyTorch, NHWC activations, HWIO weights.

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
  kernels on a CUDA tensor; ``synthesis`` sums its ToRGB outputs in one
  ``upsample2x_chain`` at the end (one launch each way in bf16);
- the discriminator (training only) blurs before each stride-2 conv, through
  the same ``blur4`` kernel at pads (2, 2) and (1, 1).

Convolutions run on NCHW views of the NHWC tensors (``channels_last``
memory), so no layout copies are made around them.

Mixed precision follows the reference: synthesis runs in the latent's dtype
(bfloat16 in the solver's bf16 mode).  The parameters stay float32 and are
cast to the activation dtype at use; the style is computed in float32 from
the bf16 latent and rounded for the modulation; the demodulation is computed
in float32 and rounded before its multiply; noise, biases and the skip
upsample run in the activation dtype.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..config import ModelConfig
from ..ops.fused_act import fused_leaky_relu
from ..ops.upfirdn2d import make_kernel, upfirdn2d, upsample2x_add, upsample2x_chain
from ..parallel.mesh import gather_channels, gather_rows, sum_grad_over_model
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
    w = p["weight"] * scale
    out = x.to(torch.promote_types(x.dtype, w.dtype)) @ w  # a bf16 x meets float32 weights in float32
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
    style = equal_linear(w_latent, p["mod"])  # [B, I], float32
    if "model_shard" in p:  # this rank's output channels: its part of the style's gradient
        style = sum_grad_over_model(style, p["model_shard"])
    xs = (x * style[:, None, None, :].to(x.dtype)).permute(0, 3, 1, 2)  # NCHW view, channels_last
    w = weight * scale
    wx = w.to(x.dtype)
    if upsample:
        # stored pre-flipped: flip back for the transposed conv, [I, O, kh, kw]
        wt = torch.flip(wx, (0, 1)).permute(2, 3, 0, 1)
        y = F.conv_transpose2d(xs, wt, stride=2).permute(0, 2, 3, 1)  # [B, 2H+1, 2W+1, O]
        factor = 2
        pp = (len(blur_kernel) - factor) - (kh - 1)
        pad0 = (pp + 1) // 2 + factor - 1
        pad1 = pp // 2 + 1
        y = upfirdn2d(y, make_kernel(blur_kernel) * (factor ** 2), pad=(pad0, pad1))
    else:
        y = F.conv2d(xs, wx.permute(3, 2, 0, 1), padding=kh // 2).permute(0, 2, 3, 1)
    if demodulate:
        w2 = torch.sum(w * w, dim=(0, 1))  # [I, O]
        y = y * torch.rsqrt((style * style) @ w2 + eps)[:, None, None, :].to(y.dtype)
    return y


def styled_conv(x, w_latent, p: Params, noise: Optional[torch.Tensor], *, upsample=False,
                blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """Modulated conv + noise injection + fused bias/LeakyReLU.  A conv
    sharded over a mesh's "model" axis (``parallel.mesh.shard_generator_params``)
    computes this rank's output channels and gathers them."""
    mesh = p.get("model_shard")
    noise_weight = p["noise_weight"]
    if mesh is not None:
        x, noise_weight = sum_grad_over_model(x, mesh), sum_grad_over_model(noise_weight, mesh)
    y = modulated_conv2d(x, w_latent, p, upsample=upsample, blur_kernel=blur_kernel)
    if noise is not None:
        y = y + noise_weight.to(y.dtype) * noise.to(y.dtype)
    y = fused_leaky_relu(y, p["act_bias"].to(y.dtype))
    return y if mesh is None else gather_channels(y, mesh)


def to_rgb(x, w_latent, p: Params, skip: Optional[torch.Tensor] = None, *,
           blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """1x1 modulated conv (no demod) + bias + upsampled skip."""
    y = modulated_conv2d(x, w_latent, p, demodulate=False)
    y = y + p["bias"].to(y.dtype)
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
              blur_kernel: Sequence[int] = (1, 3, 3, 1), remat: bool = False) -> torch.Tensor:
    """W+ latent [B, n_latent, style_dim] -> image [B, H, W, 3].

    ``remat``: gradient checkpointing.  Each upsample block (its two styled
    convs and its ToRGB) keeps only its inputs for the backward, which runs
    its forward again (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint``).  The skip chain that sums the ToRGB outputs stands
    outside the blocks and saves what it saves without."""
    if noise is None:
        noise = [None] * (1 + 2 * len(params["to_rgbs"]))
    const = params["input"]
    out = const.expand(latent.shape[0], *const.shape[1:]).to(latent.dtype)
    out = styled_conv(out, latent[:, 0], params["conv1"], noise[0], blur_kernel=blur_kernel)
    # the ToRGB outputs without their skips, summed up the resolutions at the end
    # in one op: nothing else reads an intermediate rgb
    ts = [to_rgb(out, latent[:, 1], params["to_rgb1"], None, blur_kernel=blur_kernel)]

    def block(out, lat_a, lat_b, lat_rgb, n1, n2, p_up, p_conv, p_rgb):
        out = styled_conv(out, lat_a, p_up, n1, upsample=True, blur_kernel=blur_kernel)
        out = styled_conv(out, lat_b, p_conv, n2, blur_kernel=blur_kernel)
        return out, to_rgb(out, lat_rgb, p_rgb, None, blur_kernel=blur_kernel)

    if remat and torch.is_grad_enabled():
        plain_block = block

        def block(*args):
            return torch.utils.checkpoint.checkpoint(plain_block, *args, use_reentrant=False)

    i = 1
    for idx, p_rgb in enumerate(params["to_rgbs"]):
        out, t = block(out, latent[:, i], latent[:, i + 1], latent[:, i + 2], noise[1 + 2 * idx], noise[2 + 2 * idx],
                       params["convs"][2 * idx], params["convs"][2 * idx + 1], p_rgb)
        ts.append(t)
        i += 2
    return upsample2x_chain(ts, blur_kernel)


def prepare_latent(params: Params, styles: Sequence[torch.Tensor], cfg: ModelConfig, *,
                   input_is_latent: bool = False, inject_index: Optional[int] = None,
                   truncation: float = 1.0,
                   truncation_latent: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Styles -> the W+ latent [B, n_latent, D] (ref ``src/model.py:511-548``).

    z inputs are mapped, then truncated toward ``truncation_latent`` when
    ``truncation < 1``: truncation applies to z inputs only, the reference's
    quirk.  One style [B, D] is broadcast to every layer; a [B, n_latent, D]
    one is taken as it is (w+).  Two styles mix: the first for the layers
    below ``inject_index`` (default n_latent - 2), the second above."""
    nl = cfg.n_latent
    if not input_is_latent:
        styles = [mapping_network(params, s, cfg.lr_mlp) for s in styles]
        if truncation < 1:
            if truncation_latent is None:
                raise ValueError("truncation < 1 needs truncation_latent")
            styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]
    if len(styles) < 2:
        s = styles[0]
        return s if s.ndim == 3 else s[:, None, :].expand(-1, nl, -1)
    if inject_index is None:
        inject_index = nl - 2
    return torch.cat([styles[0][:, None, :].expand(-1, inject_index, -1),
                      styles[1][:, None, :].expand(-1, nl - inject_index, -1)], dim=1)


def generate(params: Params, styles: Sequence[torch.Tensor], cfg: ModelConfig, *,
             noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
             input_is_latent: bool = False, inject_index: Optional[int] = None,
             truncation: float = 1.0,
             truncation_latent: Optional[torch.Tensor] = None, remat: bool = False) -> torch.Tensor:
    """Image [B, H, W, 3] from z or w styles (:func:`prepare_latent`: mixing,
    truncation, w+), with the given noise maps or none; ``remat`` as in
    :func:`synthesis`."""
    latent = prepare_latent(params, styles, cfg, input_is_latent=input_is_latent,
                            inject_index=inject_index, truncation=truncation,
                            truncation_latent=truncation_latent)
    return synthesis(params, latent, noise, blur_kernel=cfg.blur_kernel, remat=remat)


def mean_latent(params: Params, n: int, cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean w [1, D] over n z drawn from ``generator`` on the CPU, or over the
    given ``z`` [n, D] (ref ``src/model.py:488-494``)."""
    if z is None:
        z = torch.randn((n, cfg.style_dim), generator=generator)
    z = torch.as_tensor(z, dtype=torch.float32).to(params["input"].device)
    return mapping_network(params, z, cfg.lr_mlp).mean(dim=0, keepdim=True)


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


# ---------------------------------------------------------------------------
# Discriminator (ref ``src/model.py:575-699``)
# ---------------------------------------------------------------------------


def equal_conv2d(x: torch.Tensor, p: Params, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Equalized-LR conv of NHWC ``x``; ``p['weight']`` is [kh, kw, I, O]."""
    kh, kw, cin, _ = p["weight"].shape
    w = (p["weight"] * (1.0 / math.sqrt(cin * kh * kw))).permute(3, 2, 0, 1)
    out = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding).permute(0, 2, 3, 1)
    if p.get("bias") is not None:
        out = out + p["bias"]
    return out


def conv_layer(x: torch.Tensor, p: Params, *, downsample: bool = False, activate: bool = True,
               blur_kernel: Sequence[int] = (1, 3, 3, 1)) -> torch.Tensor:
    """[Blur, then a stride-2] equalized conv, then fused bias + LeakyReLU
    (``act_bias``) or the plain ``bias`` (ref ``src/model.py:575-617``).  The
    blur pads (2, 2) before a 3x3 conv and (1, 1) before a 1x1 one: the
    ``blur4`` kernel on a CUDA tensor, with odd outputs."""
    kh = p["weight"].shape[0]
    if downsample:
        pp = (len(blur_kernel) - 2) + (kh - 1)
        x = upfirdn2d(x, make_kernel(blur_kernel), pad=((pp + 1) // 2, pp // 2))
        out = equal_conv2d(x, {"weight": p["weight"]}, stride=2)
    else:
        out = equal_conv2d(x, {"weight": p["weight"]}, padding=kh // 2)
    if activate:
        return fused_leaky_relu(out, p.get("act_bias"))
    if p.get("bias") is not None:
        out = out + p["bias"]
    return out


def res_block(x: torch.Tensor, p: Params, blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """Ref ``src/model.py:620-638``."""
    out = conv_layer(x, p["conv1"], blur_kernel=blur_kernel)
    out = conv_layer(out, p["conv2"], downsample=True, blur_kernel=blur_kernel)
    skip = conv_layer(x, p["skip"], downsample=True, activate=False, blur_kernel=blur_kernel)
    return (out + skip) / math.sqrt(2.0)


def minibatch_stddev(x: torch.Tensor, group_size: int = 4, eps: float = 1e-8, mesh=None) -> torch.Tensor:
    """Append the group stddev feature map (ref ``src/model.py:684-692``):
    sample i is grouped with i + k * (B / group), group = min(B, group_size).

    With a ``mesh``, ``x`` is this rank's contiguous block of rows of a batch
    sharded over "data" (``stddev_gathers``): the rows are gathered over
    "data" (``parallel.mesh.gather_rows``), the map is the global batch's,
    and this rank keeps its rows of it."""
    b, h, w, c = x.shape
    full = x if mesh is None else gather_rows(x, mesh)
    group = min(full.shape[0], group_size)
    var = full.reshape(group, -1, h, w, c).var(dim=0, unbiased=False)
    std = torch.sqrt(var + eps).mean(dim=(1, 2, 3), keepdim=True)  # [B / group, 1, 1, 1]
    std = std.repeat(group, h, w, 1)
    if mesh is not None:
        std = std[mesh.index("data") * b:(mesh.index("data") + 1) * b]
    return torch.cat([x, std], dim=-1)


def stddev_gathers(batch: int, parts: int, group_size: int = 4) -> bool:
    """Whether a batch split into ``parts`` gathers its rows at the stddev
    layer: its B / group :func:`minibatch_stddev` group columns do not split
    whole over the parts."""
    group = min(batch, group_size)
    return batch % group != 0 or (batch // group) % parts != 0


def stddev_rows(batch: int, parts: int, index: int, group_size: int = 4) -> torch.Tensor:
    """The rows of part ``index`` of a batch split into ``parts``.

    Where the B / group columns j split over the parts, the part's share of
    them: rows j + k * (B / group), in the order that the part's own
    ``minibatch_stddev`` forms the groups the whole batch's forms, with no
    collective.  Otherwise (:func:`stddev_gathers`) the contiguous block
    [index * B / parts, (index + 1) * B / parts), whose discriminator gathers
    the rows at the stddev layer."""
    if batch % parts:
        raise ValueError(f"batch {batch} not divisible by {parts} parts")
    if stddev_gathers(batch, parts, group_size):
        per = batch // parts
        return torch.arange(index * per, (index + 1) * per)
    group = min(batch, group_size)
    cols = batch // group
    per = cols // parts
    return torch.tensor([k * cols + index * per + j for k in range(group) for j in range(per)])


def discriminator_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, stddev_mesh=None) -> torch.Tensor:
    """Logits [B, 1] of NHWC images [B, S, S, 3] (ref ``src/model.py:681-699``).
    The 4x4 map is flattened in H, W, C order, so ``final_linear0``'s [in, out]
    weight is the JAX package's (the reference flattens C, H, W).
    ``stddev_mesh``: ``x`` is this rank's contiguous rows of a batch sharded
    over its "data" axis, gathered at the stddev layer (:func:`minibatch_stddev`)."""
    out = conv_layer(x, params["from_rgb"])
    for rb in params["blocks"]:
        out = res_block(out, rb, cfg.blur_kernel)
    out = conv_layer(minibatch_stddev(out, mesh=stddev_mesh), params["final_conv"])
    out = out.reshape(out.shape[0], -1)
    out = equal_linear(out, params["final_linear0"], activation=True)
    return equal_linear(out, params["final_linear1"])


def init_discriminator_params(cfg: ModelConfig, generator: torch.Generator, device) -> Params:
    """Random discriminator weights (unit normal convs, zero biases), drawn on
    the CPU from ``generator`` and moved to ``device``."""
    g = generator
    chans = channel_map(cfg.channel_multiplier, cfg.channel_max)
    log_size = int(math.log2(cfg.img_size))

    def conv_p(cin, cout, k, activate=True):
        p = {"weight": torch.randn((k, k, cin, cout), generator=g)}
        if activate:
            p["act_bias"] = torch.zeros((cout,))
        return p

    params: Params = {"from_rgb": conv_p(3, chans[cfg.img_size], 1)}
    blocks = []
    in_ch = chans[cfg.img_size]
    for i in range(log_size, 2, -1):
        out_ch = chans[2 ** (i - 1)]
        blocks.append({"conv1": conv_p(in_ch, in_ch, 3), "conv2": conv_p(in_ch, out_ch, 3),
                       "skip": conv_p(in_ch, out_ch, 1, activate=False)})
        in_ch = out_ch
    params["blocks"] = blocks
    params["final_conv"] = conv_p(in_ch + 1, chans[4], 3)
    params["final_linear0"] = _init_equal_linear(g, chans[4] * 4 * 4, chans[4])
    params["final_linear1"] = _init_equal_linear(g, chans[4], 1)
    return tree_to(params, device)
