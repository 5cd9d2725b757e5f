"""StyleGAN2's mapping and synthesis networks, the PCA of W and the
fingerprint embedding, in plain PyTorch (NCHW inside, NHWC at the edges).

The parameter tree is the one the port takes (HWIO conv weights, ``[in,
out]`` linear weights, rosinality's names and initial scales); an upsample
conv's stored weight is that of the dilated-conv form of the stride-2
transposed conv, so here the input is zero-stuffed, padded by 2 and
correlated with it.  Each styled conv modulates and demodulates its weight
per sample and runs as a grouped conv (rosinality's form), where the port
scales the activations and shares one weight.  The 4-tap FIRs are depthwise
convs.

The fingerprint (Yu et al., "Responsible disclosure of generative models
using scalable fingerprinting"): the PCA of w = mapping(z) over the seed's
latents, the key carried by the principal axes [shift, shift + key_len), the
content by the rest; wx = alpha U + mu + sd_moved (k * sigma_key) V.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .precision import FLOAT32, Precision

SQRT2 = math.sqrt(2.0)


def channel_map(channel_multiplier: int = 2, channel_max: int = 512) -> Dict[int, int]:
    base = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
            256: 64 * channel_multiplier, 512: 32 * channel_multiplier, 1024: 16 * channel_multiplier}
    return {k: min(v, channel_max) for k, v in base.items()}


def n_latent(img_size: int) -> int:
    return 2 * int(math.log2(img_size)) - 2


def noise_shapes(img_size: int) -> List[Tuple[int, int, int, int]]:
    return [(1, 1 << ((i + 5) // 2), 1 << ((i + 5) // 2), 1) for i in range((int(math.log2(img_size)) - 2) * 2 + 1)]


# ---------------------------------------------------------------------------
# Inputs drawn from the seed, on the device, in a few large calls
# ---------------------------------------------------------------------------


class _Draw:
    """Leaves carved from one normal draw: ``leaf(shape, scale, shift)`` is
    shift + scale * N(0, 1)."""

    def __init__(self):
        self.specs: List[Tuple[Tuple[int, ...], float, float, bool]] = []

    def leaf(self, shape, scale=1.0, shift=0.0, absolute=False) -> int:
        self.specs.append((tuple(shape), float(scale), float(shift), absolute))
        return len(self.specs) - 1

    def realize(self, gen: torch.Generator, device) -> List[torch.Tensor]:
        total = sum(math.prod(s) for s, _, _, _ in self.specs)
        buf = torch.randn(total, generator=gen, device=device)
        out, off = [], 0
        for shape, scale, shift, absolute in self.specs:
            n = math.prod(shape)
            t = buf[off:off + n].view(shape)
            if absolute:
                t.abs_()
            out.append(t.mul_(scale).add_(shift))
            off += n
        return out


def _gen_tree(cfg: dict, d: _Draw):
    """The generator tree with leaf indices in place of tensors."""
    ch = channel_map(cfg["channel_multiplier"], cfg["channel_max"])
    sd = cfg["style_dim"]

    def lin(i, o, lr_mul=1.0, bias_shift=0.0):
        return {"weight": d.leaf((i, o), 1.0 / lr_mul), "bias": d.leaf((o,), 0.1, bias_shift)}

    def mod_conv(cin, cout, k):
        return {"weight": d.leaf((k, k, cin, cout)), "mod": lin(sd, cin, bias_shift=1.0)}

    def styled(cin, cout):
        p = mod_conv(cin, cout, 3)
        p["noise_weight"] = d.leaf((), 0.1)
        p["act_bias"] = d.leaf((cout,), 0.1)
        return p

    def rgb(cin):
        p = mod_conv(cin, 3, 1)
        p["bias"] = d.leaf((3,), 0.1)
        return p

    tree = {"style": [lin(sd, sd, cfg["lr_mlp"]) for _ in range(cfg["n_mlp"])],
            "input": d.leaf((1, 4, 4, ch[4])), "conv1": styled(ch[4], ch[4]), "to_rgb1": rgb(ch[4])}
    convs, rgbs, cin = [], [], ch[4]
    for k in range(3, int(math.log2(cfg["img_size"])) + 1):
        cout = ch[1 << k]
        convs += [styled(cin, cout), styled(cout, cout)]
        rgbs.append(rgb(cout))
        cin = cout
    tree["convs"], tree["to_rgbs"] = convs, rgbs
    return tree


def _fill(tree, leaves):
    if isinstance(tree, dict):
        return {k: _fill(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fill(v, leaves) for v in tree]
    return leaves[tree]


def make_generator_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """Random generator weights, float32, in the port's tree: unit-normal
    conv and linear weights (scaled at use), modulation biases near 1, small
    noise weights and biases (trained StyleGAN2 has them non-zero)."""
    d = _Draw()
    tree = _gen_tree(cfg, d)
    return _fill(tree, d.realize(gen, device))


def make_noise(img_size: int, gen: torch.Generator, device) -> List[torch.Tensor]:
    """The fixed noise maps [1, r, r, 1] of every styled conv."""
    d = _Draw()
    idx = [d.leaf(s) for s in noise_shapes(img_size)]
    leaves = d.realize(gen, device)
    return [leaves[i] for i in idx]


# ---------------------------------------------------------------------------
# Mapping, PCA, basis, embedding
# ---------------------------------------------------------------------------


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2) * SQRT2


def mapping(params: dict, z: torch.Tensor, lr_mlp: float, prec: Precision = FLOAT32) -> torch.Tensor:
    """z [N, D] -> w [N, D]: pixel norm, then n_mlp equalized linear layers
    (weight * lr_mlp / sqrt(D), bias * lr_mlp) with leaky ReLU * sqrt(2)."""
    x = z * torch.rsqrt(torch.mean(z * z, dim=1, keepdim=True) + 1e-8)
    for layer in params["style"]:
        w = layer["weight"]
        x = _act(prec.mm(x, w * (lr_mlp / math.sqrt(w.shape[0]))) + layer["bias"] * lr_mlp)
    return x


def pca(samples: torch.Tensor, prec: Precision = FLOAT32) -> Dict[str, torch.Tensor]:
    """Components (rows, by descending variance, each signed so that its
    largest-magnitude coordinate is positive), standard deviations and mean
    of samples [N, D], from the eigenvectors of the sample covariance (n - 1)."""
    mean = samples.mean(dim=0)
    xc = samples - mean
    cov = prec.mm(xc.T, xc) / (samples.shape[0] - 1)
    evals, evecs = torch.linalg.eigh(cov)
    order = torch.argsort(evals, descending=True)
    pc = evecs[:, order].T
    lead = pc.gather(1, pc.abs().argmax(dim=1, keepdim=True))
    pc = pc * torch.sign(lead)
    return {"pc": pc.contiguous(), "sigma": evals[order].clamp(min=0).sqrt(), "mean": mean}


def basis(p: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, torch.Tensor]:
    """Key carrier V = pc[shift : shift + key_len], content carrier U = the
    other rows, their sigmas, and the +-3 sigma box of the content."""
    k0, k1 = cfg["shift"], cfg["shift"] + cfg["key_len"]
    sigma_rest = torch.cat([p["sigma"][:k0], p["sigma"][k1:]])
    return {"u": torch.cat([p["pc"][:k0], p["pc"][k1:]]), "v": p["pc"][k0:k1], "sigma_rest": sigma_rest,
            "sigma_key": torch.full((cfg["key_len"],), float(cfg["sigma"]), device=sigma_rest.device),
            "mean": p["mean"], "box": 3.0 * sigma_rest}


def build_basis(params: dict, z: torch.Tensor, cfg: dict, prec: Precision = FLOAT32) -> Dict[str, torch.Tensor]:
    return basis(pca(mapping(params, z, cfg["lr_mlp"], prec), prec), cfg)


def embed(b: Dict[str, torch.Tensor], alpha: torch.Tensor, k: torch.Tensor, cfg: dict,
          prec: Precision = FLOAT32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w0, wx) of content coefficients alpha [B, D-K] and key k [B, K]."""
    w0 = prec.mm(alpha, b["u"]) + b["mean"]
    return w0, w0 + float(cfg["sd_moved"]) * prec.mm(k * b["sigma_key"], b["v"])


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------


def _fir_kernel(c: int, gain: float, like: torch.Tensor) -> torch.Tensor:
    k = torch.tensor([1.0, 3.0, 3.0, 1.0], device=like.device)
    k2 = torch.outer(k, k)
    return (k2 / k2.sum() * gain).expand(c, 1, 4, 4)


def blur(x: torch.Tensor, pad: Tuple[int, int], gain: float, prec: Precision) -> torch.Tensor:
    """Depthwise 4x4 [1, 3, 3, 1] FIR (symmetric, so correlation is convolution)."""
    c = x.shape[1]
    return prec.conv2d(F.pad(x, (pad[0], pad[1], pad[0], pad[1])), _fir_kernel(c, gain, x), groups=c)


def upsample2x(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Zero-stuff by 2 (each sample followed by a zero), pad (2, 1), FIR with gain 4."""
    n, c, h, w = x.shape
    u = x.new_zeros(n, c, 2 * h, 2 * w)
    u[:, :, ::2, ::2] = x
    return blur(u, (2, 1), 4.0, prec)


def modulated_conv(x: torch.Tensor, w_lat: torch.Tensor, p: dict, demodulate: bool, upsample: bool,
                   prec: Precision) -> torch.Tensor:
    """Styled conv of NCHW x with a per-sample weight, as a grouped conv."""
    weight = p["weight"]  # [k, k, I, O]
    k, _, cin, cout = weight.shape
    b = x.shape[0]
    mod = p["mod"]
    style = prec.mm(w_lat, mod["weight"] / math.sqrt(mod["weight"].shape[0])) + mod["bias"]  # [B, I]
    w = weight.permute(3, 2, 0, 1) / math.sqrt(cin * k * k)  # [O, I, k, k]
    w = w[None] * style[:, None, :, None, None]
    if demodulate:
        w = w * torch.rsqrt(torch.sum(w * w, dim=(2, 3, 4), keepdim=True) + 1e-8)
    w = w.reshape(b * cout, cin, k, k)
    if upsample:
        n, c, h, wd = x.shape
        d = x.new_zeros(n, c, 2 * h - 1, 2 * wd - 1)
        d[:, :, ::2, ::2] = x
        d = F.pad(d, (k - 1,) * 4)
        y = prec.conv2d(d.reshape(1, b * cin, d.shape[2], d.shape[3]), w, groups=b)
        return blur(y.reshape(b, cout, y.shape[2], y.shape[3]), (1, 1), 4.0, prec)
    y = prec.conv2d(x.reshape(1, b * cin, x.shape[2], x.shape[3]), w, padding=k // 2, groups=b)
    return y.reshape(b, cout, y.shape[2], y.shape[3])


def styled_conv(x, w_lat, p, noise, upsample, prec):
    y = modulated_conv(x, w_lat, p, True, upsample, prec)
    y = y + p["noise_weight"] * noise.permute(0, 3, 1, 2)
    return _act(y + p["act_bias"][None, :, None, None])


def to_rgb(x, w_lat, p, prec):
    return modulated_conv(x, w_lat, p, False, False, prec) + p["bias"][None, :, None, None]


def synthesis(params: dict, w: torch.Tensor, noise: Sequence[torch.Tensor], prec: Precision = FLOAT32) -> torch.Tensor:
    """Image [B, H, W, 3] of latents w [B, D], the same w at every layer, with
    the fixed noise maps."""
    x = params["input"].permute(0, 3, 1, 2).expand(w.shape[0], -1, -1, -1)
    x = styled_conv(x, w, params["conv1"], noise[0], False, prec)
    rgb = to_rgb(x, w, params["to_rgb1"], prec)
    for i, p_rgb in enumerate(params["to_rgbs"]):
        x = styled_conv(x, w, params["convs"][2 * i], noise[1 + 2 * i], True, prec)
        x = styled_conv(x, w, params["convs"][2 * i + 1], noise[2 + 2 * i], False, prec)
        rgb = to_rgb(x, w, p_rgb, prec) + upsample2x(rgb, prec)
    return rgb.permute(0, 2, 3, 1)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8: clamp, +1, * 255 / 2, round half to even."""
    return torch.round((img.float().clamp(-1.0, 1.0) + 1.0) * (255.0 / 2.0)).to(torch.uint8)
