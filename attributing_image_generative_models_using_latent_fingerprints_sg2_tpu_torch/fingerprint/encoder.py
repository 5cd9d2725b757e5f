"""Amortized inversion encoder: a learned initializer for the attribution solve.

Counterpart of the reference package's ``fingerprint/encoder.py``.  A small
convolutional encoder ``E(x) -> (alpha_hat, key_logits)`` is trained on
pairs that the frozen generator renders for free (every step a fresh batch,
forward only), and every restart chain of the solve then starts in the
neighbourhood of its prediction instead of at a blind Latin-Hypercube draw.

Same layout, initialisation, loss and optimizer as the reference:

- stem 3x3 conv (no bias, "SAME" = pad (1, 1)), LeakyReLU(0.2) without gain;
  one stride-2 3x3 conv + bias + LeakyReLU per halving down to 4x4 (the
  reference's "SAME" padding on an even size pads (0, 1), not (1, 1)); mean
  over H and W; a dense trunk + LeakyReLU; two dense heads (whitened alpha,
  key logits), scaled by 0.1 at init.  Convs are OIHW here (HWIO there):
  ``encoder_params_from_jax`` carries the weights across.
- loss: MSE on ``alpha / sigma_rest`` + ``key_loss_weight`` x mean sigmoid
  binary cross-entropy on the key logits.
- optimizer: ``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``
  written out elementwise: clip ``g`` to ``g / |g| * max_norm`` unless
  ``|g| < max_norm``; Adam b1 0.9, b2 0.999, eps 1e-8 outside the square
  root, bias correction from count 1.

The render goes through a bfloat16 w+, as the reference's does: synthesis in
bf16 (the bf16 kernels on the card), the image widened to float32 and then
clipped; the encoder itself is float32.  Training is a plain loop, one step at
a time; the per-step losses stay on the device until the end.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..attacks import make_attack
from ..config import AttackConfig, ModelConfig
from ..models import stylegan2 as sg2
from ..utils.lhs import fold_in, lhs_alpha_init_batch
from .attribute import B1, B2, EPS  # optax's Adam defaults, as the solver's
from .embed import FingerprintBasis, embed, sample_alpha, sample_key_bits

Params = Dict[str, Any]
SLOPE = 0.2


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Hyperparameters of the inverter (the reference's fields and defaults).

    ``width``: stem channels, doubled per stride-2 stage up to ``max_width``.
    ``steps`` x ``batch``: the training budget; each step renders a fresh batch.
    ``grad_clip``: the global-norm clip (the reference measured the 256px
    encoder diverging without it).  ``jitter``: the restart cloud's radius in
    units of sigma_rest; ``logit_clip``: bound on the initial key logits.
    """

    width: int = 64
    max_width: int = 256
    head_dim: int = 256
    steps: int = 1500
    batch: int = 64
    lr: float = 2e-3
    grad_clip: float = 1.0
    key_loss_weight: float = 1.0
    jitter: float = 0.25
    logit_clip: float = 2.0


def _n_stages(img_size: int) -> int:
    """Stride-2 stages down to a 4x4 trunk."""
    n = 0
    while img_size > 4:
        img_size //= 2
        n += 1
    return n


def init_encoder(img_size: int, d_alpha: int, key_len: int, ecfg: EncoderConfig, generator: torch.Generator,
                 device) -> Params:
    """He-initialized parameters for ``apply_encoder``, drawn on the CPU from
    ``generator`` (stem, convs, trunk, alpha head, key head) and moved to ``device``."""
    def he(shape, fan_in):
        return torch.randn(shape, generator=generator) * (2.0 / fan_in) ** 0.5

    c = ecfg.width
    params: Params = {"stem": he((c, 3, 3, 3), 27), "convs": []}
    for _ in range(_n_stages(img_size)):
        c_out = min(c * 2, ecfg.max_width)
        params["convs"].append({"down": he((c_out, c, 3, 3), 9 * c), "b": torch.zeros((c_out,))})
        c = c_out
    h = ecfg.head_dim
    params.update(trunk=he((c, h), c), trunk_b=torch.zeros((h,)),
                  head_alpha=he((h, d_alpha), h) * 0.1, head_alpha_b=torch.zeros((d_alpha,)),
                  head_key=he((h, key_len), h) * 0.1, head_key_b=torch.zeros((key_len,)))
    leaves, spec = tree_flatten(params)
    return tree_unflatten([t.to(device) for t in leaves], spec)


def encoder_params_from_jax(params_np: Params, device) -> Params:
    """The reference package's encoder parameters (numpy or JAX arrays):
    conv weights HWIO -> OIHW, the dense weights and biases as they are."""
    def t(a, conv=False):
        x = torch.from_numpy(np.array(a, dtype=np.float32))
        return (x.permute(3, 2, 0, 1).contiguous() if conv else x).to(device)

    out: Params = {"stem": t(params_np["stem"], conv=True),
                   "convs": [{"down": t(l["down"], conv=True), "b": t(l["b"])} for l in params_np["convs"]]}
    for k in ("trunk", "trunk_b", "head_alpha", "head_alpha_b", "head_key", "head_key_b"):
        out[k] = t(params_np[k])
    return out


def apply_encoder(params: Params, imgs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """imgs [B, H, W, 3] in [-1, 1] -> (alpha_white [B, D-K], key_logits [B, K]).

    ``alpha_white`` is alpha / sigma_rest: every content axis is an equal
    share of the regression loss whatever the generator's spectrum."""
    # NCHW view of the NHWC batch, from standard strides: the stem conv sums in another
    # order for another layout (a batch of one from numpy's x[None] has batch stride 0)
    x = imgs.float().clone(memory_format=torch.contiguous_format).permute(0, 3, 1, 2)
    x = F.leaky_relu(F.conv2d(x, params["stem"], padding=1), SLOPE)
    for layer in params["convs"]:
        # "SAME" at stride 2 on an even size: no row/column before, one after
        x = F.leaky_relu(F.conv2d(F.pad(x, (0, 1, 0, 1)), layer["down"], layer["b"], stride=2), SLOPE)
    x = x.mean(dim=(2, 3))
    x = F.leaky_relu(x @ params["trunk"] + params["trunk_b"], SLOPE)
    return x @ params["head_alpha"] + params["head_alpha_b"], x @ params["head_key"] + params["head_key_b"]


def encoder_loss(params: Params, imgs: torch.Tensor, alpha: torch.Tensor, bits: torch.Tensor,
                 sigma_rest: torch.Tensor, key_loss_weight: float = 1.0) -> torch.Tensor:
    """MSE on the whitened alpha + key_loss_weight x mean sigmoid cross-entropy."""
    a_hat, k_logits = apply_encoder(params, imgs)
    l_alpha = torch.mean((a_hat - alpha / sigma_rest) ** 2)
    return l_alpha + key_loss_weight * F.binary_cross_entropy_with_logits(k_logits, bits)


def init_opt_state(params: Params) -> Dict[str, Any]:
    leaves, _ = tree_flatten(params)
    return {"count": 0, "mu": [torch.zeros_like(t) for t in leaves],
            "nu": [torch.zeros_like(t) for t in leaves]}


@torch.no_grad()
def clip_adam_update(leaves: List[torch.Tensor], grads: List[torch.Tensor], state: Dict[str, Any],
                     lr: float, max_norm: float) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
    """One ``optax.chain(clip_by_global_norm(max_norm), adam(lr))`` update of
    ``leaves``; the clip decides on the device (no host sync)."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < max_norm
    grads = [torch.where(keep, g, g / g_norm * max_norm) for g in grads]
    t = state["count"] + 1
    # the bias corrections in float32, as the reference computes them
    c1 = float(1.0 - torch.tensor(B1) ** t)
    c2 = float(1.0 - torch.tensor(B2) ** t)
    mu = [(1.0 - B1) * g + B1 * m for g, m in zip(grads, state["mu"])]
    nu = [(1.0 - B2) * (g * g) + B2 * v for g, v in zip(grads, state["nu"])]
    new = [p + (-lr) * ((m / c1) / (torch.sqrt(v / c2) + EPS)) for p, m, v in zip(leaves, mu, nu)]
    return new, {"count": t, "mu": mu, "nu": nu}


def train_step(params: Params, opt_state: Dict[str, Any], imgs: torch.Tensor, alpha: torch.Tensor,
               bits: torch.Tensor, sigma_rest: torch.Tensor, ecfg: EncoderConfig
               ) -> Tuple[Params, Dict[str, Any], torch.Tensor]:
    """Loss, gradient and one clipped Adam update on a given batch; returns
    (params, opt_state, pre-update loss) with the loss still on the device."""
    leaves, spec = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        loss = encoder_loss(tree_unflatten(leaves, spec), imgs, alpha, bits, sigma_rest, ecfg.key_loss_weight)
        grads = torch.autograd.grad(loss, leaves)
    new, opt_state = clip_adam_update(leaves, list(grads), opt_state, ecfg.lr, ecfg.grad_clip)
    return tree_unflatten(new, spec), opt_state, loss.detach()


@torch.no_grad()
def render(gen_params, basis: FingerprintBasis, noise, mcfg: ModelConfig, batch: int,
           generator: Optional[torch.Generator] = None, attack=None,
           alpha: Optional[torch.Tensor] = None, bits: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(imgs, alpha, bits): alpha ~ sigma_rest * N(0, 1) and bits ~ U{0, 1}
    from ``generator`` (or the given ones), the fingerprinted image with the
    pipeline's fixed noise rendered through a bf16 w+ and widened to float32,
    clamped to [-1, 1], then ``attack`` (an eval-mode ``attacks.make_attack``
    function, drawing from ``generator``) if given."""
    if alpha is None:
        alpha = sample_alpha(basis, batch, generator)
    if bits is None:
        bits = sample_key_bits(basis.v_cap.shape[0], batch, generator, basis.v_cap.device)
    _, wx = embed(basis, alpha, bits)
    wplus = wx[:, None, :].expand(-1, mcfg.n_latent, -1).to(torch.bfloat16)
    imgs = sg2.synthesis(gen_params, wplus, noise, blur_kernel=mcfg.blur_kernel)
    imgs = torch.clamp(imgs.float(), -1.0, 1.0)
    if attack is not None:
        imgs = attack(imgs, generator)
    return imgs, alpha, bits


def auto_batch(img_size: int) -> int:
    """The reference's default batch: 64 up to 128px, then 64 * 128^2 / img_size^2
    (16 at 256px), so a run of either package with the same flags trains on
    the same number of images.  It is kept for that parity of the default
    budget, not for memory: one H100 holds batch 64 at 256px."""
    if img_size <= 128:
        return 64
    return max(4, (64 * 128 * 128) // (img_size * img_size))


def train_encoder(gen_params, basis: FingerprintBasis, noise, *, mcfg: ModelConfig,
                  ecfg: EncoderConfig = EncoderConfig(), attack: str = "None",
                  attack_cfg: Optional[AttackConfig] = None, generator: Optional[torch.Generator] = None,
                  steps_override: Optional[int] = None) -> Tuple[Params, torch.Tensor]:
    """Train the inverter on frozen-generator pairs, pushed through the TRUE
    eval-mode channel of ``attack`` (the encoder never backprops through it,
    so it trains on what attacked targets look like).  Draws from
    ``generator`` (CPU): the initial weights, then each step's alpha, bits and
    attack noise.  Returns (params, loss curve [steps] on the CPU)."""
    if mcfg.model != "sg2":
        raise NotImplementedError(f"--init encoder renders through StyleGAN2's synthesis; "
                                  f"--model {mcfg.model} is not supported")
    steps = ecfg.steps if steps_override is None else int(steps_override)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    sigma_rest = basis.sigma_rest
    params = init_encoder(mcfg.img_size, sigma_rest.shape[0], basis.v_cap.shape[0], ecfg, g, sigma_rest.device)
    opt_state = init_opt_state(params)
    atk = None
    if attack != "None":
        atk = make_attack(dataclasses.replace(attack_cfg or AttackConfig(), augmentation=attack))
    curve = []
    for _ in range(steps):
        imgs, alpha, bits = render(gen_params, basis, noise, mcfg, ecfg.batch, g, atk)
        params, opt_state, loss = train_step(params, opt_state, imgs, alpha, bits, sigma_rest, ecfg)
        curve.append(loss)
    return params, (torch.stack(curve).cpu() if curve else torch.zeros((0,)))


def train_for_init(gen_params, basis: FingerprintBasis, noise, *, mcfg: ModelConfig, seed: int, steps: int,
                   jitter: float = 0.25, batch: int = 0, attack_cfg: Optional[AttackConfig] = None
                   ) -> Tuple[Params, torch.Tensor, EncoderConfig]:
    """The encoder of ``--init encoder`` (``cli.attribute``, ``cli.serve``,
    ``identification_point``): ``steps`` steps of ``batch`` images
    (0 = ``auto_batch``) on ``attack_cfg``'s channel (none if None), drawn
    from ``fold_in(seed, 7)`` so a resumed run trains the same encoder.
    Returns (params, loss curve, the config it trained with)."""
    ecfg = EncoderConfig(steps=steps, jitter=jitter, batch=batch or auto_batch(mcfg.img_size))
    attack = "None" if attack_cfg is None else attack_cfg.augmentation
    params, curve = train_encoder(gen_params, basis, noise, mcfg=mcfg, ecfg=ecfg, attack=attack,
                                  attack_cfg=attack_cfg, generator=fold_in(seed, 7))
    return params, curve, ecfg


@torch.no_grad()
def encoder_solve_init(params: Params, basis: FingerprintBasis, targets: torch.Tensor, n_starts: int,
                       generator: Optional[torch.Generator] = None, *, jitter: float = 0.25,
                       logit_clip: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha_init [S, n, D-K], key_init [S, n, K]) for ``attribute``: restart 0
    exactly at the prediction, restarts 1..n-1 a centered-LHS cloud of radius
    ``jitter * sigma_rest`` around it (drawn from ``generator``), the key
    logits clipped to +-``logit_clip`` and shared by every restart."""
    a_white, k_logits = apply_encoder(params, targets)
    alpha_hat = a_white * basis.sigma_rest
    s_ = targets.shape[0]
    cloud = jitter * lhs_alpha_init_batch(s_, n_starts, basis.sigma_rest, generator)
    cloud[:, 0] = 0.0
    key0 = torch.clamp(k_logits, -logit_clip, logit_clip)
    return alpha_hat[:, None, :] + cloud, key0[:, None, :].expand(s_, n_starts, key0.shape[-1])


@torch.no_grad()
def encoder_bit_accuracy(params: Params, targets: torch.Tensor, true_bits: torch.Tensor) -> torch.Tensor:
    """Zero-step decode: the encoder's own per-sample key accuracy [S]."""
    _, k_logits = apply_encoder(params, targets)
    return ((k_logits > 0).float() == true_bits.to(k_logits.device)).float().mean(dim=-1)
