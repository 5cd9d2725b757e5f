"""Gradient-based attribution: invert images back to (alpha, key).

Counterpart of the reference package's ``fingerprint/attribute.py``:
``attribute`` with its solver attack (attack-aware solving), coarse-to-fine
anneal, successive halving over restarts and key polish, ``polish_key_bits``
and ``attribute_chunked``.  Per target and per Latin-Hypercube restart it solves

    min_{alpha, key}  loss(target, G(w(alpha, sigmoid(key)))) + 0.1 * bound(alpha)

with all S samples x n restarts flattened into one generator batch: Adam is
elementwise and the loss is per element, so one update over [S, n, ...]
tensors is S*n independent chains.  Target LPIPS features are extracted
once, normalized, and held constant.

The generator is StyleGAN2 (w broadcast to every style slot, the fixed noise)
or, with ``mcfg.model == "biggan"``, BigGAN-deep (its class one-hot and
truncation; ``biggan_cfg`` / ``class_onehot`` / ``truncation``).

Adam is written out: b1=0.9, b2=0.999, eps=1e-8 outside the sqrt, bias
correction by count+1, rate lr * exp(-decay * (count+1)) with count from 0
(the reference's optax chain).  The reported per-restart loss is the last
step's PRE-update loss; the returned alpha/key are the POST-update state.

``dtype`` ("float32" | "bfloat16") is the compute dtype of synthesis and
LPIPS, the reference's mixed precision: the latents, sigmoid(key), the
embedding and wx stay float32; w+ (StyleGAN2) or wx (BigGAN) is rounded to
the compute dtype; the solver attack runs on float32 and is rounded back; the
mse residual is float32; the targets' LPIPS features come from the targets in
the compute dtype (mse targets stay float32); Adam's state, the gradients and
the loss sum are float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..attacks import make_solver_attack
from ..attacks.blur import separable_blur
from ..config import AttackConfig, AttributionConfig, ModelConfig
from ..losses import lpips as lpips_mod
from ..models import biggan as bg
from ..models import stylegan2 as sg2
from ..utils.lhs import fold_in, lhs_alpha_init_batch
from .embed import FingerprintBasis, alpha_bound_penalty, bit_accuracy, content_latent, key_offset

B1, B2, EPS = 0.9, 0.999, 1e-8
CTF_TAPS = 9  # blur support of the coarse-to-fine anneal; sigma shrinks inside it
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype: str) -> torch.dtype:
    """The torch dtype of a solver ``dtype`` name ("float32" | "bfloat16")."""
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"dtype must be one of {sorted(COMPUTE_DTYPES)}, got {dtype!r}")
    return COMPUTE_DTYPES[dtype]


@dataclasses.dataclass
class AttributionResult:
    alpha: torch.Tensor  # [S, D-K] best restart's content coefficients
    key_logits: torch.Tensor  # [S, K]
    key_bits: torch.Tensor  # [S, K] in {0, 1}
    loss: torch.Tensor  # [S] best final (pre-update) loss
    losses_all: torch.Tensor  # [S, n] final loss of every restart (survivors only under pruning)
    best_start: torch.Tensor  # [S] argmin restart index (the ORIGINAL index under pruning)
    # [S, n, K] key logits of every restart (survivors only under pruning): the
    # POST-update state, one step after losses_all's PRE-update losses; left as
    # the solve ended by polish.  Funds model_attribution.restart_coherence.
    key_logits_all: Optional[torch.Tensor] = None


def ctf_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of x [..., H, W, C] in a fixed 9-tap window with
    zero padding; sigma is floored at 1e-3, where the kernel is the identity tap."""
    off = torch.arange(-(CTF_TAPS // 2), CTF_TAPS // 2 + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (off / max(float(sigma), 1e-3)) ** 2)
    return separable_blur(x.reshape((-1,) + tuple(x.shape[-3:])), k / k.sum(), "constant").reshape(x.shape)


def ctf_sigmas(acfg: AttributionConfig, steps: int) -> List[Optional[float]]:
    """The blur sigma of every step: a linear anneal from ``ctf_sigma0`` to 0 over
    the first ``ctf_frac`` of the schedule; None (no blur) when the anneal is off."""
    if not acfg.coarse_to_fine:
        return [None] * steps
    if acfg.loss != "mse":
        raise ValueError(
            "--coarse_to_fine requires --loss mse: the anneal blurs the residual inside the mse "
            f"objective and has no effect on perceptual losses (got loss={acfg.loss!r})")
    anneal = max(1, int(acfg.ctf_frac * steps))
    return [acfg.ctf_sigma0 * max(0.0, 1.0 - i / anneal) for i in range(steps)]


def make_attribution_step(
    gen_params, lpips_params, basis: FingerprintBasis, noise, mcfg: ModelConfig,
    acfg: AttributionConfig, target_feats, targets, attack_cfg: Optional[AttackConfig] = None,
    biggan_cfg: Optional[bg.BigGANConfig] = None, class_onehot: Optional[torch.Tensor] = None,
    truncation: float = 0.4, dtype: str = "float32", remat: bool = False, remat_lpips: bool = False,
) -> Tuple[Callable, Callable]:
    """(step, per_elem_loss) for [S, n] restarts, synthesis and LPIPS in ``dtype``.

    ``target_feats``: list of [S, 1, h, w, c] normalized features
    (perceptual) or None; ``targets``: [S, 1, H, W, 3] images (mse) or None.
    ``step(state, ctf_sigma=None) -> (state, per)`` does one loss + grad +
    Adam update on
    ``state = {"alpha", "key", "m_alpha", "v_alpha", "m_key", "v_key", "count"}``
    and returns the pre-update per-element loss [S, n].  With
    ``acfg.solver_attack != "None"`` the estimate goes through that attack's
    channel model before the loss (``attack_cfg`` gives the strengths); with
    ``ctf_sigma`` (mse) estimate and target are blurred by it.  BigGAN
    (``mcfg.model == "biggan"``) renders with ``class_onehot`` [1, classes]
    at the host float ``truncation``.  ``remat`` gradient-checkpoints
    StyleGAN2's synthesis blocks (``models.stylegan2.synthesis``),
    ``remat_lpips`` LPIPS's feature extraction as a whole: the backward runs
    their forward again instead of keeping its activations (the same loss and
    gradients, less memory, more time).
    """
    nl = mcfg.n_latent
    cdtype = compute_dtype(dtype)
    if acfg.loss == "perceptual":
        lpips_params = lpips_mod.backbone_in(lpips_params, cdtype)
    solver_attack = None
    if acfg.solver_attack != "None":
        solver_attack = make_solver_attack(attack_cfg if attack_cfg is not None else AttackConfig(),
                                           acfg.solver_attack)

    def per_elem_loss(alpha: torch.Tensor, key_logits: torch.Tensor,
                      ctf_sigma: Optional[float] = None) -> torch.Tensor:
        s_, n_ = alpha.shape[0], alpha.shape[1]
        k = torch.sigmoid(key_logits)
        wx = content_latent(basis, alpha.reshape(s_ * n_, -1)) + key_offset(basis, k.reshape(s_ * n_, -1))
        if mcfg.model == "biggan":
            imgs = bg.generate(gen_params, wx.to(cdtype), class_onehot.expand(wx.shape[0], -1), truncation,
                               biggan_cfg)
        else:
            wplus = wx[:, None, :].expand(-1, nl, -1).to(cdtype)
            imgs = sg2.synthesis(gen_params, wplus, noise, blur_kernel=mcfg.blur_kernel, remat=remat)
        if solver_attack is not None:
            # the channel model in float32 (JPEG's DCT and quantisation lose too much in bf16)
            imgs = solver_attack(imgs.float()).to(imgs.dtype)
        if acfg.loss == "perceptual":
            if remat_lpips and torch.is_grad_enabled():
                feats = torch.utils.checkpoint.checkpoint(lpips_mod.extract_raw_features, lpips_params, imgs,
                                                          use_reentrant=False)
            else:
                feats = lpips_mod.extract_raw_features(lpips_params, imgs)
            feats = [f.reshape((s_, n_) + tuple(f.shape[1:])) for f in feats]
            per = lpips_mod.distance_from_raw_features(lpips_params, feats, target_feats)
        else:
            est, tgt = imgs.float().reshape((s_, n_) + tuple(imgs.shape[1:])), targets
            if ctf_sigma is not None:
                est, tgt = ctf_blur(est, ctf_sigma), ctf_blur(tgt, ctf_sigma)
            per = torch.mean((est - tgt) ** 2, dim=(-3, -2, -1))
        return per + acfg.bound_weight * alpha_bound_penalty(basis, alpha)

    def step(state: Dict[str, Any], ctf_sigma: Optional[float] = None) -> Tuple[Dict[str, Any], torch.Tensor]:
        alpha = state["alpha"].detach().requires_grad_(True)
        key = state["key"].detach().requires_grad_(True)
        with torch.enable_grad():
            per = per_elem_loss(alpha, key, ctf_sigma)
            g_alpha, g_key = torch.autograd.grad(per.sum(), [alpha, key])
        return adam_update(state, {"alpha": g_alpha, "key": g_key}, acfg), per.detach()

    return step, per_elem_loss


@torch.no_grad()
def adam_update(state: Dict[str, Any], grads: Dict[str, torch.Tensor],
                acfg: AttributionConfig) -> Dict[str, Any]:
    """One Adam step (the reference's optax chain, written out) on
    ``state["alpha"]`` and ``state["key"]``; returns the new state."""
    t = state["count"] + 1
    lr = acfg.lr * math.exp(-acfg.lr_decay * t)
    new = {"count": t}
    for name, g in grads.items():
        m = state["m_" + name] * B1 + (1.0 - B1) * g
        v = state["v_" + name] * B2 + (1.0 - B2) * g * g
        m_hat = m / (1.0 - B1 ** t)
        v_hat = v / (1.0 - B2 ** t)
        new[name] = state[name].detach() - lr * (m_hat / (torch.sqrt(v_hat) + EPS))
        new["m_" + name], new["v_" + name] = m, v
    return new


def init_state(alpha0: torch.Tensor, key0: torch.Tensor) -> Dict[str, Any]:
    z = torch.zeros_like
    return {"alpha": alpha0, "key": key0, "m_alpha": z(alpha0), "v_alpha": z(alpha0),
            "m_key": z(key0), "v_key": z(key0), "count": 0}


def prune_warm_steps(steps: int, prune_frac: float) -> int:
    """Warm-phase length of the successive-halving schedule: at least 1 step,
    at most steps - 1."""
    return min(max(1, int(prune_frac * steps)), steps - 1)


def executed_chain_steps(steps: int, n_starts: int, prune_starts: int, prune_frac: float) -> int:
    """Chain-steps executed per sample, under ``attribute``'s own pruning guard
    (pruning is skipped when steps < 2 or prune_starts is not in (0, n_starts))."""
    if prune_starts and 0 < prune_starts < n_starts and steps >= 2:
        warm = prune_warm_steps(steps, prune_frac)
        return warm * n_starts + (steps - warm) * prune_starts
    return steps * n_starts


def gather_restarts(state: Dict[str, Any], start_map: torch.Tensor) -> Dict[str, Any]:
    """Keep restarts ``start_map`` [S, k] of every per-restart tensor of the
    solver state (parameters and all four Adam moments); the step count stays."""
    def take(x):
        if not torch.is_tensor(x):
            return x
        idx = start_map.reshape(start_map.shape + (1,) * (x.ndim - 2)).expand(-1, -1, *x.shape[2:])
        return torch.gather(x, 1, idx)

    return {name: take(x) for name, x in state.items()}


@torch.no_grad()
def _polish_loop(per_elem: Callable, alpha: torch.Tensor, key_logits: torch.Tensor, sweeps: int,
                 margin: float = 0.05) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy coordinate descent over key-logit SIGNS at fixed alpha [S, D-K].

    A candidate flip negates one logit (sigmoid(-l) = 1 - sigmoid(l): the
    decoded bit mirrors, its confidence stays), so the search starts at the
    converged loss.  A flip is kept only when it beats the incumbent loss by
    the relative ``margin``.  Monotone; costs sweeps * key_len forwards of
    batch S.  Returns (key_logits [S, K], loss [S])."""
    def loss_of(logits):
        return per_elem(alpha[:, None], logits[:, None])[:, 0]

    cur = loss_of(key_logits)
    for j in list(range(key_logits.shape[1])) * sweeps:
        flipped = key_logits.clone()
        flipped[:, j] = -flipped[:, j]
        lf = loss_of(flipped)
        better = lf < cur * (1.0 - margin)
        key_logits = torch.where(better[:, None], flipped, key_logits)
        cur = torch.where(better, lf, cur)
    return key_logits, cur


def _targets_for_loss(lpips_params, targets: torch.Tensor, acfg: AttributionConfig, dtype: str = "float32"):
    """(target_feats, tgt): the normalized features [S, 1, h, w, c] of the
    targets in ``dtype`` (perceptual) or the float32 images [S, 1, H, W, 3]
    (mse), the other None."""
    with torch.no_grad():
        if acfg.loss == "perceptual":
            feats = lpips_mod.extract_features(lpips_params, targets.to(compute_dtype(dtype)))
            return [f[:, None] for f in feats], None
        if acfg.loss == "mse":
            return None, targets.float()[:, None]
    raise ValueError(f"loss must be 'perceptual' or 'mse', got {acfg.loss!r}")


def polish_key_bits(
    gen_params, lpips_params, basis: FingerprintBasis, noise,
    targets: torch.Tensor,  # [S, H, W, 3]
    alpha: torch.Tensor,  # [S, D-K] fixed content coefficients
    key_logits: torch.Tensor,  # [S, K] logits (pass (2b-1)*scale for hard bits)
    *,
    mcfg: ModelConfig,
    acfg: AttributionConfig,
    sweeps: int = 2,
    attack_cfg: Optional[AttackConfig] = None,
    biggan_cfg: Optional[bg.BigGANConfig] = None,
    class_onehot: Optional[torch.Tensor] = None,
    truncation: float = 0.4,
    dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polish an existing attribution against its targets (see
    :func:`_polish_loop`) with synthesis and LPIPS in ``dtype``; decode with
    ``round(sigmoid(key_logits))``."""
    target_feats, tgt = _targets_for_loss(lpips_params, targets, acfg, dtype)
    _, per_elem = make_attribution_step(gen_params, lpips_params, basis, noise, mcfg, acfg,
                                        target_feats, tgt, attack_cfg, biggan_cfg, class_onehot, truncation,
                                        dtype)
    return _polish_loop(per_elem, alpha, key_logits, sweeps, margin=acfg.polish_margin)


def attribute(
    gen_params, lpips_params, basis: FingerprintBasis, noise,
    targets: torch.Tensor,  # [S, H, W, 3] in [-1, 1]
    *,
    mcfg: ModelConfig,
    acfg: AttributionConfig,
    generator: Optional[torch.Generator] = None,
    n_starts: Optional[int] = None,
    attack_cfg: Optional[AttackConfig] = None,
    alpha_init: Optional[torch.Tensor] = None,
    key_init: Optional[torch.Tensor] = None,
    biggan_cfg: Optional[bg.BigGANConfig] = None,
    class_onehot: Optional[torch.Tensor] = None,
    truncation: float = 0.4,
    dtype: str = "float32",
    remat: bool = False,
    remat_lpips: bool = False,
) -> AttributionResult:
    """Solve attribution for a batch of targets, all samples x restarts at once.

    ``alpha_init`` / ``key_init`` ([S, n, D-K] / [S, n, K]) replace the
    centered-LHS / zero restart initialization (drawn from ``generator``);
    ``n_starts`` overrides ``acfg.n_starts`` (a restart chunk).  BigGAN
    pipelines pass ``pipeline.solver_kwargs(pipe)``.  ``dtype`` is the compute
    dtype of synthesis and LPIPS (module docstring); ``remat`` /
    ``remat_lpips`` gradient-checkpoint them (:func:`make_attribution_step`)."""
    n_starts = acfg.n_starts if n_starts is None else n_starts
    steps = acfg.steps
    device = targets.device
    s_ = targets.shape[0]
    if alpha_init is None:
        alpha_init = lhs_alpha_init_batch(s_, n_starts, basis.sigma_rest, generator)
    if key_init is None:
        key_init = torch.zeros((s_, n_starts, basis.v_cap.shape[0]))
    alpha0 = torch.as_tensor(alpha_init, dtype=torch.float32).to(device)
    key0 = torch.as_tensor(key_init, dtype=torch.float32).to(device)

    target_feats, tgt = _targets_for_loss(lpips_params, targets, acfg, dtype)
    step, per_elem = make_attribution_step(gen_params, lpips_params, basis, noise, mcfg, acfg,
                                           target_feats, tgt, attack_cfg, biggan_cfg, class_onehot, truncation,
                                           dtype, remat=remat, remat_lpips=remat_lpips)
    sigmas = ctf_sigmas(acfg, steps)
    state = init_state(alpha0, key0)
    per = None
    k_keep = acfg.prune_starts
    start_map = None  # pruned index -> original restart index
    warm = 0
    if k_keep and 0 < k_keep < n_starts and steps >= 2:
        # Successive halving: every restart runs the warm phase, then the k best per
        # sample (by the warm phase's last pre-update loss; ties keep the lower index)
        # run the rest with their Adam moments; the step count, so the rate, goes on.
        warm = prune_warm_steps(steps, acfg.prune_frac)
        for i in range(warm):
            state, per = step(state, sigmas[i])
        start_map = torch.argsort(per, dim=1, stable=True)[:, :k_keep]
        state = gather_restarts(state, start_map)
    for i in range(warm, steps):
        state, per = step(state, sigmas[i])
    final_per = per  # [S, n or k] pre-update loss of the last step
    best = torch.argmin(final_per, dim=1)
    rows = torch.arange(s_, device=device)
    alpha_best, key_best, loss_best = state["alpha"][rows, best], state["key"][rows, best], final_per[rows, best]
    if acfg.polish_sweeps > 0:
        key_best, loss_best = _polish_loop(per_elem, alpha_best, key_best, acfg.polish_sweeps,
                                           margin=acfg.polish_margin)
    if start_map is not None:
        best = start_map[rows, best]
    return AttributionResult(
        alpha=alpha_best,
        key_logits=key_best,
        key_bits=torch.round(torch.sigmoid(key_best)),
        loss=loss_best,
        losses_all=final_per,
        best_start=best,
        key_logits_all=state["key"],
    )


def attribute_chunked(
    gen_params, lpips_params, basis: FingerprintBasis, noise, targets: torch.Tensor, *,
    mcfg: ModelConfig,
    acfg: AttributionConfig,
    generator: Optional[torch.Generator] = None,
    chunk_starts: int = 0,
    solve_fn: Optional[Callable] = None,
    **kwargs,
) -> AttributionResult:
    """Solve with the restart axis split into chunks of ``chunk_starts`` (0 = all
    at once): bounds peak memory at large n at no algorithmic cost.  Restarts
    are independent, so the per-sample minimum merges across chunks exactly.
    The chunk that starts at restart ``c0`` draws from ``fold_in(generator, c0)``;
    ``alpha_init`` / ``key_init`` ([S, n, ...]) follow their chunk.

    ``solve_fn(targets, generator, *, n_starts=None, **kwargs)`` replaces the
    single-device solver --- e.g. a wrapper around
    ``parallel.solver.attribute_on_mesh`` --- so restart chunking composes
    with any execution backend."""
    if solve_fn is None:
        def solve_fn(tgt, gen, **kw):
            return attribute(gen_params, lpips_params, basis, noise, tgt, mcfg=mcfg, acfg=acfg, generator=gen, **kw)

    n_total = acfg.n_starts
    if chunk_starts <= 0 or chunk_starts >= n_total:
        return solve_fn(targets, generator, **kwargs)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    best: Optional[AttributionResult] = None
    for c0 in range(0, n_total, chunk_starts):
        n_c = min(chunk_starts, n_total - c0)
        kw_c = dict(kwargs)
        for name in ("alpha_init", "key_init"):
            if kw_c.get(name) is not None:
                kw_c[name] = kw_c[name][:, c0:c0 + n_c]
        res = solve_fn(targets, fold_in(generator, c0), n_starts=n_c, **kw_c)
        if best is None:
            best = res
            continue
        take_new = res.loss < best.loss  # [S]; c0 restarts have been merged so far
        best = AttributionResult(
            alpha=torch.where(take_new[:, None], res.alpha, best.alpha),
            key_logits=torch.where(take_new[:, None], res.key_logits, best.key_logits),
            key_bits=torch.where(take_new[:, None], res.key_bits, best.key_bits),
            loss=torch.minimum(res.loss, best.loss),
            losses_all=torch.cat([best.losses_all, res.losses_all], dim=1),
            best_start=torch.where(take_new, res.best_start + c0, best.best_start),
            key_logits_all=torch.cat([best.key_logits_all, res.key_logits_all], dim=1),
        )
    return best


def evaluate_attribution(result: AttributionResult, true_keys: torch.Tensor, *,
                         basis: Optional[FingerprintBasis] = None,
                         true_w0: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Per-sample bit accuracy and exact-match attribution accuracy.  With
    ``basis`` and ``true_w0`` [S, D] also the cosine of the recovered content
    latent against the true one (``latent_cos`` [S], its mean
    ``mean_latent_cos``; the denominator floored at 1e-12)."""
    acc = bit_accuracy(result.key_bits, true_keys.to(result.key_bits.device))
    exact = (acc >= 1.0).float()
    out = {"bit_acc": acc, "mean_bit_acc": acc.mean(), "attribution_acc": exact.mean(), "exact": exact}
    if basis is not None and true_w0 is not None:
        w0_rec = content_latent(basis, result.alpha)
        true_w0 = true_w0.to(w0_rec.device)
        num = torch.sum(w0_rec * true_w0, dim=-1)
        den = torch.linalg.norm(w0_rec, dim=-1) * torch.linalg.norm(true_w0, dim=-1)
        out["latent_cos"] = num / torch.clamp(den, min=1e-12)
        out["mean_latent_cos"] = out["latent_cos"].mean()
    return out
