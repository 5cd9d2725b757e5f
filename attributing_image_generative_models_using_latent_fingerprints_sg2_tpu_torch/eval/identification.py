"""Measured end-to-end user identification: solve real images, decode WHICH
user's key they carry, sweep the registry size.

Counterpart of the reference package's ``eval/identification.py``.  One
batch of solves serves the whole registry-size curve: every planted user
comes from the registry's first ``min(registry_sizes)`` entries, so each
larger prefix only adds distractors.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..attacks import make_attack
from ..config import AttackConfig, AttributionConfig, FingerprintConfig
from ..fingerprint import attribute as attr
from ..fingerprint import embed as fpe
from ..fingerprint import encoder as enc_mod
from ..fingerprint import pipeline as pl
from ..fingerprint.keys import KeyRegistry, identification_error_union_bound
from ..utils.lhs import fold_in
from .study import wilson_ci


def identification_point(
    pipe: pl.Pipeline,
    *,
    key_len: int = 32,
    sigma: float = 6.0,
    shift: Optional[int] = None,
    min_distance: int = 6,
    registry_sizes: Sequence[int] = (10, 100, 1000),
    samples: int = 20,
    steps: int = 2000,
    n_starts: int = 20,
    seed: int = 100,
    dtype: str = "bfloat16",
    chunk_samples: int = 0,
    clip_targets: bool = True,
    attack: str = "None",
    attack_aware: bool = False,
    issuance: str = "rejection",
    init: str = "lhs",
    encoder_steps: int = 1500,
    encoder_jitter: float = 0.25,
) -> Dict[str, Any]:
    """Generate ``samples`` images planted with registry keys, solve them once,
    and decode the user against every registry prefix size.

    Planted users are drawn round-robin from the first ``min(registry_sizes)``
    users.  Returns per-N soft/hard identification accuracy with Wilson CIs,
    mean soft margins, the measured per-bit error rate and the union bound
    it implies at each N.  ``issuance`` is "rejection" (pairwise distance at
    least ``min_distance``) or "rm" (Reed-Muller codewords; the code sets
    the distance).  ``init`` is "lhs" or "encoder" (an inverter trained on
    the attack channel seeds the restarts).  ``dtype`` is the solver's compute
    dtype (bfloat16 by default, as in the reference's study).  Every random
    draw comes from a generator folded from ``seed``.
    """
    sizes = sorted(set(int(n) for n in registry_sizes))
    if sizes[0] < 2:
        raise ValueError("registry sizes must be >= 2")
    if issuance == "rm":
        reg = KeyRegistry.issue_rm(sizes[-1], key_len, seed=seed)
        min_distance = reg.min_distance
    elif issuance == "rejection":
        reg = KeyRegistry.issue(sizes[-1], key_len, min_distance=min_distance, seed=seed)
    else:
        raise ValueError(f"unknown issuance {issuance!r}")
    if init not in ("lhs", "encoder"):
        raise ValueError(f"unknown init {init!r}")

    if shift is None:
        shift = pipe.mcfg.style_space_dim - key_len
    basis = fpe.build_basis(pipe.pca, FingerprintConfig(key_len=key_len, shift=shift, sigma=sigma))
    # attack_aware: the solver pushes its estimate through the known attack's
    # deterministic channel model, the mode a deployment would use
    acfg = AttributionConfig(steps=steps, n_starts=n_starts, loss="mse",
                             solver_attack=(attack if attack_aware else "None"))

    users = np.arange(samples) % sizes[0]  # round-robin planted users
    bits = torch.as_tensor(reg.keys[users], dtype=torch.float32, device=pipe.device)
    alpha = fpe.sample_alpha(basis, samples, fold_in(seed, 0xFACE))
    _, wx = fpe.embed(basis, alpha, bits)
    # trained generators emit ~[-1, 1] and deployments store clipped images;
    # random-init test generators leave that range, so tests turn the clip off
    targets = pl.synthesize(pipe, wx)
    if clip_targets:
        targets = torch.clamp(targets, -1.0, 1.0)
    atk_cfg = None
    if attack != "None":
        atk_cfg = dataclasses.replace(AttackConfig(), augmentation=attack)
        with torch.no_grad():
            targets = make_attack(atk_cfg)(targets, fold_in(seed, 0xA77))

    enc_meta: Dict[str, Any] = {}
    alpha_init = key_init = None
    if init == "encoder":
        t_enc = time.time()
        enc_params, enc_curve, _ = enc_mod.train_for_init(
            pipe.gen_params, basis, pipe.noise, mcfg=pipe.mcfg, seed=seed, steps=encoder_steps,
            jitter=encoder_jitter, attack_cfg=atk_cfg)
        alpha_init, key_init = enc_mod.encoder_solve_init(enc_params, basis, targets, n_starts,
                                                          fold_in(seed, 8), jitter=encoder_jitter)
        enc_acc = enc_mod.encoder_bit_accuracy(enc_params, targets, bits)
        enc_meta = {
            "init": "encoder",
            "encoder_steps": encoder_steps,
            "encoder_jitter": encoder_jitter,
            "encoder_bit_acc": float(enc_acc.mean()),
            "encoder_final_train_loss": float(enc_curve[-1]) if len(enc_curve) else None,
            "encoder_train_wall_s": round(time.time() - t_enc, 1),
        }

    chunk = chunk_samples or samples
    logits_all, bits_all = [], []
    for c0 in range(0, samples, chunk):
        c1 = min(c0 + chunk, samples)
        init_kw = {}
        if alpha_init is not None:
            init_kw = dict(alpha_init=alpha_init[c0:c1], key_init=key_init[c0:c1])
        res = attr.attribute_chunked(
            pipe.gen_params, None, basis, pipe.noise, targets[c0:c1], mcfg=pipe.mcfg, acfg=acfg,
            generator=fold_in(fold_in(seed, 0xFACE + 1), c0), dtype=dtype,
            attack_cfg=(atk_cfg if attack_aware else None), **init_kw)
        logits_all.append(res.key_logits.detach().cpu().numpy().astype(np.float64))
        bits_all.append(res.key_bits.detach().cpu().numpy())
    logits = np.concatenate(logits_all)  # [S, K]
    dec_bits = np.concatenate(bits_all)  # [S, K]

    true = reg.keys[users].astype(dec_bits.dtype)
    p_bit = float((dec_bits != true).mean())

    per_n = []
    for n in sizes:
        # Both decoders break ties toward the LOWER index and the planted users
        # sit at the low indices: a seeded shuffle of each prefix keeps
        # tie-breaking index-neutral, as it is in deployment.
        perm = np.random.default_rng(seed * 1_000_003 + n).permutation(n)
        inv = np.argsort(perm)  # original index -> shuffled position
        sub = KeyRegistry(keys=reg.keys[:n][perm], names=[reg.names[i] for i in perm],
                          min_distance=reg.min_distance)
        soft_ok = hard_ok = 0
        margins = []
        for s in range(samples):
            si, _, margin = sub.match_soft(logits[s])
            hi, _, _ = sub.match_hard(dec_bits[s])
            soft_ok += si == inv[users[s]]
            hard_ok += hi == inv[users[s]]
            margins.append(margin)
        slo, shi = wilson_ci(soft_ok, samples)
        per_n.append({
            "registry_size": n,
            "soft_accuracy": soft_ok / samples,
            "soft_ci95": [slo, shi],
            "hard_accuracy": hard_ok / samples,
            "mean_margin_nats": float(np.mean(margins)),
            "min_margin_nats": float(np.min(margins)),
            "union_bound_error": identification_error_union_bound(p_bit, n, key_len, min_distance),
        })

    return {
        "img_size": pipe.mcfg.img_size,
        "channel_max": pipe.mcfg.channel_max,
        "ckpt": pipe.mcfg.ckpt,
        "key_len": key_len,
        "sigma": float(sigma),
        "shift": int(shift),
        "min_distance": min_distance,
        "issuance": issuance,
        "attack": attack,
        "attack_aware": bool(attack_aware),
        "samples": samples,
        "steps": steps,
        "n_starts": n_starts,
        "distinct_users": int(sizes[0]),
        "measured_p_bit": p_bit,
        "mean_bit_acc": 1.0 - p_bit,
        "by_registry_size": per_n,
        **enc_meta,
    }
