"""The comparison that decides ``correct`` fails what it has to fail: the
control (the reference one precision lower in the port's place), and the
timed path broken underneath (a step that returns its state unchanged, an
Adam step with the wrong rate decay or that leaves alpha where it was while
its moments move, half of the batch left out, an answer altered where it is
produced), on the CPU at a tiny size, past the harness' look for a chip."""

from __future__ import annotations

import dataclasses
import importlib

import pytest
import torch

from portbench.core import PORT, SpecError, judge
from portbench.tests.tiny import ATTR, LIMITS, run_tiny


@pytest.mark.parametrize("kind,traffic", [("attribute", {}), ("generate", {}),
                                          ("attribute", {"targets_per_solve": 2, "remat": True})])
def test_sound_run_is_correct(kind, traffic):
    result, lines = run_tiny(kind, **traffic)
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "check"
    assert all(line.startswith("check ") and " limit " in line for line in lines)


def test_unfollowed_solver_settings_are_refused():
    with pytest.raises(SpecError):
        run_tiny("attribute", solver=dict(ATTR["solver"], prune_starts=2))


@pytest.mark.parametrize("kind,control", [("attribute", "bfloat16"), ("attribute", "tf32"), ("generate", "bfloat16"),
                                          ("generate", "tf32")])
def test_control_fails(kind, control):
    result, _ = run_tiny(kind, controls=(control,))
    assert result["correct"]
    ok, shown = judge(result["controls"][control], LIMITS[kind])
    assert not ok, shown


def _patch(monkeypatch, module: str, name: str, wrap):
    mod = importlib.import_module(f"{PORT}.{module}")
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))


def _unchanged_state(real):
    def adam_update(state, grads, acfg):
        new = real(state, grads, acfg)
        return {**state, "count": new["count"]}
    return adam_update


def _lr_decay_doubled(real):
    def adam_update(state, grads, acfg):
        return real(state, grads, dataclasses.replace(acfg, lr_decay=2 * acfg.lr_decay))
    return adam_update


def _alpha_unmoved(real):
    def adam_update(state, grads, acfg):
        new = real(state, grads, acfg)
        return {**new, "alpha": state["alpha"]}
    return adam_update


def _half_batch(real):
    def make_step(*args, **kwargs):
        step, per_elem = real(*args, **kwargs)

        def half(alpha, key, ctf_sigma=None):
            per = per_elem(alpha, key, ctf_sigma)
            n = per.shape[1] // 2 or 1
            kept = per[:, :n]
            return torch.cat([kept, kept.mean(dim=1, keepdim=True).expand(-1, per.shape[1] - n)], dim=1)

        def step_half(state, ctf_sigma=None):
            alpha = state["alpha"].detach().requires_grad_(True)
            key = state["key"].detach().requires_grad_(True)
            with torch.enable_grad():
                per = half(alpha, key, ctf_sigma)
                g_alpha, g_key = torch.autograd.grad(per.sum(), [alpha, key])
            attr = importlib.import_module(f"{PORT}.fingerprint.attribute")
            return attr.adam_update(state, {"alpha": g_alpha, "key": g_key}, args[5]), per.detach()

        return step_half, per_elem
    return make_step


def _altered_bits(real):
    def attribute(*args, **kwargs):
        res = real(*args, **kwargs)
        res.key_bits = 1.0 - res.key_bits
        return res
    return attribute


def _half_images(real):
    def synthesize(pipe, w):
        imgs = real(pipe, w)
        n = imgs.shape[0] // 2
        return torch.cat([imgs[:n], imgs[:n].mean(dim=0, keepdim=True).expand(imgs.shape[0] - n, -1, -1, -1)])
    return synthesize


def _altered_image(real):
    def make_image(imgs):
        u8 = real(imgs).copy()
        u8[0] = 255 - u8[0]
        return u8
    return make_image


FAULTS = {
    "attr_state_unchanged": ("attribute", "fingerprint.attribute", "adam_update", _unchanged_state),
    "attr_lr_decay_doubled": ("attribute", "fingerprint.attribute", "adam_update", _lr_decay_doubled),
    "attr_alpha_unmoved": ("attribute", "fingerprint.attribute", "adam_update", _alpha_unmoved),
    "attr_half_batch": ("attribute", "fingerprint.attribute", "make_attribution_step", _half_batch),
    "attr_answer_altered": ("attribute", "fingerprint.attribute", "attribute", _altered_bits),
    "gen_half_batch": ("generate", "fingerprint.pipeline", "synthesize", _half_images),
    "gen_answer_altered": ("generate", "utils.image", "make_image", _altered_image),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(monkeypatch, fault):
    kind, module, name, wrap = FAULTS[fault]
    _patch(monkeypatch, module, name, wrap)
    result, _ = run_tiny(kind)
    assert not result["correct"], result["check"]
