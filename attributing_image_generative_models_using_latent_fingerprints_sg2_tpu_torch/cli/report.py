"""Render the quality tables from the study records.

Counterpart of the reference package's ``cli/report.py``, the same tables
and columns: ``python -m <port>.cli.report [study ...]`` reads the port's
records, ``result/study_<name>_torch.json.jsonl`` (the per-point records
``cli.study`` appends as it runs; ``capacity``'s final JSON where it has no
jsonl), and prints each table as GitHub markdown, so a table is a mechanical
render of the measured records.  The reference package's own records
(``result/study_<name>.json``) are not read.

With no arguments it renders every study that has records on disk; it exits
1 when it rendered none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

RESULT_DIR = "result"
STUDIES = ["headline", "robustness", "scaling", "perceptual", "polish",
           "attackaware", "pruning", "bestrecipe", "capacity",
           "identification", "model_attribution", "spectrum",
           "encoderinit"]


def _load(name: str):
    path = os.path.join(RESULT_DIR, f"study_{name}_torch.json.jsonl")
    if not os.path.exists(path):
        # capacity writes only the final JSON, no jsonl
        path = os.path.join(RESULT_DIR, f"study_{name}_torch.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)
    from ..utils.io import read_jsonl_resumable

    return read_jsonl_resumable(path)


def _ci(rec, key):
    lo, hi = rec[key]
    return f"[{lo:.3f}, {hi:.3f}]"


def _acc_cell(rec):
    return f"{rec['mean_bit_acc']:.4f} {_ci(rec, 'bit_acc_ci95')}"


def _exact_cell(rec):
    return (f"{rec['exact_match_k']}/{rec['samples']} "
            f"{_ci(rec, 'exact_match_ci95')}")


def _spearman_cell(v) -> str:
    """None (degenerate point, new records) and NaN (old records written
    before the None convention) both render as '-' instead of 'nan'."""
    if v is None or (isinstance(v, float) and v != v):
        return "-"
    return f"{v:.2f}"


def _table(rows, header):
    out = ["| " + " | ".join(header) + " |",
           "|" + "---|" * len(header)]
    for r in rows:
        out.append("| " + " | ".join(str(c) for c in r) + " |")
    return "\n".join(out)


def _std_rows(recs, label=lambda r: r["tag"]):
    rows = []
    for r in sorted(recs, key=lambda r: -r["mean_bit_acc"]):
        rows.append([label(r), _acc_cell(r), _exact_cell(r),
                     f"{r.get('wall_s', 0):.0f}s"])
    return _table(rows, ["point", "mean bit acc [95% CI]",
                         "exact match [95% CI]", "wall"])


def _baseline_row(name: str, rec, baselines):
    """Match an A/B study row to its baseline row.

    polish/pruning rows pair with the same operating point in
    study_headline (tag minus the variant suffix); attackaware rows pair
    with the same attack in study_robustness (tag minus '_aware')."""
    if not baselines:
        return None
    tag = rec["tag"]
    if name == "attackaware" and tag.endswith("_aware"):
        return baselines.get(tag[: -len("_aware")])
    base = tag
    if name == "encoderinit":
        for sfx in ("_encaware", "_aware", "_enc24k", "_enc6kj50", "_enc6k", "_enc"):
            if tag.endswith(sfx):
                return baselines.get(tag[: -len(sfx)] + "_lhs")
    for suffix in ("_polish2_soft", "_polish2_m5", "_polish2",
                   "_prune20to5", "_n40prune8", "_best"):
        if base.endswith(suffix):
            return baselines.get(base[: -len(suffix)])
    return None


def _ab_rows(name: str, recs):
    if name == "encoderinit":
        # self-contained study: *_enc rows pair with the *_lhs rows
        # solved on the same retrained model (see cmd_encoderinit)
        src = "same-model _lhs rows"
        baselines = {r["tag"]: r for r in recs if r["tag"].endswith("_lhs")}
        recs = [r for r in recs if not r["tag"].endswith("_lhs")]
    elif name == "bestrecipe":
        # clean rows pair with headline tags, attacked rows with
        # robustness tags --- merge both baseline pools
        src = "headline+robustness"
        baselines = {r["tag"]: r for r in (_load("headline") or [])}
        baselines.update({r["tag"]: r for r in (_load("robustness") or [])})
    else:
        src = "robustness" if name == "attackaware" else "headline"
        baselines = {r["tag"]: r for r in (_load(src) or [])}
    rows = []
    for r in sorted(recs, key=lambda r: r["tag"]):
        b = _baseline_row(name, r, baselines)
        delta = (f"{r['mean_bit_acc'] - b['mean_bit_acc']:+.4f} / "
                 f"{r['exact_match_k'] - b['exact_match_k']:+d} exact"
                 if b else "(no baseline row)")
        row = [r["tag"], _acc_cell(r), _exact_cell(r), delta,
               r.get("chain_steps_per_sample", ""),
               f"{r.get('wall_s', 0):.0f}s"]
        if name == "encoderinit":
            ea = r.get("encoder_bit_acc")
            row.insert(3, f"{ea:.4f}" if ea is not None else "—")
        rows.append(row)
    hdr = ["point", "mean bit acc [95% CI]", "exact match [95% CI]",
           f"delta vs {src} (bit acc / exact)", "chain-steps/sample", "wall"]
    if name == "encoderinit":
        hdr.insert(3, "encoder 0-step acc")
    return _table(rows, hdr)


def render(name: str, recs) -> str:
    title = f"## study_{name} ({len(recs)} points)"
    if name == "capacity":
        fmt = lambda v: f"{v:.2f}" if isinstance(v, float) else v
        fmt4 = lambda v: f"{v:.4f}" if isinstance(v, float) else v
        has_full = any(r.get("mean_bit_acc_full") is not None for r in recs)
        rows = [[r.get("key_len"), r.get("sigma"), fmt(r.get("fid")),
                 fmt(r.get("fid_disc")), fmt4(r.get("watermark_lpips")),
                 fmt4(r.get("watermark_mse")),
                 round(r.get("mean_bit_acc", 0), 4)]
                + ([fmt4(r.get("mean_bit_acc_full"))] if has_full else [])
                for r in recs]
        hdr = ["key_len", "sigma", "watermark FID", "disc-feature FD",
               "watermark LPIPS", "watermark MSE", "bit acc (500/8)"]
        if has_full:
            hdr.append(
                f"bit acc ({recs[0].get('full_budget', 'full')} budget)")
        return title + "\n" + _table(rows, hdr)
    if name == "model_attribution":
        def _op_point(r, sweep_key, sym, max_fr=0.05):
            """Deployable accept-if-geq operating point from a recorded
            sweep: the largest accept threshold with FR <= max_fr (FR is
            monotone increasing in thr, FA decreasing, so this minimizes
            FA subject to the FR budget)."""
            sweep = r.get(sweep_key)
            if not sweep:
                return "-"
            ok = [p for p in sweep if p["false_reject"] <= max_fr
                  and p.get("false_accept") is not None]
            if not ok:
                return "-"
            best = max(ok, key=lambda p: p["threshold"])
            return (f"FR {best['false_reject']:.3f} / "
                    f"FA {best['false_accept']:.3f} "
                    f"({sym}>={best['threshold']:.2f})")
        rows = []
        for r in recs:
            lo, hi = r["decision_acc_ci95"]
            rows.append([
                r["tag"],
                f"M={len(r['registry'])}+{len(r['held_out'])} held-out",
                f"{r['decision_acc']:.3f} [{lo:.2f}, {hi:.2f}]",
                (f"{r['key_bit_acc_when_decided']:.4f}"
                 if r.get("key_bit_acc_when_decided") is not None else "-"),
                f"{r['margin_median_in_dist']:.1f}x",
                f"FR {r['false_reject_at_threshold']:.3f} / "
                f"FA {r['false_accept_at_threshold']:.3f}",
                _op_point(r, "margin_open_set_sweep", "m"),
                _op_point(r, "combined_open_set_sweep", "mc"),
                (f"{r['open_set_auc']:.3f}"
                 if r.get("open_set_auc") is not None else "-"),
                (f"{r['margin_open_set_auc']:.3f}"
                 if r.get("margin_open_set_auc") is not None else "-"),
                (f"{r['coherence_open_set_auc']:.3f}"
                 if r.get("coherence_open_set_auc") is not None else "-"),
                (f"{r['combined_open_set_auc']:.3f}"
                 if r.get("combined_open_set_auc") is not None else "-"),
                f"{r.get('wall_s', 0):.0f}s"])
        return title + "\n" + _table(
            rows, ["point", "registry", "decision acc [95% CI]",
                   "key bit acc (when decided)", "median margin (in)",
                   "open-set @ loss thr", "margin rule @ FR<=0.05",
                   "margin x coherence @ FR<=0.05",
                   "loss AUC", "margin AUC", "coherence AUC",
                   "combined AUC", "wall"])
    if name == "scaling":
        rows = []
        for r in sorted(recs, key=lambda r: (r["img_size"],
                                             r["channel_max"],
                                             r["train_steps"], r["sigma"])):
            rows.append([
                f"{r['img_size']} / {r['channel_max']} / "
                f"{r['train_steps'] // 1000}k",
                f"s={r['sigma']:g}", f"{r['mean_bit_acc']:.4f}",
                f"{r['band_sigma_median']:.3f}",
                f"{r['content_sigma_median']:.3f}",
                _spearman_cell(r.get("bit_sigma_spearman"))])
        return title + "\n" + _table(
            rows, ["model (px/width/steps)", "sigma", "bit acc",
                   "key-band sigma med", "content sigma med",
                   "bit-vs-sigma Spearman"])
    if name == "spectrum":
        rows = []
        for r in sorted(recs, key=lambda r: (r.get("data_dim") or 999,
                                             r["key_len"], r["sigma"])):
            ratio = r["content_sigma_median"] / max(r["band_sigma_median"],
                                                    1e-12)
            rows.append([
                (f"d={r['data_dim']}" if r.get("data_dim") else "full (35)"),
                f"kl{r['key_len']} s={r['sigma']:g}",
                _acc_cell(r), _exact_cell(r),
                f"{r['band_sigma_median']:.4f}",
                f"{r['content_sigma_median']:.3f}",
                f"{ratio:.1f}x",
                _spearman_cell(r.get("bit_sigma_spearman"))])
        return title + "\n" + _table(
            rows, ["data intrinsic dim", "point",
                   "mean bit acc [95% CI]", "exact match [95% CI]",
                   "key-band sigma med", "content sigma med",
                   "spectrum ratio", "bit-vs-sigma Spearman"])
    if name in ("pruning", "polish", "attackaware", "encoderinit"):
        return title + "\n" + _ab_rows(name, recs)
    if name == "identification":
        rows = []
        for r in recs:
            atk = r.get("attack", "None")
            head = (f"{r['img_size']}px kl{r['key_len']} s{r['sigma']:g} "
                    f"d_min={r['min_distance']}"
                    + (" RM" if r.get("issuance") == "rm" else "")
                    + (f" +{atk}" if atk != "None" else "")
                    + (" aware" if r.get("attack_aware") else "")
                    + f" (p_bit {r['measured_p_bit']:.4f})")
            for row in r["by_registry_size"]:
                lo, hi = row["soft_ci95"]
                rows.append([
                    head, row["registry_size"],
                    f"{row['soft_accuracy']:.3f} [{lo:.2f}, {hi:.2f}]",
                    f"{row['hard_accuracy']:.3f}",
                    f"{row['mean_margin_nats']:.1f}",
                    f"{row['union_bound_error']:.3g}"])
                head = ""
        return title + "\n" + _table(
            rows, ["operating point", "registry N",
                   "soft ID acc [95% CI]", "hard ID acc",
                   "mean margin (nats)", "union-bound err"])
    return title + "\n" + _std_rows(recs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("studies", nargs="*", default=[],
                   help=f"subset of {STUDIES} (default: all with records)")
    args = p.parse_args(argv)
    names = args.studies or STUDIES
    shown = 0
    for name in names:
        recs = _load(name)
        if not recs:
            if args.studies:
                print(f"[report] no records for study_{name}", file=sys.stderr)
            continue
        print(render(name, recs))
        print()
        shown += 1
    return 0 if shown else 1


if __name__ == "__main__":
    sys.exit(main())
