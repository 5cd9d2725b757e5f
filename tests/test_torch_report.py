"""The port's report CLI against the JAX package's, on the committed study
records: every one of the twelve record files renders to the same markdown in
both packages.  The port reads its own records (``study_<name>_torch``) and
never the JAX package's names."""

import json
import shutil
from pathlib import Path

import pytest

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.cli import report as jreport
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import report

RESULT = Path(__file__).resolve().parent.parent / "result"
RECORDED = ["headline", "robustness", "scaling", "perceptual", "polish", "attackaware", "pruning", "bestrecipe",
            "capacity", "identification", "model_attribution", "encoderinit"]


@pytest.fixture
def both_layouts(tmp_path, monkeypatch):
    """A working directory whose ``result/`` holds every committed record file
    twice: under the JAX package's name and under the port's."""
    (tmp_path / "result").mkdir()
    for src in RESULT.glob("study_*.json*"):
        shutil.copy(src, tmp_path / "result" / src.name)
        stem, _, tail = src.name.partition(".json")
        shutil.copy(src, tmp_path / "result" / f"{stem}_torch.json{tail}")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_studies_match_the_reference_list():
    assert report.STUDIES == jreport.STUDIES
    assert set(RECORDED) <= set(report.STUDIES) and len(RECORDED) == 12


@pytest.mark.parametrize("name", RECORDED)
def test_render_matches_jax_on_the_committed_records(both_layouts, name):
    """Each study's records, loaded by each package from its own file name,
    render identically (the A/B studies join their baselines through each
    package's own loader)."""
    jrecs, recs = jreport._load(name), report._load(name)
    assert jrecs and recs == jrecs
    assert report.render(name, recs) == jreport.render(name, jrecs)


def test_main_prints_the_tables_and_fails_without_records(both_layouts, capsys):
    assert report.main(["robustness", "identification"]) == 0
    out = capsys.readouterr().out
    assert out == (jreport.render("robustness", jreport._load("robustness")) + "\n\n"
                   + jreport.render("identification", jreport._load("identification")) + "\n\n")
    # no spectrum records in either layout: named, it is reported and the exit code is 1
    assert report.main(["spectrum"]) == jreport.main(["spectrum"]) == 1
    assert "no records for study_spectrum" in capsys.readouterr().err


def test_reads_the_port_names_only(tmp_path, monkeypatch, capsys):
    (tmp_path / "result").mkdir()
    for src in RESULT.glob("study_robustness.json*"):
        shutil.copy(src, tmp_path / "result" / src.name)
    monkeypatch.chdir(tmp_path)
    assert report._load("robustness") is None
    assert report.main([]) == 1  # nothing of the port's to render
    rec = json.loads((RESULT / "study_robustness.json.jsonl").read_text().splitlines()[0])
    (tmp_path / "result" / "study_robustness_torch.json.jsonl").write_text(json.dumps(rec) + "\n" + '{"tag": "x", "me')
    assert report._load("robustness") == [rec]  # a torn final line is dropped
    assert report.main([]) == 0
    assert "study_robustness (1 points)" in capsys.readouterr().out
