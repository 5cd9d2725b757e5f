"""What the harness loads: never JAX or the JAX package (compared by whole
top-level names: the port's name begins with the JAX package's), and the
reference nothing of the port.  Nothing reads the JAX package's benchmark
files."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from portbench.core import FORBIDDEN, PORT, REPO, ROOT

HARNESS = """
import sys
sys.path.insert(0, {repo!r})
from pathlib import Path
from portbench import core, tracing, run, calibrate
from portbench.kinds import attribute, generate, common
for path in sorted(Path({root!r}, "metrics").glob("*.py")):
    if not path.name.startswith("_"):
        core.metric_reader(path.stem)
from portbench.tests.tiny import run_tiny
run_tiny("attribute"); run_tiny("generate")
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys
sys.path.insert(0, {repo!r})
from portbench.reference import lpips_vgg16, precision, solver, stylegan2
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
print(sorted(m for m in sys.modules if m.startswith("portbench")))
"""


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code.format(repo=str(REPO), root=str(ROOT))], capture_output=True,
                         text=True, timeout=600, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return [eval(line) for line in out.stdout.strip().splitlines()[-2:]]


def test_harness_loads_no_jax():
    tops = _loaded(HARNESS)[-1]
    assert PORT in tops  # the system under test ran
    assert not set(tops) & set(FORBIDDEN), tops


def test_reference_loads_nothing_of_the_port():
    tops, ours = _loaded(REFERENCE)
    assert PORT not in tops and not set(tops) & set(FORBIDDEN), tops
    assert all(m == "portbench" or m.startswith("portbench.reference") for m in ours), ours


def test_nothing_reads_the_jax_benchmark():
    for path in ROOT.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "bench.py" not in text and "BENCH_" not in text and "BASELINE" not in text, path


def test_forbidden_names_are_whole():
    assert PORT not in FORBIDDEN and PORT.startswith(FORBIDDEN[-1])
    assert Path(REPO, PORT).is_dir()
