"""On the card: every cell of BENCHMARK.json runs through `run.py` with
a short window and comes out correct, and the control at each cell's own
size comes out not correct. Run with `python -m pytest benchmark/tests -q
-m cuda` on a machine with an NVIDIA GPU; they skip elsewhere."""

import json
import subprocess
import sys

import pytest

from portbench import compare, spec

from portbench_helpers import BENCH, ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_portbench_cell_runs_correct_on_the_card(cuda, cell):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cell,
                          "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, out.stderr[-3000:]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_portbench_control_fails_on_the_card(cuda, cell):
    sys.argv = ["control.py"]
    import control

    w = spec.workload(spec.load_benchmark(BENCH), cell)
    cfg, _ = spec.config(w["config"], BENCH)
    readings = control.control_readings(cell, 2 ** 31 + 9, "cuda")
    assert not compare.passed(compare.checks(0, *readings, cfg["limits"])), readings
