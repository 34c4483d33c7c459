"""On the card (``pytest -m chip portbench/tests``): one short run of each cell,
and the same with its state left unchanged, which has to read not correct."""

import json
import subprocess
import sys

import pytest

from portbench import cells

WORKLOADS = [w["name"] for w in json.loads((cells.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                          "--seed", "2147483701", "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(cells.ROOT), timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.chip
@pytest.mark.parametrize("workload", WORKLOADS)
def test_unchanged_state_is_not_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "-m", "portbench.controls", "--workload", workload,
                          "--seeds", "2147483702", "--kinds", "unchanged"],
                         capture_output=True, text=True, cwd=str(cells.ROOT), timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = json.loads(out.stdout.strip().splitlines()[-1])["rows"]
    assert rows and not any(r["correct"] for r in rows)
