"""What a run loads and reads: no JAX, no JAX package (top-level names
compared whole), nothing of the old records."""

import os
import re
import subprocess
import sys

from portbench import cells, run

CHECK = r"""
import json, sys, torch
torch.set_num_threads(1)
from pathlib import Path
from portbench import cells, counts, data, readings, run, trace
from portbench.reference import attack, models
root = Path(sys.argv[1])
cell = cells.load_cell("tiny-l2-b4", root=root)
run.run_cell(cell, 1, 0.5, True, device="cpu", root=root)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax(tiny_root):
    env = dict(os.environ, PYTHONPATH=str(cells.ROOT))
    out = subprocess.run([sys.executable, "-c", CHECK, str(tiny_root)], capture_output=True,
                         text=True, env=env, cwd=str(cells.ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(run.FORBIDDEN)
    assert "tml_image_editing_defense_torch" in loaded


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "tml_image_editing_defense_tpu_x", sys)
    assert run.forbidden_modules() == sorted(set(run.forbidden_modules()) & set(run.FORBIDDEN))
    assert "jaxtyping_like" not in run.forbidden_modules()


def test_sources_name_nothing_outside():
    bad = re.compile(r"import jax|from jax|tml_image_editing_defense_tpu\b|chip_smoke|"
                     r"BENCH_r|BENCH_local|MULTICHIP|BASELINE\.json|root bench")
    here = cells.HERE
    for path in here.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = "\n".join(line for line in path.read_text().splitlines()
                          if not line.startswith("FORBIDDEN = "))
        assert not bad.search(text), path


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        return
    assert run.main(["--workload", "sd15-diff-l2-b4", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_alone_in_a_checkout_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ gives no result."""
    import shutil

    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(cells.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "sd15-diff-l2-b4", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(tmp_path), timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""
