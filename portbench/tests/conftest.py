"""Fixtures of the benchmark's tests: a checkout root holding the real
benchmark plus a tiny cell (``portbench/tests/data``) added as new files,
run on the CPU.  Tests that need the card carry the ``chip`` marker and
decide inside the test whether there is one."""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
TINY = "tiny-l2-b4"


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card (skips without one)")


@pytest.fixture(scope="session", autouse=True)
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DUMMY_METRIC = '''"""A per-layer metric added by a test as a new file."""

LAYER = "test layer"
UNIT = "steps"
BETTER = "higher"
MOVES = "image_iters_per_s"


def read(trace):
    return float(trace.steps)
'''


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout root: the repository's ``portbench`` and ``BENCHMARK.json``
    with the tiny cell and a dummy metric added as files and entries."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic", "limits"):
        for f in (HERE / "data" / sub).iterdir():
            shutil.copy(f, root / "portbench" / sub / f.name)
    (root / "portbench" / "metrics" / "dummy_steps.py").write_text(DUMMY_METRIC)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": TINY, "config": "tiny", "traffic": TINY, "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "dummy_steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "test layer",
                               "moves": "image_iters_per_s", "workloads": [TINY]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_cell(tiny_root):
    from portbench import cells

    return cells.load_cell(TINY, root=tiny_root)
