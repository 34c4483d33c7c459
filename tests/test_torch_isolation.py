"""The port stands alone: it imports neither JAX nor the JAX package, and its
chip check refuses to run without a card."""

from __future__ import annotations

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import tml_image_editing_defense_torch as port

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(port.__file__).parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], prefix=port.__name__ + "."))


def test_importing_every_port_module_loads_no_jax():
    mods = _modules()
    assert len(mods) > 20, mods
    assert {f"{port.__name__}.{m}" for m in ("cli", "pipelines.img2img", "utils.checkpoint",
                                             "utils.preemption", "attack.universal",
                                             "models.tiny_vae", "data.dataset",
                                             "universal_attack", "aux_models.segment",
                                             "aux_models.caption",
                                             "models.isnet")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'flax',"
        " 'tml_image_editing_defense_tpu')))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|tml_image_editing_defense_tpu)\b", re.M)
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without CUDA (this machine) the chip check exits non-zero and prints
    no result line."""
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("this checks the CPU-only machine's refusal")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
