"""The port stands alone: it imports neither JAX nor the JAX package, and its
chip check refuses to run without a card."""

from __future__ import annotations

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import tml_image_editing_defense_torch as port

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(port.__file__).parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], prefix=port.__name__ + "."))


def test_importing_every_port_module_loads_no_jax():
    mods = _modules()
    assert len(mods) > 20, mods
    assert ({f"{port.__name__}.{m}" for m in ("cli", "pipelines.img2img", "utils.checkpoint",
                                             "utils.preemption", "attack.universal",
                                             "models.tiny_vae", "data.dataset",
                                             "universal_attack", "aux_models.segment",
                                             "aux_models.caption",
                                             "models.isnet", "utils.flops",
                                             "utils.profiling", "models.lora",
                                             "models.checkpoint_io", "prepare_real_weights",
                                             "parallel.sweep", "parallel.hosts",
                                             "parallel.mesh", "parallel.eot",
                                             "parallel.dp_eot", "launch_host")}
            <= set(mods))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'msgpack',"
        " 'safetensors', 'transformers', 'tml_image_editing_defense_tpu'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|tml_image_editing_defense_tpu)\b", re.M)
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py",
                 ROOT / "scripts" / "probe_remat_cuda.py",
                 ROOT / "scripts" / "probe_flash_cuda.py"]:
        assert not pattern.search(path.read_text()), path


REAL_WEIGHT_MODULES = ("models/convert.py", "models/lora.py", "models/checkpoint_io.py",
                       "models/tokenizer.py", "models/tiny_vae.py", "models/model_zoo.py",
                       "prepare_real_weights.py", "api.py", "universal_attack.py")


@pytest.mark.parametrize("rel", REAL_WEIGHT_MODULES + ("chip_smoke.py",))
def test_real_weight_path_needs_no_serialization_library(rel):
    """The card's machine has neither flax, msgpack, safetensors nor
    transformers: the modules that read and write real weights, and the
    chip check, import none of them (nor JAX), even inside a function.
    (Only the aux models' optional BLIP-2 and pipeline routes use
    transformers.)"""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|msgpack|safetensors|transformers"
                         r"|tml_image_editing_defense_tpu)\b", re.M)
    path = ROOT / rel if rel == "chip_smoke.py" else PKG / rel
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
