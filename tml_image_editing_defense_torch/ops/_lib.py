"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file, all
sources at once in parallel, and the objects are linked into one shared
library with a plain C interface that ``ctypes`` loads.  The build runs at
the first launch of any kernel, from the sources in this checkout only, into
``build/kernels/`` at the repository root (listed in ``.gitignore``); the
library's name carries a hash of the sources and flags, so an edit rebuilds.
Nothing here runs at import time: the CPU tests import every module and have
no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from tml_image_editing_defense_torch.utils import profiling

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("flash_attention.cu", "pgd_update.cu", "group_norm.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
#: Seconds the last build took, and the compiler's resource report
#: (registers, shared memory and spills of every kernel, from ``-Xptxas -v``).
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: Sequence[Sequence[str]]) -> list:
    """Start every command at once, wait for all, raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({p.returncode}):\n{out}{err}")
    return [out + err for out, err in outs]


def build() -> Path:
    """Compile the kernel library if this checkout's sources have not been
    built yet; return its path."""
    target = BUILD_DIR / f"libtid_kernels-{_digest()}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / (Path(s).stem + ".o")) for s in SOURCES]
        reports = _run_all([
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", o] for s, o in zip(SOURCES, objs)
        ])
        staged = Path(tmp) / target.name
        _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                   "-o", str(staged), *objs]])
        os.replace(staged, target)    # atomic: a concurrent loader sees all or nothing
    build_info.update(seconds=time.perf_counter() - t0, ptxas="".join(reports))
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.tid_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tid_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class CudaKernel:
    """One C entry point of the kernel library and its launch count.

    ``launches`` goes up by one for every launch that the CUDA runtime
    accepted, and nowhere else, so a run can show which kernels it went
    through.  While a recording is open (``utils/profiling.py``) the same
    launch also counts as ``launches.<symbol>`` in the innermost open span."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._counter = f"launches.{symbol}"
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = library().tid_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1
        profiling.count(self._counter)


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer for C."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor, dtypes=(torch.float32, torch.bfloat16)):
    """Raise unless every tensor is a contiguous CUDA tensor of one allowed
    dtype on one device."""
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got one on {t.device}")
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {first.device} and {t.device}")
        if t.dtype != first.dtype or t.dtype not in dtypes:
            raise ValueError(f"{name}: dtype {t.dtype} (want one of {dtypes}, all equal)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
