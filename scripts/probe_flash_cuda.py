#!/usr/bin/env python3
"""Where the time of the flash-attention kernels K1 (forward), K2 (dK, dV)
and K3 (dQ) goes, on one NVIDIA card.

Run from the repository root on a machine with the card and nvcc:

    python3 scripts/probe_flash_cuda.py [--report PATH]
    python3 scripts/probe_flash_cuda.py --bf16 [--baseline-cu PATH]
        [--extra-cu NAME PATH] [--variant NAME KERNEL OLD NEW] [--quick]
        [--shapes B,T,H,D;...]
        [--deadline S] [--report PATH]

Without ``--bf16`` (the f32 study) it prints, as JSON lines:

1. the card's name and power limit;
2. the rate of ``mma.sync.m16n8k8`` in TF32 from a loop of independent
   products (eight warps a block, one block per SM, and two): the ceiling
   of the instruction that K1, K2 and K3 are built on in f32;
3. for each shape, f32, the mean times (CUDA events) of K1 and of K2 and
   K3 in the tree's ``csrc/flash_attention.cu`` and in variants built from
   it with one part taken out: ``no_copies`` (the streamed KV or Q tiles
   stop arriving once the ring's stages are full), ``copies_only`` (the
   products skipped: both of K1's plans, the D = 512 plan of K2/K3),
   ``half_rows`` (half of each streamed tile of K2/K3 copied),
   ``first_product_only`` and ``second_product_only`` (the D = 512 plan of
   K2/K3 without its accumulating products, or without its score
   products).  The variants compute wrong results on purpose; the
   unchanged build is checked against the plain versions.  Variants run in
   turns (a, b, ..., b, a).

With ``--bf16`` it studies the bf16 K1, K2 and K3 of the tree's source,
of ``--baseline-cu`` (another ``flash_attention.cu``, for example an
earlier commit's, written out with ``git show``), of each ``--extra-cu``
(one more such source, by name) and of each ``--variant``
(the tree's source with OLD replaced by NEW inside KERNEL's definition; a
NAME given more than once takes all its patches), all built at once, and
prints:

1. the card's name and power limit, and each build's registers and spills
   of K1, K2 and K3 (``-Xptxas -v``) with ptxas's notes on ``wgmma``;
2. every build's K1, K2 and K3 against ``flash_fwd_reference``,
   ``flash_bwd_kv_reference`` and ``flash_bwd_q_reference`` at ragged
   shapes that cross a batch and a head boundary at every compiled head
   dim, and at the main paths' bf16 shapes: the max abs error against
   ``chip_smoke.check_flash``'s limit with its floor, 2e-2 x max(1, |ref|),
   the errors of o, dK, dV and dQ at the data's scale
   (``chip_smoke.scaled_errs``) against ``BF16_FWD_NORM_TOL`` /
   ``BF16_FWD_PEAK_TOL`` and ``BF16_BWD_NORM_TOL`` / ``BF16_BWD_PEAK_TOL``,
   and lse's absolute error against ``BF16_LSE_TOL``;
3. unless ``--quick``, at the main paths' shapes (or ``--shapes``), each
   build's device time of K1, K2 and K3 (``chip_smoke.device_ms``: medians
   of the kernels' own spans) and the host's time to launch each (the mean
   over calls queued behind a device sleep, the ctypes call included), in
   turns (baseline, tree, variants, ..., tree, baseline), with SDPA's
   forward and backward (dQ, dK, dV together) and the bounds (2, 4 and 3
   [T x T x D] products at the bf16 peak).

Each patch applies only inside the definition of the kernel it names, so
that a patch of one kernel cannot change another; a patch whose text is no
longer there stops the probe.  ``--deadline`` ends the process with code 3
after that many seconds: a kernel that never finishes cannot hold the card
longer.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2, 4096, 8, 40), (1, 4096, 1, 512), (8, 4096, 1, 512))
K1, K2, K3 = "flash_fwd_kernel", "flash_bwd_kv_kernel", "flash_bwd_q_kernel"
#: (variant, kernel) pairs that change only the D = 512 plan
WIDE_ONLY = {(v, k) for v in ("copies_only", "first_product_only", "second_product_only")
             for k in (K2, K3)}
#: bf16 ragged cases: T off every tile, B and H above 1, each compiled head dim
RAGGED = ((2, 300, 3, 40), (2, 333, 2, 64), (2, 150, 2, 80), (2, 70, 2, 512),
          (1, 100, 2, 40), (2, 200, 3, 64), (1, 130, 2, 80), (1, 1000, 1, 512))
#: the main paths' bf16 shapes (bn, xl1k, b1k)
MAIN = ((2, 4096, 8, 40), (2, 4096, 10, 64), (4, 4096, 10, 64), (8, 4096, 1, 512),
        (1, 4096, 1, 512), (1, 16384, 1, 512), (2, 16384, 1, 512))

MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
__global__ void __launch_bounds__(256) bench(float* out, int iters, uint32_t seed) {
  float c[8][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i) & 0xffffe000u;
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + seed * 1e-6f + i) & 0xffffe000u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sms * 2 * 256 * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int per_sm = 1; per_sm <= 2; ++per_sm) {
    const int grid = sms * per_sm, iters = 20000;
    bench<<<grid, 256>>>(out, 100, 1);
    cudaEventRecord(e0);
    bench<<<grid, 256>>>(out, iters, 2);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    printf("{\"mma_sync_tf32_tflops\": %.1f, \"warps_per_sm\": %d}\n",
           (double)grid * 8 * iters * 8 * 2048 / ms / 1e9, 8 * per_sm);
  }
  return 0;
}
"""


def variants() -> dict:
    """name -> {kernel: [(text in that kernel's definition, replacement), ...]}."""
    skip_products = ("} else {\n      wide_partials", "} else if (T_len < 0) {\n      wide_partials")
    accumulate = ("for (int kk = 0; kk < BR / 8; ++kk) {",
                  "for (int kk = 0; kk < BR / 8 && T_len < 0; ++kk) {")
    return {
        "as_built": {},
        "no_copies": {K1: [("if (i < n_tiles) {", "if (i < n_tiles && i < 2) {")],
                      K2: [("if (i < n_tiles) {", "if (i < n_tiles && i < 2) {")],
                      K3: [("if (i < n_tiles) {", "if (i < n_tiles && i < 2) {")]},
        "copies_only": {K1: [("fwd_wide_tile<P, T>(", "if (T_len < 0) fwd_wide_tile<P, T>("),
                             ("fwd_small_tile<P, T>(", "if (T_len < 0) fwd_small_tile<P, T>(")],
                        K2: [skip_products], K3: [skip_products]},
        "half_rows": {kern: [("copy_rows<T, D, LDT, BR, NT>(ring + s * 2 * TE",
                              "copy_rows<T, D, LDT, BR / 2, NT>(ring + s * 2 * TE")]
                      for kern in (K2, K3)},
        "first_product_only": {K2: [accumulate], K3: [accumulate]},
        "second_product_only": {
            K2: [("wide_partials<P, T, D>(sBuf, afr, cQ, cdO, warp, g, t);", "")],
            K3: [("wide_partials<P, T, D>(sBuf, afr, cK, cV, warp, g, t);", "")]},
    }


def patch(src: str, kernel: str, old: str, new: str) -> str:
    """Replace ``old`` by ``new`` inside the definition of ``kernel`` only."""
    start = src.index(f"\n{kernel}(")
    end = src.index("\n}\n", start)
    body = src[start:end]
    if old not in body:
        raise RuntimeError(f"{kernel}: {old!r} is not in its definition any more")
    return src[:start] + body.replace(old, new) + src[end:]


def patched(src: str, patches: dict) -> str:
    """``src`` with ``patches`` ({kernel: [(old, new), ...]}) applied."""
    for kernel, edits in patches.items():
        for old, new in edits:
            src = patch(src, kernel, old, new)
    return src


def build_all(lib_mod, sources: dict, out_dir: Path) -> dict:
    """Compile each source (name -> text) at once with the tree's flags;
    return name -> (library, compiler report)."""
    procs = {}
    for name, src in sources.items():
        (out_dir / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [lib_mod._nvcc(), *lib_mod.NVCC_FLAGS, "-shared", str(out_dir / f"{name}.cu"),
             "-o", str(out_dir / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} does not build:\n{stderr[-6000:]}")
        out[name] = (ctypes.CDLL(str(out_dir / f"{name}.so")), stdout + stderr)
    return out


def bind(lib, fa) -> dict:
    """kernel -> the library's C entry point of K1, K2 or K3."""
    fns = {}
    for kernel, entry in ((K1, fa.FLASH_FWD), (K2, fa.FLASH_BWD_KV), (K3, fa.FLASH_BWD_Q)):
        fn = getattr(lib, entry.symbol)
        fn.argtypes, fn.restype = entry.argtypes, ctypes.c_int
        fns[kernel] = fn
    return fns


def timed(variant: str, kernel: str, d: int) -> bool:
    """Whether ``variant`` changes ``kernel`` at head dim ``d`` (or is the build as it is)."""
    if variant == "as_built":
        return True
    return kernel in variants()[variant] and (d > 128 or (variant, kernel) not in WIDE_ONLY)


def f32_study(cs, _lib, fa, results: dict) -> bool:
    """The f32 study: the TF32 ``mma.sync`` rate, then K1-K3 and their variants."""
    import torch

    results.update(mma=[], shapes=[])
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "mma_bench.cu").write_text(MMA_BENCH)
        subprocess.run([_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                        str(tmp / "mma_bench"), str(tmp / "mma_bench.cu")], check=True)
        for line in subprocess.run([str(tmp / "mma_bench")], check=True, capture_output=True,
                                   text=True, timeout=300).stdout.splitlines():
            results["mma"].append(json.loads(line))
            print(line, flush=True)
        src0 = (_lib.CSRC / "flash_attention.cu").read_text()
        built = build_all(_lib, {name: patched(src0, patches)
                                 for name, patches in variants().items()}, tmp)
        fns = {name: bind(lib, fa) for name, (lib, _) in built.items()}
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        for shape in SHAPES:
            b, t, h, d = shape
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
            o_ref, lse_ref = fa.flash_fwd_reference(q, k, v)
            delta = (do * o_ref).sum(-1)
            dk_ref, dv_ref = fa.flash_bwd_kv_reference(q, k, v, do, lse_ref, delta)
            dq_ref = fa.flash_bwd_q_reference(q, k, v, do, lse_ref, delta)
            o, lse = torch.empty_like(q), torch.empty_like(lse_ref)
            dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
            ins = (q.data_ptr(), k.data_ptr(), v.data_ptr())
            stats = (do.data_ptr(), lse_ref.data_ptr(), delta.data_ptr())
            tail = (b, t, h, d, 0, d ** -0.5, stream)
            calls = {
                K1: lambda f: f(*ins, o.data_ptr(), lse.data_ptr(), *tail),
                K2: lambda f: f(*ins, *stats, dk.data_ptr(), dv.data_ptr(), *tail),
                K3: lambda f: f(*ins, *stats, dq.data_ptr(), *tail),
            }
            names = list(fns)
            times = {}
            for name in names + names[::-1]:
                for kernel, call in calls.items():
                    if not timed(name, kernel, d):
                        continue
                    run = lambda: call(fns[name][kernel])  # noqa: E731
                    if run() != 0:
                        raise RuntimeError(f"variant {name}: {kernel} did not launch at {shape}")
                    torch.cuda.synchronize()
                    reps = 3 if b * h >= 8 and d > 128 else 10
                    times.setdefault(name, {}).setdefault(kernel, []).append(cs.cuda_ms(run, reps))
                if name == "as_built":
                    err = max(cs.max_err(o, o_ref) / max(1.0, o_ref.abs().max().item()),
                              cs.max_err(lse, lse_ref) / max(1.0, lse_ref.abs().max().item()),
                              cs.max_err(dk, dk_ref) / max(1.0, dk_ref.abs().max().item()),
                              cs.max_err(dv, dv_ref) / max(1.0, dv_ref.abs().max().item()),
                              cs.max_err(dq, dq_ref) / max(1.0, dq_ref.abs().max().item()))
                    cs.require(err <= 1e-4, f"K1-K3 at {shape}: relative error {err:.2e}")
            key = {K1: "fwd", K2: "bwd_kv", K3: "bwd_q"}
            row = {"shape": list(shape), "dtype": "float32",
                   "ms": {n: {key[kern]: sum(ts) / len(ts) for kern, ts in per.items()}
                          for n, per in times.items()}}
            results["shapes"].append(row)
            print(json.dumps(row), flush=True)
    return True


def bf16_runner(fns: dict, fa):
    """(fwd, kv, q): K1, K2 and K3 of one build on [B, T, H, D] bf16 tensors."""
    import torch

    from tml_image_editing_defense_torch.ops._lib import stream_ptr

    def check(err, name):
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def fwd(q, k, v, *_):
        b, t, h, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((b, t, h), dtype=torch.float32, device=q.device)
        check(fns[K1](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                      b, t, h, d, 1, 1.0 / math.sqrt(d), stream_ptr(q)), "K1")
        return o, lse

    def kv(q, k, v, do, lse, delta):
        b, t, h, d = q.shape
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        check(fns[K2](q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, d, 1,
                      1.0 / math.sqrt(d), stream_ptr(q)), "K2")
        return dk, dv

    def q_(q, k, v, do, lse, delta):
        b, t, h, d = q.shape
        dq = torch.empty_like(q)
        check(fns[K3](q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), dq.data_ptr(), b, t, h, d, 1, 1.0 / math.sqrt(d),
                      stream_ptr(q)), "K3")
        return dq

    return fwd, kv, q_


def bf16_inputs(fa, shape, gen):
    import torch

    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_fwd_reference(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, lse, delta


def bf16_errors(cs, fa, runs: dict, args) -> dict:
    """Each build's errors of o, dK, dV and dQ against the plain versions:
    max abs error (and the limit with its floor), and at the data's scale;
    and lse's absolute error."""
    import torch

    o_ref, lse_ref = fa.flash_fwd_reference(*args[:3])
    dk_ref, dv_ref = fa.flash_bwd_kv_reference(*args)
    dq_ref = fa.flash_bwd_q_reference(*args)
    refs = {"o": o_ref, "dk": dk_ref, "dv": dv_ref, "dq": dq_ref}
    out = {}
    for name, (fwd, kv, q_) in runs.items():
        o, lse = fwd(*args)
        dk, dv = kv(*args)
        got = {"o": o, "dk": dk, "dv": dv, "dq": q_(*args)}
        torch.cuda.synchronize()
        row = {}
        for key, ref in refs.items():
            e = cs.scaled_errs(got[key], ref)
            floor_tol = 2e-2 * max(1.0, ref.float().abs().max().item())
            e.update(max_abs=cs.max_err(got[key], ref), ref_peak=ref.float().abs().max().item(),
                     floor_tol=floor_tol)
            e["floor_ok"] = e["max_abs"] <= floor_tol
            norm_tol, peak_tol = ((cs.BF16_FWD_NORM_TOL, cs.BF16_FWD_PEAK_TOL) if key == "o"
                                  else (cs.BF16_BWD_NORM_TOL, cs.BF16_BWD_PEAK_TOL))
            e["scaled_ok"] = e["norm"] <= norm_tol and e["peak"] <= peak_tol
            row[key] = e
        lse_err = cs.max_err(lse, lse_ref)
        row["lse"] = {"max_abs": lse_err, "floor_ok": lse_err <= 2e-2 * max(
                          1.0, o_ref.float().abs().max().item()),
                      "scaled_ok": lse_err <= cs.BF16_LSE_TOL}
        out[name] = row
    return out


def sdpa_fwd_ms(cs, args) -> float:
    import torch.nn.functional as F

    q, k, v = (x.transpose(1, 2).contiguous() for x in args[:3])
    return cs.cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 5)


def sdpa_bwd_ms(cs, args) -> float:
    import torch
    import torch.nn.functional as F

    q, k, v, do = (x.transpose(1, 2).contiguous() for x in args[:4])
    with torch.enable_grad():
        leaves = tuple(x.detach().requires_grad_(True) for x in (q, k, v))
        o = F.scaled_dot_product_attention(*leaves)
        return cs.cuda_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True), 5)


def host_us(cs, fn, calls: int = 50) -> float:
    """Mean host time of one call of ``fn``, the calls queued behind a device
    sleep so that none waits on the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(cs.HOLD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def bf16_study(cs, _lib, fa, args, results: dict) -> bool:
    """The bf16 study: the tree's K1, K2 and K3 against a baseline and variants."""
    import torch

    timed = (tuple(tuple(int(n) for n in sh.split(",")) for sh in args.shapes.split(";"))
             if args.shapes else MAIN)
    results.update(builds={}, checks=[], times=[])
    src = (_lib.CSRC / "flash_attention.cu").read_text()
    sources, patches = {}, {}
    if args.baseline_cu:
        sources["baseline"] = args.baseline_cu.read_text()
    for name, path in args.extra_cu:
        sources[name] = Path(path).read_text()
    for name, kernel, old, new in args.variant:
        patches.setdefault(name, {}).setdefault(kernel, []).append((old, new))
    sources.update({name: patched(src, p) for name, p in patches.items()})
    runs = {"tree": bf16_runner(bind(_lib.library(), fa), fa)}
    reports = {"tree": _lib.build_info.get("ptxas", "")}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (lib, report) in build_all(_lib, sources, Path(tmp)).items():
            runs[name], reports[name] = bf16_runner(bind(lib, fa), fa), report
        for name, report in reports.items():
            rows = [r for r in cs.ptxas_summary(report) if "bf16" in r[0]]
            # ptxas's notes on wgmma (a serialized pipeline costs its overlap)
            notes = sorted({ln.strip()[:400] for ln in report.splitlines()
                            if "wgmma" in ln.lower() and "Compiling" not in ln})
            results["builds"][name] = {"ptxas": rows, "wgmma_notes": notes}
            print(json.dumps({"build": name, "ptxas": rows, "wgmma_notes": notes}), flush=True)

        gen = torch.Generator(device="cuda").manual_seed(0)
        ok = True
        for shape in RAGGED + MAIN:
            a = bf16_inputs(fa, shape, gen)
            row = {"shape": list(shape), "err": bf16_errors(cs, fa, runs, a)}
            # the variants may be wrong on purpose: the tree and the baseline must agree
            ok &= all(e["floor_ok"] for name in ("tree", "baseline")
                      for e in row["err"].get(name, {}).values())
            ok &= all(e["scaled_ok"] for e in row["err"]["tree"].values())
            results["checks"].append(row)
            print(json.dumps(row), flush=True)
            del a
        if args.quick:
            return ok
        order = list(runs)
        for shape in timed:
            a = bf16_inputs(fa, shape, gen)
            b, t, h, d = shape
            mm = 2.0 * b * h * t * t * d
            keys = ("fwd", "bwd_kv", "bwd_q")
            row = {"shape": list(shape),
                   "device_ms": {n: {key: [] for key in keys} for n in order},
                   "host_us": {n: {key: [] for key in keys} for n in order},
                   "bound_ms": {"fwd": 2 * mm / cs.H100_BF16_FLOPS * 1e3,
                                "bwd_kv": 4 * mm / cs.H100_BF16_FLOPS * 1e3,
                                "bwd_q": 3 * mm / cs.H100_BF16_FLOPS * 1e3},
                   "sdpa_fwd_ms": sdpa_fwd_ms(cs, a), "sdpa_bwd_ms": sdpa_bwd_ms(cs, a)}
            for name in order + order[::-1]:
                fwd, kv, q_ = runs[name]
                for key, fn, kernel in (("fwd", lambda: fwd(*a), K1),
                                        ("bwd_kv", lambda: kv(*a), K2),
                                        ("bwd_q", lambda: q_(*a), K3)):
                    row["device_ms"][name][key].append(cs.device_ms(fn, (kernel,), 20)["ms"])
                    row["host_us"][name][key].append(host_us(cs, fn))
            results["times"].append(row)
            print(json.dumps(row), flush=True)
            del a
    return ok


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--bf16", action="store_true", help="study the bf16 K1, K2 and K3")
    parser.add_argument("--baseline-cu", type=Path, help="bf16: another flash_attention.cu")
    parser.add_argument("--extra-cu", nargs=2, action="append", default=[],
                        metavar=("NAME", "PATH"), help="bf16: one more flash_attention.cu")
    parser.add_argument("--variant", nargs=4, action="append", default=[],
                        metavar=("NAME", "KERNEL", "OLD", "NEW"),
                        help="bf16: the tree's source with OLD -> NEW in KERNEL's definition")
    parser.add_argument("--quick", action="store_true", help="bf16: check only, no times")
    parser.add_argument("--shapes", help="bf16: time these shapes only: B,T,H,D;B,T,H,D...")
    parser.add_argument("--deadline", type=float, default=0.0, help="exit 3 after this many s")
    parser.add_argument("--report", type=Path, help="also write the results here as JSON")
    args = parser.parse_args(argv)
    if args.deadline:
        def stop():
            print(json.dumps({"deadline_s": args.deadline, "stopped": True}), flush=True)
            os._exit(3)
        timer = threading.Timer(args.deadline, stop)
        timer.daemon = True
        timer.start()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("probe_flash_cuda: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tml_image_editing_defense_torch.ops import _lib
    from tml_image_editing_defense_torch.ops import flash_attention as fa

    results = {"card": cs.card_line()}
    print(json.dumps({"card": results["card"]}), flush=True)
    study = (lambda: bf16_study(cs, _lib, fa, args, results)) if args.bf16 else (
        lambda: f32_study(cs, _lib, fa, results))
    results["ok"] = ok = study()
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(results, indent=1))
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
