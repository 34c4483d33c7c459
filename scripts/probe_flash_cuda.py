#!/usr/bin/env python3
"""Where the time of the flash-attention kernels K1 (forward), K2 (dK, dV)
and K3 (dQ) goes, on one NVIDIA card.

Run from the repository root on a machine with the card and nvcc:

    python3 scripts/probe_flash_cuda.py [--report PATH]

It prints, as JSON lines:

1. the card's name and power limit;
2. the rate of ``mma.sync.m16n8k8`` in TF32 from a loop of independent
   products (eight warps a block, one block per SM, and two): the ceiling
   of the instruction that K1, K2 and K3 are built on;
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

Each variant is a list of text patches, each applied only inside the
definition of the kernel it names, so that a patch of one kernel cannot
change another; a patch whose text is no longer there stops the probe.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2, 4096, 8, 40), (1, 4096, 1, 512), (8, 4096, 1, 512))
K1, K2, K3 = "flash_fwd_kernel", "flash_bwd_kv_kernel", "flash_bwd_q_kernel"
#: (variant, kernel) pairs that change only the D = 512 plan
WIDE_ONLY = {(v, k) for v in ("copies_only", "first_product_only", "second_product_only")
             for k in (K2, K3)}

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


def build_all(lib_mod, fa, out_dir: Path) -> dict:
    """Compile every variant at once; return name -> {kernel: C entry point}."""
    src0 = (lib_mod.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, patches in variants().items():
        src = src0
        for kernel, edits in patches.items():
            for old, new in edits:
                src = patch(src, kernel, old, new)
        (out_dir / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [lib_mod._nvcc(), *lib_mod.NVCC_FLAGS, "-shared", str(out_dir / f"{name}.cu"),
             "-o", str(out_dir / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build:\n{err[-4000:]}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        fns[name] = {}
        for kernel, entry in ((K1, fa.FLASH_FWD), (K2, fa.FLASH_BWD_KV), (K3, fa.FLASH_BWD_Q)):
            fn = getattr(lib, entry.symbol)
            fn.argtypes, fn.restype = entry.argtypes, ctypes.c_int
            fns[name][kernel] = fn
    return fns


def timed(variant: str, kernel: str, d: int) -> bool:
    """Whether ``variant`` changes ``kernel`` at head dim ``d`` (or is the build as it is)."""
    if variant == "as_built":
        return True
    return kernel in variants()[variant] and (d > 128 or (variant, kernel) not in WIDE_ONLY)


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", type=Path, help="also write the results here as JSON")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("probe_flash_cuda: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tml_image_editing_defense_torch.ops import _lib
    from tml_image_editing_defense_torch.ops import flash_attention as fa

    results = {"card": cs.card_line(), "mma": [], "shapes": []}
    print(json.dumps({"card": results["card"]}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "mma_bench.cu").write_text(MMA_BENCH)
        subprocess.run([_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                        str(tmp / "mma_bench"), str(tmp / "mma_bench.cu")], check=True)
        for line in subprocess.run([str(tmp / "mma_bench")], check=True, capture_output=True,
                                   text=True, timeout=300).stdout.splitlines():
            results["mma"].append(json.loads(line))
            print(line, flush=True)
        fns = build_all(_lib, fa, tmp)
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
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
