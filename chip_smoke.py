#!/usr/bin/env python3
"""Chip check of the PyTorch port (``tml_image_editing_defense_torch``) on
one NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: name and power limit, torch / CUDA versions, f32 numerics;
2. build the CUDA kernels from ``tml_image_editing_defense_torch/csrc`` with
   nvcc for sm_90a (the build seconds and each kernel's registers/spills);
3. hold every kernel against its plain PyTorch version on the card at the
   main path's shapes -- flash attention K1 (forward), K2 (dK, dV), K3 (dQ)
   at [2, 4096, 8, 40] (UNet 64x64 level) and [1, 4096, 1, 512] (VAE
   mid-block) in f32 and bf16, the L2 PGD update K4 at [1, 3, 512, 512]
   with and without a 0/1 mask -- with each one's time, the plain version's,
   a single PyTorch call's where one computes the same function, and the
   least time the card could take (the bound);
4. the main path: ``api.immunize`` with the ``TrainConfig`` defaults (SD-1.5
   at 512x512, f32, L2 eps 32, 10 EOT reps, LCM K=4 -> 2 steps) for 3
   iterations, random weights made on the card from the seed, synthetic
   source and target images; the loss must stay finite, the perturbation in
   the eps-ball, the artifacts written, and every kernel launched the
   number of times the port's code implies; then one more iteration on the
   same draws through the kernels and through plain attention with the
   plain update, which must agree; then one under ``torch.profiler``: device
   time by kernel and by group, and the device's idle share;
5. a JSON line naming every kernel with its launches, error and times,
   then the card's name and power limit, then the result line.

``--report PATH`` also writes the full report there as JSON.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_F32_FLOPS = 67e12          # CUDA-core f32, dense (NVIDIA H100 SXM data sheet)
H100_BF16_FLOPS = 989e12        # tensor-core bf16, dense
H100_BYTES_PER_S = 3.35e12      # HBM3
UNET_SHAPE, VAE_SHAPE, IMAGE_SHAPE = (2, 4096, 8, 40), (1, 4096, 1, 512), (1, 3, 512, 512)
ITERATIONS = 3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float, peak: float):
    """The least time for the work: the larger of operations over the peak
    rate and bytes over the memory rate; and which one it is."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def require(cond: bool, what) -> None:
    if not cond:
        raise AssertionError(what)


def ptxas_summary(report: str) -> list:
    """[kernel, registers, spill bytes] per compiled entry, from -Xptxas -v
    (for each entry ptxas prints its name, then its spills, then its registers)."""
    rows, name, spill = [], None, 0
    for line in report.splitlines():
        if "Compiling entry function" in line:
            mangled, name, spill = line.split("'")[1], None, 0
            for tag in ("flash_fwd_kernel", "flash_bwd_kv_kernel", "flash_bwd_q_kernel",
                        "pgd_l2_kernel"):
                if tag in mangled:
                    name = f"{tag}<{mangled.split(tag)[1][1:40]}>"
        elif "bytes spill stores" in line:
            nums = [int(tok) for tok in line.replace(",", " ").split() if tok.isdigit()]
            spill = sum(nums[1:3])
        elif "Used" in line and "registers" in line and name:
            rows.append([name, int(line.split("Used")[1].split("registers")[0]), spill])
    return rows


def check_flash(fa, shape, dtype, gen, times: bool) -> dict:
    """K1, K2, K3 against the plain versions on the card at one shape."""
    import torch
    import torch.nn.functional as F

    b, t, h, d = shape
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v)
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_reference(q, k, v, o_ref, lse_ref, do)
    delta = (do.float() * o_ref.float()).sum(-1)
    o, lse = fa.flash_fwd(q, k, v)
    dk, dv = fa.flash_bwd_kv(q, k, v, do, lse_ref, delta)
    dq = fa.flash_bwd_q(q, k, v, do, lse_ref, delta)
    torch.cuda.synchronize()
    # f32: sums in another order, ~1e-6 seen; bf16: one rounding of the output
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    errs = {
        "fwd": max(max_err(o, o_ref), max_err(lse, lse_ref)),
        "bwd_kv": max(max_err(dk, dk_ref), max_err(dv, dv_ref)),
        "bwd_q": max_err(dq, dq_ref),
    }
    tols = {
        "fwd": rel * max(1.0, o_ref.float().abs().max().item()),
        "bwd_kv": rel * max(1.0, dk_ref.float().abs().max().item(), dv_ref.float().abs().max().item()),
        "bwd_q": rel * max(1.0, dq_ref.float().abs().max().item()),
    }
    out = {"shape": list(shape), "dtype": str(dtype).split(".")[-1], "err": errs, "tol": tols}
    for name in errs:
        if not errs[name] <= tols[name]:
            raise AssertionError(f"flash {name} {shape} {dtype}: max abs err {errs[name]:.3e} "
                                 f"over tolerance {tols[name]:.3e}")
    if not times:
        return out
    item = q.element_size()
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    mm = 2.0 * b * h * t * t * d                          # one [T x T x D] product
    tensor = b * t * h * d * item
    stats = b * t * h * 4
    reps = 5
    out["ms"] = {
        "fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v), reps),
        "bwd_kv": cuda_ms(lambda: fa.flash_bwd_kv(q, k, v, do, lse_ref, delta), reps),
        "bwd_q": cuda_ms(lambda: fa.flash_bwd_q(q, k, v, do, lse_ref, delta), reps),
    }
    out["plain_ms"] = {
        "fwd": cuda_ms(lambda: fa.flash_fwd_reference(q, k, v), reps),
        "bwd_kv": cuda_ms(lambda: fa.flash_bwd_kv_reference(q, k, v, do, lse_ref, delta), reps),
        "bwd_q": cuda_ms(lambda: fa.flash_bwd_q_reference(q, k, v, do, lse_ref, delta), reps),
    }
    out["bound"] = {
        "fwd": bound_ms(2 * mm, 4 * tensor + stats, peak),
        "bwd_kv": bound_ms(4 * mm, 6 * tensor + 2 * stats, peak),
        "bwd_q": bound_ms(3 * mm, 5 * tensor + 2 * stats, peak),
    }
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    out["library_ms"] = {"fwd": cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)}

    def sdpa_fwd_bwd():
        a, b_, c = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        torch.autograd.grad(F.scaled_dot_product_attention(a, b_, c), (a, b_, c), dot)

    def flash_fwd_bwd():
        o2, l2 = fa.flash_fwd(q, k, v)
        fa.flash_bwd(q, k, v, o2, l2, do)

    with torch.enable_grad():
        out["library_ms"]["fwd_bwd"] = cuda_ms(sdpa_fwd_bwd, reps)
    out["ms"]["fwd_bwd"] = cuda_ms(flash_fwd_bwd, reps)
    return out


def check_pgd(pk, gen, mask: bool) -> dict:
    import torch

    x = torch.randn(IMAGE_SHAPE, generator=gen, device="cuda") * 0.3
    g = torch.randn(IMAGE_SHAPE, generator=gen, device="cuda")
    src = (torch.randn(IMAGE_SHAPE, generator=gen, device="cuda") * 0.4).clamp(-1, 1)
    m = (torch.rand((1, 1, 512, 512), generator=gen, device="cuda") > 0.5).float() if mask else None
    args = (x, g, src, 7.5, 32.0, -1.0, 1.0)
    got = pk.pgd_l2_update(*args, mask=m)
    want = pk.l2_perturbation_step(*args, m)
    torch.cuda.synchronize()
    err, tol = max_err(got, want), 1e-5
    if not err <= tol:
        raise AssertionError(f"pgd_l2_update mask={mask}: max abs err {err:.3e} over {tol:.0e}")
    n = x.numel()
    nbytes = 4 * n * 4 + (m.numel() * 4 if mask else 0)
    return {"mask": mask, "err": err, "tol": tol,
            "ms": cuda_ms(lambda: pk.pgd_l2_update(*args, mask=m), 20),
            "plain_ms": cuda_ms(lambda: pk.l2_perturbation_step(*args, m), 20),
            "bound": bound_ms(15.0 * n, nbytes, H100_F32_FLOPS)}


def one_iteration_inputs(model, cfg, source, target):
    """What one PGD iteration of the main path takes, drawn as immunize draws
    its first iteration: (sampler, plan, data, draws)."""
    import torch

    from tml_image_editing_defense_torch.attack.pgd import (
        iteration_generator,
        make_attack_data,
        sample_draws,
    )
    from tml_image_editing_defense_torch.configs import format_prompt
    from tml_image_editing_defense_torch.core.samplers import make_sampler

    sampler = make_sampler("lcm", model.schedule)
    plan = sampler.plan(cfg.n_denoising_steps_per_iteration, limit_t=700)
    bank = model.embed_prompt_bank([format_prompt(p) for p in cfg.prompts])
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    pool = torch.randn((1, *model.latent_shape), generator=gen, device="cuda")
    data = make_attack_data(model, cfg, source, target, bank, pool)
    draws = sample_draws(iteration_generator(cfg.seed, 0, "cuda"), cfg, len(cfg.prompts), 1,
                         model.latent_shape, plan.num_steps)
    return sampler, plan, data, draws


def check_iteration_against_plain(model, cfg, inputs, layers) -> dict:
    """One PGD iteration at full width on the same draws twice: through the
    kernels, and through plain attention with the plain update.  The
    iterates and the losses must agree (f32 on both sides; they differ in
    the order of the attention sums only)."""
    import dataclasses

    from tml_image_editing_defense_torch.attack.pgd import make_pgd_step

    sampler, plan, data, draws = inputs
    x_k, aux_k = make_pgd_step(model, sampler, plan, cfg, decode_vis=False)(data.source, data,
                                                                            draws)
    floor = layers.MIN_CHUNKED_SEQ
    layers.MIN_CHUNKED_SEQ = 1 << 30            # every attention on the plain path
    try:
        plain_cfg = dataclasses.replace(cfg, use_pallas_update=False)
        x_p, aux_p = make_pgd_step(model, sampler, plan, plain_cfg, decode_vis=False)(
            data.source, data, draws)
    finally:
        layers.MIN_CHUNKED_SEQ = floor
    out = {"x_adv_max_abs_diff": max_err(x_k, x_p),
           "avg_loss_rel_diff": abs(aux_k["avg_loss"].item() - aux_p["avg_loss"].item())
           / abs(aux_p["avg_loss"].item())}
    require(out["x_adv_max_abs_diff"] <= 1e-3 and out["avg_loss_rel_diff"] <= 1e-4,
            f"one PGD iteration through the kernels vs plain: {out}")
    return out


def kernel_group(name: str) -> str:
    n = name.lower()
    if "flash_" in n:
        return "flash attention K1-K3"
    if "pgd_l2" in n:
        return "L2 update K4"
    # cuDNN's FFT algorithms run complex (float2 / cf32) gemm and gemv kernels
    if any(s in n for s in ("conv", "dgrad", "fprop", "wgrad", "implicit", "winograd", "fft",
                            "cf32", "float2")):
        return "convolution (cuDNN)"
    if any(s in n for s in ("gemm", "cutlass", "xmma", "cublas")):
        return "matmul (cuBLAS)"
    if "norm" in n:
        return "group/layer norm"
    return "elementwise and other"


def profile_iteration(model, cfg, inputs) -> dict:
    """One PGD iteration under torch.profiler, after one warm-up: device
    time by kernel and by group, and the share of the iteration's wall time
    in which the device ran no kernel (the profiler's own overhead
    lengthens the wall time, so that share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tml_image_editing_defense_torch.attack.pgd import make_pgd_step

    sampler, plan, data, draws = inputs
    source = data.source
    step = make_pgd_step(model, sampler, plan, cfg, decode_vis=False)
    step(source, data, draws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(source, data, draws)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device events by (name, start): the profiler may list one more than once
    spans = {(e.name, e.time_range.start): e.time_range.end for e in prof.events()
             if str(e.device_type).endswith("CUDA")}
    kernels, busy_us, reach = {}, 0.0, float("-inf")
    for (name, start), end in sorted(spans.items(), key=lambda kv: kv[0][1]):
        kernels[name] = kernels.get(name, 0.0) + (end - start) / 1e3
        busy_us += max(0.0, end - max(start, reach))       # union of the spans
        reach = max(reach, end)
    device_ms = busy_us / 1e3
    groups = {}
    for name, ms in kernels.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_s * 1e3, "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / (wall_s * 1e3)),
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": top}


def synthetic_image(path: Path, seed: int) -> None:
    """A smooth random RGB image (no file from outside the repository)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:600, 0:640] / 64.0
    arr = np.stack([np.sin(xx * rng.uniform(0.5, 2)) * np.cos(yy * rng.uniform(0.5, 2))
                    for _ in range(3)], -1)
    arr = arr + 0.3 * rng.standard_normal(arr.shape)
    Image.fromarray(np.uint8(np.clip((arr + 1.5) / 3.0, 0, 1) * 255)).save(path)


def main(argv) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", type=Path, help="write the full report here as JSON")
    report_path = parser.parse_args(argv).report

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tml_image_editing_defense_torch import api
    from tml_image_editing_defense_torch.configs import TrainConfig
    from tml_image_editing_defense_torch.core.image_ops import load_image
    from tml_image_editing_defense_torch.models import layers
    from tml_image_editing_defense_torch.ops import _lib
    from tml_image_editing_defense_torch.ops import flash_attention as fa
    from tml_image_editing_defense_torch.ops import pgd_kernels as pk
    from tml_image_editing_defense_torch.utils.device import numerics_summary, set_numerics

    report = {}
    card = card_line()
    set_numerics("float32")
    print(f"[card] {card}; {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; numerics {numerics_summary()}", flush=True)

    t0 = time.perf_counter()
    _lib.library()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = ptxas_summary(_lib.build_info.get("ptxas", ""))
    print(f"[build] kernels built and loaded in {report['build_s']:.1f} s "
          f"(nvcc {_lib.build_info.get('seconds', 0.0):.1f} s)", flush=True)
    for name, regs, spill in report["ptxas"]:
        print(f"[build]   {name}: {regs} registers, {spill} bytes spilled")

    gen = torch.Generator(device="cuda").manual_seed(0)
    flash = {}
    for shape in (UNET_SHAPE, VAE_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            r = check_flash(fa, shape, dtype, gen, times=True)
            flash[f"{shape}-{r['dtype']}"] = r
            print(f"[kernels] flash {shape} {r['dtype']}: max abs err "
                  + ", ".join(f"{k} {r['err'][k]:.2e} (tol {r['tol'][k]:.1e})" for k in r["err"])
                  + "; ms " + ", ".join(f"{k} {v:.3f}" for k, v in r["ms"].items())
                  + "; plain ms " + ", ".join(f"{k} {v:.3f}" for k, v in r["plain_ms"].items())
                  + "; bound ms " + ", ".join(f"{k} {v[0]:.3f} ({v[1]})" for k, v in r["bound"].items())
                  + "; sdpa ms " + ", ".join(f"{k} {v:.3f}" for k, v in r["library_ms"].items()),
                  flush=True)
    for shape in ((1, 100, 2, 40), (2, 200, 3, 64), (1, 130, 2, 80), (1, 70, 1, 512)):
        check_flash(fa, shape, torch.float32, gen, times=False)    # ragged tails, every head dim
    print("[kernels] flash ragged-tail shapes (T = 70..200, D = 40/64/80/512) agree", flush=True)
    pgd = [check_pgd(pk, gen, mask) for mask in (False, True)]
    for r in pgd:
        print(f"[kernels] pgd_l2_update {IMAGE_SHAPE} mask={r['mask']}: max abs err "
              f"{r['err']:.2e} (tol {r['tol']:.0e}); ms {r['ms']:.4f}; plain ms "
              f"{r['plain_ms']:.4f}; bound ms {r['bound'][0]:.4f} ({r['bound'][1]})", flush=True)
    report["flash"], report["pgd"] = flash, pgd

    # ---- the main path ------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        synthetic_image(tmp / "source.png", 1)
        synthetic_image(tmp / "target.png", 2)
        cfg = TrainConfig(source_image_path=tmp / "source.png",
                          target_image_path=tmp / "target.png",
                          output_path=tmp / "out", n_optimization_steps=ITERATIONS)
        kernels = fa.KERNELS + pk.KERNELS
        for kern in kernels:
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = api.immunize(cfg)              # on the card: the default device
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {kern.symbol: kern.launches for kern in kernels}

        # Launches the port's code implies for this run.  Per PGD iteration:
        # the shared encode (1 VAE mid-block attention, forward + backward)
        # and 10 reps x (2 UNet calls x 5 long self-attentions at the 64x64
        # level + 1 VAE decode mid-block), each forward + backward: 111
        # forwards, 111 of each backward kernel, 1 update.  Outside the
        # iterations: the target encode (1 forward) and the vis decodes at
        # iterations 0 and n-1 (1 forward each).
        n_vis = len({0, ITERATIONS - 1})
        per_it = cfg.grad_reps * (2 * 5 + 1) + 1
        expected = {"tid_flash_fwd": ITERATIONS * per_it + 1 + n_vis,
                    "tid_flash_bwd_kv": ITERATIONS * per_it,
                    "tid_flash_bwd_q": ITERATIONS * per_it,
                    "tid_pgd_l2_update": ITERATIONS}
        require(launches == expected, (launches, expected))

        src = torch.from_numpy(load_image(cfg.source_image_path, cfg.image_size)).cuda()
        tgt = torch.from_numpy(load_image(cfg.target_image_path, cfg.image_size)).cuda()
        dist = torch.linalg.vector_norm(result.x_adv - src).item()
        require(dist <= cfg.eps + 1e-3, f"|x_adv - src| = {dist} over eps")
        require(-1.0 <= result.x_adv.min().item() and result.x_adv.max().item() <= 1.0,
                "x_adv left [-1, 1]")
        require(len(result.history) == ITERATIONS, result.history)
        for h in result.history:
            require(all(math.isfinite(v) for v in h.values()), h)
        out = cfg.output_path
        for name in ("adversarial_image.png", "noise.npz", "metrics.jsonl"):
            require((out / name).is_file(), f"missing artifact {name}")
        rows = {r["step"]: r for r in map(json.loads, (out / "metrics.jsonl").read_text().splitlines())}
        require(sorted(rows) == list(range(ITERATIONS)), rows)
        # rows of vis iterations (0 and n-1) carry the host clock; between them
        # lie n-1 iterations and one vis decode
        s_per_it = (rows[ITERATIONS - 1]["t"] - rows[0]["t"]) / (ITERATIONS - 1)
        report["main_path"] = {
            "wall_s": wall, "s_per_iteration_after_first": s_per_it,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "history": result.history, "l2_dist": dist, "launches": launches,
            "expected_launches": expected,
        }
    print(f"[main] immunize sd15 512x512 f32, {ITERATIONS} iterations x {cfg.grad_reps} reps: "
          f"{wall:.1f} s in all, {s_per_it:.2f} s/iteration after the first, peak "
          f"{report['main_path']['max_memory_allocated_gb']:.1f} GB; losses "
          f"{[round(h['avg_loss'], 4) for h in result.history]}; |x_adv - src| = {dist:.3f} "
          f"<= {cfg.eps}; launches {launches}", flush=True)

    # one more iteration through the kernels and through plain attention;
    # then where one iteration's device time goes (after the main path's counts)
    inputs = one_iteration_inputs(result.model, cfg, src, tgt)
    report["iteration_vs_plain"] = check_iteration_against_plain(result.model, cfg, inputs, layers)
    print(f"[model] one SD-1.5 512x512 PGD iteration, kernels vs plain attention and plain "
          f"update: {report['iteration_vs_plain']}", flush=True)
    prof = report["profile"] = profile_iteration(result.model, cfg, inputs)
    print(f"[profile] one PGD iteration: wall {prof['wall_ms']:.0f} ms, device busy "
          f"{prof['device_ms']:.0f} ms, idle share <= {prof['idle_share']:.3f}; by group (ms) "
          + ", ".join(f"{g} {ms:.0f}" for g, ms in prof["groups_ms"].items()), flush=True)
    for name, ms in prof["top_kernels_ms"]:
        print(f"[profile]   {ms:9.1f} ms  {name[:110]}")

    unet_f32 = flash[f"{UNET_SHAPE}-float32"]
    src_fa = "tml_image_editing_defense_torch/csrc/flash_attention.cu"
    tpu_fa = "tml_image_editing_defense_tpu/ops/flash_attention.py"
    rows = []
    for name, sym, key, line in (("flash_fwd", "tid_flash_fwd", "fwd", 69),
                                 ("flash_bwd_kv", "tid_flash_bwd_kv", "bwd_kv", 148),
                                 ("flash_bwd_q", "tid_flash_bwd_q", "bwd_q", 185)):
        rows.append({
            "name": name, "route": "cuda", "source": src_fa, "replaces": f"{tpu_fa}:{line}",
            "launches": launches[sym], "max_abs_err": unet_f32["err"][key],
            "ms": unet_f32["ms"][key], "plain_ms": unet_f32["plain_ms"][key],
            "bound_ms": unet_f32["bound"][key][0], "bound_by": unet_f32["bound"][key][1],
            "library_ms": unet_f32["library_ms"]["fwd"] if key == "fwd" else None,
            "shape": list(UNET_SHAPE), "dtype": "float32", "ok": True,
        })
    r = pgd[0]
    rows.append({
        "name": "pgd_l2_update", "route": "cuda",
        "source": "tml_image_editing_defense_torch/csrc/pgd_update.cu",
        "replaces": "tml_image_editing_defense_tpu/ops/pgd_kernels.py:118",
        "launches": launches["tid_pgd_l2_update"], "max_abs_err": r["err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": None, "shape": list(IMAGE_SHAPE), "dtype": "float32", "ok": True,
    })
    report["kernels"] = rows
    if report_path is not None:
        report_path.parent.mkdir(parents=True, exist_ok=True)
        report_path.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
