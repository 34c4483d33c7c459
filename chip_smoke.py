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
   main paths' shapes -- flash attention K1 (forward), K2 (dK, dV), K3 (dQ)
   at [2, 4096, 8, 40] (UNet 64x64 level) and [1, 4096, 1, 512] (VAE
   mid-block) in f32 and bf16, and at [8, 4096, 1, 512] (the encoder
   attack's batched VAE mid-block) in f32; K1-K3 at ragged T (70..1000)
   at every compiled head dim (40, 64, 80, 512: every tile plan of K2/K3)
   in f32 and bf16, and K1-K3's refusal of a misaligned tensor; the L2 PGD
   update K4 at [1, 3, 512, 512] with and without a 0/1 mask; the L-inf PGD
   update K5 at [1, 3, 512, 512] and [8, 3, 512, 512] in f32 (bit-equal)
   and bf16 (within 4e-3), at a ragged size and on a misaligned view --
   with each one's time, the plain version's, a single PyTorch call's where
   one computes the same function (SDPA's forward for K1, SDPA's backward
   for K2 and K3 together), and the least time the card could take (the
   bound; f32 attention at the 3xTF32 rate, 495/3 TFLOP/s);
4. the diffusion path: ``api.immunize`` with the ``TrainConfig`` defaults
   (SD-1.5 at 512x512, f32, L2 eps 32, 10 EOT reps, LCM K=4 -> 2 steps) for
   3 iterations, random weights made on the card from the seed, synthetic
   source and target images; the loss must stay finite, the perturbation in
   the eps-ball, the artifacts written, and every kernel launched the
   number of times the port's code implies; then one more iteration on the
   same draws through the kernels and through plain attention with the
   plain update, which must agree; then one under ``torch.profiler``: device
   time by kernel and by group, and the device's idle share;
5. the inpaint path: ``api.immunize`` with ``attack_mode="inpaint"`` and
   the L-inf preset (SD-1.5-inpaint at 512x512, f32, eps 0.1, step 0.006,
   5 reps, 100 < t < 800 -> 3 steps) for 3 iterations, with the same checks
   (the ball is the L-inf ball); then one more iteration through the kernels
   and through plain attention with the plain update, held by the sign
   rule (a gradient element near 0 may take the other sign); then one under
   ``torch.profiler``;
6. the encoder attack at SD-1.5 512x512, batch 8, L-inf (step 0.006, eps
   0.1), stochastic encode, 5 steps: finite losses, the ball, s/step, peak
   memory and the launches the code implies;
7. a JSON line naming every kernel with its launches, error and times,
   then the card's name and power limit, then the result line.

``--report PATH`` also writes the full report there as JSON.
"""

from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_F32_FLOPS = 67e12          # CUDA-core f32, dense (NVIDIA H100 SXM data sheet)
#: f32-exact products on the tensor cores: three TF32 passes ("3xTF32") of
#: the 495 TFLOP/s dense TF32 rate.  The attention kernels' f32 bound: the
#: card can compute their products in f32 this fast, and K2/K3 do.
H100_TF32X3_FLOPS = 495e12 / 3
H100_BF16_FLOPS = 989e12        # tensor-core bf16, dense
H100_BYTES_PER_S = 3.35e12      # HBM3
UNET_SHAPE, VAE_SHAPE, IMAGE_SHAPE = (2, 4096, 8, 40), (1, 4096, 1, 512), (1, 3, 512, 512)
ENC_BATCH = 8
ENC_ATTN_SHAPE, ENC_IMAGE_SHAPE = (ENC_BATCH, 4096, 1, 512), (ENC_BATCH, 3, 512, 512)
ITERATIONS = 3          # of each immunize path
ENC_STEPS = 5           # of the encoder attack
#: long self-attentions per SD-1.5 UNet call: the 64x64 level's transformers,
#: 2 in its down block and 3 in its up block
UNET_LONG_ATTN = 5
LINF = dict(step_size=0.006, eps=0.1, min_value=-1.0, max_value=1.0)


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
                        "pgd_l2_kernel", "pgd_linf_kernel"):
                if tag in mangled:
                    rest = mangled.split(tag)[1]
                    m = re.match(r"I(f|13__nv_bfloat16)((?:Li\d+E)*)E", rest)
                    args = ([{"f": "f32"}.get(m[1], "bf16")] + re.findall(r"Li(\d+)E", m[2])
                            if m else [rest[1:40]])
                    name = f"{tag}<{', '.join(args)}>"
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
    peak = H100_TF32X3_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
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
    out["peak_tflops"] = peak / 1e12
    out["ms"]["bwd"] = out["ms"]["bwd_kv"] + out["ms"]["bwd_q"]
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    out["library_ms"] = {"fwd": cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)}
    with torch.enable_grad():
        # SDPA's backward alone (dQ, dK, dV together: K2 + K3's work)
        leaves = tuple(x.detach().requires_grad_(True) for x in (qt, kt, vt))
        o_sdpa = F.scaled_dot_product_attention(*leaves)
        out["library_ms"]["bwd"] = cuda_ms(
            lambda: torch.autograd.grad(o_sdpa, leaves, dot, retain_graph=True), reps)
        del o_sdpa, leaves

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


def check_flash_refuses_misaligned(fa) -> None:
    """K1, K2 and K3 copy rows in 16-byte chunks: a tensor that starts off a
    16-byte boundary is refused, not read wrong."""
    import torch

    shape = (1, 64, 1, 40)
    bad = torch.zeros(math.prod(shape) + 1, device="cuda")[1:].view(shape)
    good = torch.zeros(shape, device="cuda")
    stats = torch.zeros(shape[:3], device="cuda")
    require(bad.data_ptr() % 16 != 0, "the misaligned view is aligned")
    calls = ((fa.flash_fwd, (good, good, bad)),
             (fa.flash_bwd_kv, (good, good, good, bad, stats, stats)),
             (fa.flash_bwd_q, (good, good, good, bad, stats, stats)))
    for fn, args in calls:
        try:
            fn(*args)
        except ValueError:
            continue
        raise AssertionError(f"{fn.__name__} took a tensor off a 16-byte boundary")


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


def check_linf(pk, gen, shape, dtype, times: bool, misaligned: bool = False,
               nan: bool = False) -> dict:
    """K5 against its plain version: bit-equal in f32, within 4e-3 (one bf16
    ulp on [-1, 1]) in bf16.  5 % of the gradient is exactly 0 (sign(0) = 0
    must leave x as it is); ``misaligned`` puts every operand 1 element past
    a 16-byte boundary (the kernel's scalar path); ``nan`` puts NaN in x."""
    import torch

    n = math.prod(shape)
    x = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
    g = torch.randn(shape, generator=gen, device="cuda")
    g = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.05, 0.0, g)
    src = (x + (torch.rand(shape, generator=gen, device="cuda") * 0.2 - 0.1)).clamp(-1, 1)
    if nan:
        x.view(-1)[:: 97] = float("nan")
    x, g, src = (t.to(dtype) for t in (x, g, src))
    if misaligned:
        def shifted(t):
            buf = torch.empty(n + 1, dtype=dtype, device="cuda")
            buf[1:].copy_(t.reshape(-1))
            return buf[1:].view(shape)
        x, g, src = shifted(x), shifted(g), shifted(src)
        require(x.data_ptr() % 16 != 0, "the misaligned view is aligned")
    args = (x, g, src, *LINF.values())
    got = pk.pgd_linf_update(*args)
    want = pk.linf_perturbation_step(*args)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    tol = 0.0 if f32 else 4e-3
    fin = torch.isfinite(want)
    require(torch.equal(torch.isnan(got), torch.isnan(want)), f"pgd_linf_update {shape}: NaNs differ")
    err = max_err(got[fin], want[fin])
    what = f"pgd_linf_update {shape} {dtype} misaligned={misaligned}"
    require(err <= tol, f"{what}: max abs err {err:.3e} over {tol:.0e}")
    if f32:
        zero = (g == 0) & fin
        require(torch.equal(got[zero], x[zero]), f"{what}: a zero gradient moved x")
    out = {"shape": list(shape), "dtype": str(dtype).split(".")[-1], "misaligned": misaligned,
           "nan": nan, "err": err, "tol": tol}
    if times:
        item = x.element_size()
        out.update(ms=cuda_ms(lambda: pk.pgd_linf_update(*args), 50),
                   plain_ms=cuda_ms(lambda: pk.linf_perturbation_step(*args), 50),
                   # ~9 operations per element; 3 reads and 1 write
                   bound=bound_ms(9.0 * n, 4.0 * n * item,
                                  H100_F32_FLOPS if f32 else H100_BF16_FLOPS))
    return out


def one_iteration_inputs(model, cfg, source, target):
    """What one PGD iteration of an immunize path takes, drawn as immunize
    draws its first iteration: (sampler, plan, data, draws)."""
    import torch

    from tml_image_editing_defense_torch.attack.inpaint import sample_inpaint_draws
    from tml_image_editing_defense_torch.attack.pgd import (
        iteration_generator,
        make_attack_data,
        sample_draws,
    )
    from tml_image_editing_defense_torch.configs import format_prompt
    from tml_image_editing_defense_torch.core.samplers import make_sampler

    dev = source.device
    sampler = make_sampler("lcm", model.schedule)
    gen0 = iteration_generator(cfg.seed, 0, dev)
    k = cfg.n_denoising_steps_per_iteration
    if cfg.attack_mode == "inpaint":
        plan = sampler.plan(k, limit_t=800, min_t=101)
        draws = sample_inpaint_draws(gen0, cfg, len(cfg.prompts), model.latent_shape,
                                     plan.num_steps)
    else:
        plan = sampler.plan(k, limit_t=700)
        draws = sample_draws(gen0, cfg, len(cfg.prompts), 1, model.latent_shape, plan.num_steps)
    bank = model.embed_prompt_bank([format_prompt(p) for p in cfg.prompts])
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    pool = torch.randn((1, *model.latent_shape), generator=gen, device=dev)
    data = make_attack_data(model, cfg, source, target, bank, pool)
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


def check_inpaint_iteration_against_plain(model, cfg, inputs, layers, pk) -> dict:
    """One inpaint iteration at full width on the same draws twice: the EOT
    gradient through the kernels then K5, and through plain attention then
    the plain update (the step is exactly that composition).  The sign step
    is discontinuous at 0, so: the gradients agree to 2e-4 of their largest
    element, avg_loss to a relative 1e-4, K5 and the plain update give equal
    bits on one and the same gradient, and the iterates agree wherever
    |g| > 1e-3 max|g|; elements that differ lie where |g| is below that and
    are at most 0.1 % of the image."""
    import torch

    from tml_image_editing_defense_torch.attack.inpaint import make_inpaint_eot_grad

    sampler, plan, data, draws = inputs
    eot = make_inpaint_eot_grad(model, sampler, plan, cfg)
    g_k, aux_k = eot(data.source, data, draws)
    x_k = pk.pgd_linf_update(data.source, g_k.contiguous(), data.source, *LINF.values())
    floor = layers.MIN_CHUNKED_SEQ
    layers.MIN_CHUNKED_SEQ = 1 << 30            # every attention on the plain path
    try:
        g_p, aux_p = eot(data.source, data, draws)
    finally:
        layers.MIN_CHUNKED_SEQ = floor
    x_p = pk.linf_perturbation_step(data.source, g_p, data.source, *LINF.values())
    same_grad = torch.equal(pk.pgd_linf_update(data.source, g_p.contiguous(), data.source,
                                               *LINF.values()), x_p)
    scale = g_p.abs().max().item()
    off = (x_k - x_p).abs() > 1e-6
    sure = g_p.abs() > 1e-3 * scale
    out = {"grad_max_abs_diff_over_max": max_err(g_k, g_p) / scale,
           "avg_loss_rel_diff": abs(aux_k["avg_loss"].item() - aux_p["avg_loss"].item())
           / abs(aux_p["avg_loss"].item()),
           "update_bit_equal_on_one_gradient": same_grad,
           "elements_off": int(off.sum()), "elements_off_where_g_large": int((off & sure).sum()),
           "share_with_small_g": (~sure).float().mean().item(), "elements": off.numel()}
    require(out["grad_max_abs_diff_over_max"] <= 2e-4 and out["avg_loss_rel_diff"] <= 1e-4
            and same_grad and out["elements_off_where_g_large"] == 0
            and out["elements_off"] <= 1e-3 * off.numel(),
            f"one inpaint iteration through the kernels vs plain: {out}")
    return out


def kernel_group(name: str) -> str:
    n = name.lower()
    if "flash_" in n:
        return "flash attention K1-K3"
    if "pgd_l2" in n:
        return "L2 update K4"
    if "pgd_linf" in n:
        return "L∞ update K5"
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
    """One PGD iteration of ``cfg``'s path under torch.profiler, after one
    warm-up: device time by kernel and by group, and the share of the
    iteration's wall time in which the device ran no kernel (the profiler's
    own overhead lengthens the wall time, so that share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tml_image_editing_defense_torch.attack.inpaint import make_inpaint_pgd_step
    from tml_image_editing_defense_torch.attack.pgd import make_pgd_step

    sampler, plan, data, draws = inputs
    source = data.source
    if cfg.attack_mode == "inpaint":
        step = make_inpaint_pgd_step(model, sampler, plan, cfg)
    else:
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


def immunize_path(api, cfg, kernels, per_iteration: dict, outside: dict) -> dict:
    """``api.immunize(cfg)`` on the card with every count set to 0 just
    before it and read just after; the launches must be those the code
    implies: ``per_iteration`` times the iterations plus ``outside``."""
    import torch

    from tml_image_editing_defense_torch.core.image_ops import load_image

    for kern in kernels:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = api.immunize(cfg)              # on the card: the default device
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kern.symbol: kern.launches for kern in kernels}
    n = cfg.n_optimization_steps
    expected = {kern.symbol: n * per_iteration.get(kern.symbol, 0) + outside.get(kern.symbol, 0)
                for kern in kernels}
    require(launches == expected, (cfg.attack_mode, launches, expected))

    src = torch.from_numpy(load_image(cfg.source_image_path, cfg.image_size)).cuda()
    tgt = torch.from_numpy(load_image(cfg.target_image_path, cfg.image_size)).cuda()
    if cfg.norm_type == "l2":
        dist = torch.linalg.vector_norm(result.x_adv - src).item()
        require(dist <= cfg.eps + 1e-3, f"|x_adv - src|_2 = {dist} over eps")
    else:
        dist = (result.x_adv - src).abs().max().item()
        require(dist <= cfg.eps + 1e-6, f"|x_adv - src|_inf = {dist} over eps")
    require(-1.0 <= result.x_adv.min().item() and result.x_adv.max().item() <= 1.0,
            "x_adv left [-1, 1]")
    require(len(result.history) == n, result.history)
    for h in result.history:
        require(all(math.isfinite(v) for v in h.values()), h)
    out = cfg.output_path
    for name in ("adversarial_image.png", "noise.npz", "metrics.jsonl"):
        require((out / name).is_file(), f"missing artifact {name}")
    rows = {r["step"]: r for r in map(json.loads, (out / "metrics.jsonl").read_text().splitlines())}
    require(sorted(rows) == list(range(n)), rows)
    # rows of vis iterations (0 and n-1) carry the host clock; between them
    # lie n-1 iterations and one vis decode
    return {"wall_s": wall, "s_per_iteration_after_first": (rows[n - 1]["t"] - rows[0]["t"]) / (n - 1),
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "history": result.history, "dist": dist, "launches": launches,
            "expected_launches": expected, "_result": result, "_src": src, "_tgt": tgt}


def encoder_path(kernels, images) -> dict:
    """The encoder attack on SD-1.5 at the images' size (512x512,
    batch 8), L-inf, stochastic encode, ENC_STEPS steps, after a one-step
    warm-up; counts set to 0 just before the target encode and read just
    after the loop."""
    import torch

    from tml_image_editing_defense_torch.attack.encoder_attack import (
        make_encoder_attack_loop,
        make_encoder_attack_step,
    )
    from tml_image_editing_defense_torch.models.model_zoo import build_model

    src, tgt = images
    gen = torch.Generator(device=src.device).manual_seed(0)
    model = build_model("sd15", image_size=src.shape[-1], device=src.device, generator=gen,
                        attn_kv_chunk=512)
    noise = torch.randn((ENC_STEPS + 1, len(src), *model.latent_shape[1:]), generator=gen,
                        device=src.device)
    with torch.no_grad():
        warm_target = model.encode_image(tgt)
    make_encoder_attack_step(model, norm_type="linf", step_size=0.006, eps=0.1)(
        src, src, warm_target, noise[ENC_STEPS])
    del warm_target
    loop = make_encoder_attack_loop(model, ENC_STEPS, norm_type="linf", step_size=0.006,
                                    eps=0.1)
    torch.cuda.synchronize()
    for kern in kernels:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        target_latent = model.encode_image(tgt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, losses = loop(src, target_latent, noise[:ENC_STEPS])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {kern.symbol: kern.launches for kern in kernels}
    # one batched VAE mid-block attention per step (forward + backward) and
    # the target encode's forward; one L-inf update per step
    expected = {kern.symbol: 0 for kern in kernels}
    expected.update(tid_flash_fwd=ENC_STEPS + 1, tid_flash_bwd_kv=ENC_STEPS,
                    tid_flash_bwd_q=ENC_STEPS, tid_pgd_linf_update=ENC_STEPS)
    require(launches == expected, ("encoder", launches, expected))
    require(bool(torch.isfinite(losses).all()), f"encoder losses {losses}")
    dist = (x - src).abs().max().item()
    require(dist <= 0.1 + 1e-6, f"encoder |x_adv - src|_inf = {dist} over eps")
    require(-1.0 <= x.min().item() and x.max().item() <= 1.0, "encoder x_adv left [-1, 1]")
    return {"s_per_step": loop_s / ENC_STEPS, "loop_s": loop_s,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": losses.tolist(), "dist": dist, "launches": launches,
            "expected_launches": expected}


def load_batch(paths, size):
    import numpy as np
    import torch

    from tml_image_editing_defense_torch.core.image_ops import load_image

    return torch.from_numpy(np.concatenate([load_image(p, size) for p in paths])).cuda()


def print_profile(tag: str, prof: dict) -> None:
    print(f"[profile] one {tag} iteration: wall {prof['wall_ms']:.0f} ms, device busy "
          f"{prof['device_ms']:.0f} ms, idle share <= {prof['idle_share']:.3f}; by group (ms) "
          + ", ".join(f"{g} {ms:.0f}" for g, ms in prof["groups_ms"].items()), flush=True)
    for name, ms in prof["top_kernels_ms"]:
        print(f"[profile]   {ms:9.1f} ms  {name[:110]}")


def free_card() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


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
    from tml_image_editing_defense_torch.core.samplers import LCMSampler
    from tml_image_editing_defense_torch.core.schedule import make_noise_schedule
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
    for shape, dtypes in ((UNET_SHAPE, (torch.float32, torch.bfloat16)),
                          (VAE_SHAPE, (torch.float32, torch.bfloat16)),
                          (ENC_ATTN_SHAPE, (torch.float32,))):
        for dtype in dtypes:
            r = check_flash(fa, shape, dtype, gen, times=True)
            flash[f"{shape}-{r['dtype']}"] = r
            print(f"[kernels] flash {shape} {r['dtype']}: max abs err "
                  + ", ".join(f"{k} {r['err'][k]:.2e} (tol {r['tol'][k]:.1e})" for k in r["err"])
                  + "; ms " + ", ".join(f"{k} {v:.3f}" for k, v in r["ms"].items())
                  + "; plain ms " + ", ".join(f"{k} {v:.3f}" for k, v in r["plain_ms"].items())
                  + f"; bound ms at {r['peak_tflops']:.0f} TFLOP/s "
                  + ", ".join(f"{k} {v[0]:.3f} ({v[1]})" for k, v in r["bound"].items())
                  + "; sdpa ms " + ", ".join(f"{k} {v:.3f}" for k, v in r["library_ms"].items())
                  + f"; K1 {r['ms']['fwd']:.3f} ms against SDPA's forward "
                  f"{r['library_ms']['fwd']:.3f} ms ({r['ms']['fwd'] / r['library_ms']['fwd']:.2f}x)"
                  + f"; K2+K3 {r['ms']['bwd']:.3f} ms against SDPA's backward "
                  f"{r['library_ms']['bwd']:.3f} ms ({r['ms']['bwd'] / r['library_ms']['bwd']:.2f}x)",
                  flush=True)
    # ragged tails at every compiled head dim (every tile plan of K2/K3), f32 and bf16
    for shape in ((1, 100, 2, 40), (2, 200, 3, 64), (1, 130, 2, 80), (1, 70, 1, 512),
                  (1, 1000, 2, 40), (1, 1000, 2, 64), (1, 1000, 2, 80), (1, 1000, 1, 512)):
        for dtype in (torch.float32, torch.bfloat16):
            check_flash(fa, shape, dtype, gen, times=False)
    check_flash_refuses_misaligned(fa)
    print("[kernels] flash ragged-tail shapes (T = 70..1000, D = 40/64/80/512, f32 and bf16) "
          "agree; K1-K3 refuse a misaligned tensor", flush=True)
    pgd = [check_pgd(pk, gen, mask) for mask in (False, True)]
    for r in pgd:
        print(f"[kernels] pgd_l2_update {IMAGE_SHAPE} mask={r['mask']}: max abs err "
              f"{r['err']:.2e} (tol {r['tol']:.0e}); ms {r['ms']:.4f}; plain ms "
              f"{r['plain_ms']:.4f}; bound ms {r['bound'][0]:.4f} ({r['bound'][1]})", flush=True)
    linf = {}
    for shape in (IMAGE_SHAPE, ENC_IMAGE_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            r = linf[f"{shape}-{str(dtype).split('.')[-1]}"] = check_linf(pk, gen, shape, dtype,
                                                                          times=True)
            print(f"[kernels] pgd_linf_update {shape} {r['dtype']}: max abs err {r['err']:.2e} "
                  f"(tol {r['tol']:.0e}); ms {r['ms']:.4f}; plain ms {r['plain_ms']:.4f}; "
                  f"bound ms {r['bound'][0]:.4f} ({r['bound'][1]})", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        check_linf(pk, gen, (1, 3, 33, 35), dtype, times=False, nan=True)
        check_linf(pk, gen, IMAGE_SHAPE, dtype, times=False, misaligned=True)
        check_linf(pk, gen, (1, 3, 33, 35), dtype, times=False, misaligned=True)
    print("[kernels] pgd_linf_update ragged [1, 3, 33, 35] with NaN in x, and misaligned views, "
          "agree (f32 bit-equal, bf16 within 4e-3)", flush=True)
    report["flash"], report["pgd"], report["linf"] = flash, pgd, linf

    kernels = fa.KERNELS + pk.KERNELS
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for i in range(1, 3 + 2 * ENC_BATCH):
            synthetic_image(tmp / f"image{i}.png", i)
        source, target = tmp / "image1.png", tmp / "image2.png"

        # ---- the diffusion path -------------------------------------------
        # Per PGD iteration: the shared encode (1 VAE mid-block attention,
        # forward + backward) and 10 reps x (2 UNet calls x 5 long
        # self-attentions at the 64x64 level + 1 VAE decode mid-block), each
        # forward + backward: 111 forwards, 111 of each backward kernel, 1
        # update.  Outside the iterations: the target encode (1 forward) and
        # the vis decodes at iterations 0 and n-1 (1 forward each).
        cfg = TrainConfig(source_image_path=source, target_image_path=target,
                          output_path=tmp / "out", n_optimization_steps=ITERATIONS)
        n_vis = len({0, ITERATIONS - 1})
        per_it = cfg.grad_reps * (2 * UNET_LONG_ATTN + 1) + 1
        diff = immunize_path(
            api, cfg, kernels,
            {"tid_flash_fwd": per_it, "tid_flash_bwd_kv": per_it, "tid_flash_bwd_q": per_it,
             "tid_pgd_l2_update": 1},
            {"tid_flash_fwd": 1 + n_vis})
        result, src, tgt = diff.pop("_result"), diff.pop("_src"), diff.pop("_tgt")
        report["main_path"] = diff
        print(f"[main] immunize sd15 512x512 f32, {ITERATIONS} iterations x {cfg.grad_reps} reps: "
              f"{diff['wall_s']:.1f} s in all, {diff['s_per_iteration_after_first']:.2f} "
              f"s/iteration after the first, peak {diff['max_memory_allocated_gb']:.1f} GB; losses "
              f"{[round(h['avg_loss'], 4) for h in diff['history']]}; |x_adv - src|_2 = "
              f"{diff['dist']:.3f} <= {cfg.eps}; launches {diff['launches']}", flush=True)

        # one more iteration through the kernels and through plain attention;
        # then where one iteration's device time goes (after the path's counts)
        inputs = one_iteration_inputs(result.model, cfg, src, tgt)
        report["iteration_vs_plain"] = check_iteration_against_plain(result.model, cfg, inputs,
                                                                     layers)
        print(f"[model] one SD-1.5 512x512 PGD iteration, kernels vs plain attention and plain "
              f"update: {report['iteration_vs_plain']}", flush=True)
        report["profile"] = profile_iteration(result.model, cfg, inputs)
        print_profile("PGD", report["profile"])
        del result, inputs
        free_card()

        # ---- the inpaint path ---------------------------------------------
        # Per iteration: 5 reps x (1 encode + 3 UNet calls x 5 long
        # self-attentions + 1 decode), each forward + backward (every rep
        # encodes the image itself), and 1 L-inf update.  Outside: the target
        # encode and the 2 vis decodes (forwards).
        icfg = TrainConfig(source_image_path=source, target_image_path=target,
                           output_path=tmp / "out_inpaint", n_optimization_steps=ITERATIONS,
                           attack_mode="inpaint", norm_type="linf")
        n_unet = LCMSampler(make_noise_schedule()).plan(
            icfg.n_denoising_steps_per_iteration, limit_t=800, min_t=101).num_steps
        per_it = icfg.grad_reps * (1 + n_unet * UNET_LONG_ATTN + 1)
        inpaint = immunize_path(
            api, icfg, kernels,
            {"tid_flash_fwd": per_it, "tid_flash_bwd_kv": per_it, "tid_flash_bwd_q": per_it,
             "tid_pgd_linf_update": 1},
            {"tid_flash_fwd": 1 + n_vis})
        result = inpaint.pop("_result")
        inpaint.pop("_src"), inpaint.pop("_tgt")
        report["inpaint_path"] = inpaint
        print(f"[inpaint] immunize sd15-inpaint 512x512 f32 L-inf, {ITERATIONS} iterations x "
              f"{icfg.grad_reps} reps x {n_unet} UNet steps: {inpaint['wall_s']:.1f} s in all, "
              f"{inpaint['s_per_iteration_after_first']:.2f} s/iteration after the first, peak "
              f"{inpaint['max_memory_allocated_gb']:.1f} GB; losses "
              f"{[round(h['avg_loss'], 4) for h in inpaint['history']]}; |x_adv - src|_inf = "
              f"{inpaint['dist']:.4f} <= {icfg.eps}; launches {inpaint['launches']}", flush=True)
        inputs = one_iteration_inputs(result.model, icfg, src, tgt)
        report["inpaint_vs_plain"] = check_inpaint_iteration_against_plain(
            result.model, icfg, inputs, layers, pk)
        print(f"[model] one SD-1.5-inpaint 512x512 L-inf iteration, kernels vs plain attention "
              f"and plain update: {report['inpaint_vs_plain']}", flush=True)
        report["inpaint_profile"] = profile_iteration(result.model, icfg, inputs)
        print_profile("inpaint", report["inpaint_profile"])
        del result, inputs, src, tgt
        free_card()

        # ---- the encoder attack -------------------------------------------
        images = (load_batch([tmp / f"image{i}.png" for i in range(3, 3 + ENC_BATCH)], 512),
                  load_batch([tmp / f"image{i}.png"
                              for i in range(3 + ENC_BATCH, 3 + 2 * ENC_BATCH)], 512))
        enc = report["encoder_path"] = encoder_path(kernels, images)
        print(f"[encoder] encoder attack sd15 512x512 f32 L-inf, batch {ENC_BATCH}, {ENC_STEPS} "
              f"steps: {enc['s_per_step']:.3f} s/step, peak {enc['max_memory_allocated_gb']:.1f} "
              f"GB; losses {[round(v, 4) for v in enc['losses']]}; |x_adv - src|_inf = "
              f"{enc['dist']:.4f} <= 0.1; launches {enc['launches']}", flush=True)
        del images
        free_card()

    report["kernels"] = rows = kernel_rows(flash, pgd, linf, report)
    if report_path is not None:
        report_path.parent.mkdir(parents=True, exist_ok=True)
        report_path.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def kernel_rows(flash, pgd, linf, report) -> list:
    """One row per kernel and shape for the result's kernels line; each row's
    ``launches`` is the count of the path named by ``path``, read just after
    that path ran."""
    src_fa = "tml_image_editing_defense_torch/csrc/flash_attention.cu"
    tpu_fa = "tml_image_editing_defense_tpu/ops/flash_attention.py"
    src_pgd = "tml_image_editing_defense_torch/csrc/pgd_update.cu"
    tpu_pgd = "tml_image_editing_defense_tpu/ops/pgd_kernels.py"
    launches = {"diffusion": report["main_path"]["launches"],
                "inpaint": report["inpaint_path"]["launches"],
                "encoder": report["encoder_path"]["launches"]}
    rows = []
    for path, shape in (("diffusion", UNET_SHAPE), ("inpaint", UNET_SHAPE),
                        ("encoder", ENC_ATTN_SHAPE)):
        r = flash[f"{shape}-float32"]
        for name, sym, key, line in (("flash_fwd", "tid_flash_fwd", "fwd", 69),
                                     ("flash_bwd_kv", "tid_flash_bwd_kv", "bwd_kv", 148),
                                     ("flash_bwd_q", "tid_flash_bwd_q", "bwd_q", 185)):
            rows.append({
                "name": name, "route": "cuda", "source": src_fa, "replaces": f"{tpu_fa}:{line}",
                "launches": launches[path][sym], "max_abs_err": r["err"][key],
                "ms": r["ms"][key], "plain_ms": r["plain_ms"][key],
                "bound_ms": r["bound"][key][0], "bound_by": r["bound"][key][1],
                "library_ms": r["library_ms"]["fwd" if key == "fwd" else "bwd"],
                "library_call": ("scaled_dot_product_attention forward" if key == "fwd" else
                                 "scaled_dot_product_attention backward: K2 and K3 together"),
                "path": path, "shape": list(shape), "dtype": "float32", "ok": True,
            })
    r = pgd[0]
    rows.append({
        "name": "pgd_l2_update", "route": "cuda", "source": src_pgd, "replaces": f"{tpu_pgd}:118",
        "launches": launches["diffusion"]["tid_pgd_l2_update"], "max_abs_err": r["err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
        "bound_by": r["bound"][1], "library_ms": None, "path": "diffusion",
        "shape": list(IMAGE_SHAPE), "dtype": "float32", "ok": True,
    })
    for path, shape in (("inpaint", IMAGE_SHAPE), ("encoder", ENC_IMAGE_SHAPE)):
        r = linf[f"{shape}-float32"]
        rows.append({
            "name": "pgd_linf_update", "route": "cuda", "source": src_pgd,
            "replaces": f"{tpu_pgd}:64", "launches": launches[path]["tid_pgd_linf_update"],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": None,
            "path": path, "shape": list(shape), "dtype": "float32", "ok": True,
        })
    return rows


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
