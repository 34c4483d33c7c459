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
   mid-block) in f32 and bf16, at [8, 4096, 1, 512] (the encoder
   attack's batched VAE mid-block) in f32, at the evaluation's
   [8, 4096, 8, 40] and [4, 4096, 1, 512], at the SDXL evaluation's
   [4, 4096, 10, 64] and [2, 16384, 1, 512] and at the SDXL universal
   attack's [2, 4096, 10, 64] and [1, 16384, 1, 512] in f32 and bf16 (the
   bf16 SDXL 1024x1024 immunize's shapes); K1-K3 at ragged T (70..1000)
   at every compiled head dim (40, 64, 80, 512: every tile plan of K2/K3)
   in f32 and bf16, and K1-K3's refusal of a misaligned tensor; the L2 PGD
   update K4 at [1, 3, 512, 512] with and without a 0/1 mask, at
   [8, 3, 512, 512] (per-sample norms) and in bf16 (within one bf16 ulp;
   also at [1, 3, 1024, 1024]),
   at a ragged [2, 3, 33, 35], on misaligned views, on the eps-ball with
   the step outward and inward, with a zero gradient and an all-zero mask,
   two calls always bit-equal; the L-inf PGD update K5 at [1, 3, 512, 512]
   and [8, 3, 512, 512] in f32 (bit-equal) and bf16 (within 4e-3), at a
   ragged size and on a misaligned view -- with each one's time, the plain
   version's, a single PyTorch call's where one computes the same function
   (SDPA's forward for K1, with the backend it took, SDPA's backward for K2
   and K3 together), and the
   least time the card could take (the bound; f32 attention at the 3xTF32
   rate, 495/3 TFLOP/s; bf16 at 989).  Times are CUDA-event means over
   back-to-back calls from the host and, apart from host time, medians of
   the kernels' own spans in torch.profiler (K4 and K5 with the operands in
   L2 and after a 128 MB write evicts them);
4. the diffusion path: ``api.immunize`` with the ``TrainConfig`` defaults
   (SD-1.5 at 512x512, f32, L2 eps 32, 10 EOT reps, LCM K=4 -> 2 steps) for
   3 iterations, random weights made on the card from the seed, synthetic
   source and target images; the loss must stay finite, the perturbation in
   the eps-ball, the artifacts written, and every kernel launched the
   number of times the port's code implies; then one more iteration on the
   same draws through the kernels and through plain attention with the
   plain update, which must agree; then one under ``torch.profiler``: device
   time by kernel and by group, and the device's idle share; the useful
   model FLOPs of an iteration (``utils/flops.py``) and their share of the
   f32 peak (likewise for the inpaint and SDXL paths); then the first
   iteration on the same draws with ``remat_policy="full", remat_vae=True``
   and with ``eot_chunk=2``, each against the defaults (x_adv within 1e-3:
   the math is the same), with both one's seconds and peak;
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
7. resume: the diffusion path again for 2 iterations with
   ``checkpoint_interval=1`` (the last save, after the second iteration),
   then ``api.immunize`` with ``resume_from`` that state on the same model,
   which runs the third iteration only: its x_adv within 1e-3 of the
   uninterrupted run's (cuDNN's convolution gradients are not
   deterministic, so not bit for bit), its launches those of one
   iteration, and its seconds;
8. the evaluate gate: one (clean, adv) pair through ``Img2ImgPipeline``
   with K1, and on the same model with plain attention (the flash path's
   length floor raised out of reach), a 10-step PLMS plan at strength 0.6,
   the same draws: the images in [0, 1] finite and within 1e-3;
9. the masked path (m): a random RMBG-1.4 ISNet at its published widths
   built on the card from a seed, written to ``model.safetensors`` by this
   script's own writer, loaded back by ``load_rmbg_checkpoint``; its
   forward at [1, 3, 1024, 1024] timed (CUDA events) beside its conv FLOPs
   over the f32 peak, ``salient_mask`` at 512x512 timed, the mask's
   foreground share (neither none nor all); then ``api.immunize`` with
   ``use_segmentation_mask=True`` and ``segmentation_model_path`` that
   directory on the diffusion path's model at the ``TrainConfig`` defaults
   for 3 iterations: the mask it used equal, bit for bit, to ISNet's on the
   cropped source and unlike the heuristic's, K4's masked entry launched
   once an iteration and its unmasked entry never, x_adv equal to the source outside the mask after every
   iteration and moved inside it, the diffusion path's checks and launch
   counts, ISNet dropped before the loop; then one iteration through the
   kernels and through plain attention with the plain masked update
   (within 1e-3 and 1e-4, both at the source outside the mask);
10. evaluate: ``cli.main(["evaluate", ...])`` on the diffusion path's
   ``adversarial_image.png`` and ``noise.npz`` at the ``InferenceConfig``
   defaults (SD-1.5 at 512x512, f32, PLMS with 100 steps at strength 0.6:
   61 UNet calls an edit, guidance 7.5), two of ``INFERENCE_PROMPTS`` and
   one synthetic validation image: 4 cells in 2 batches of 2 pairs, K1 at
   [8, 4096, 8, 40] (UNet) and [4, 4096, 1, 512] (VAE), held against its
   plain version and timed at both shapes in phase 3; the grids written,
   seconds per batch and per pair, peak memory and K1's launches; then one
   batch of 2 pairs under ``torch.profiler``;
11. the SDXL path: ``api.immunize`` with ``use_sdxl=True`` at the
   ``TrainConfig`` defaults otherwise (SDXL at 512x512, f32, L2, 10 reps,
   LCM K=4 -> 2 steps) for 3 iterations, with the diffusion path's checks;
   at 512x512 every UNet attention is short (T <= 1024) and plain, so K1-K3
   run the VAE's mid-block only.  Then one iteration through the kernels
   and through plain attention with the plain update, one under
   ``torch.profiler``, and the SDXL evaluate gate on the same weights at
   1024x1024: one (clean, adv) pair, Euler 10 steps at strength 0.6, K1
   against plain attention within 1e-3;
12. SDXL evaluate: ``cli.main(["evaluate", "--use-sdxl", "true",
   "--image-size", "1024", ...])`` at the ``InferenceConfig`` defaults
   (Euler, SDXL without LCM: 100 steps at strength 0.6, guidance 7.5, f32),
   one prompt, n_noise 1, no validation images: one cell, its edits one
   after another (batch_edits is off at 1024x1024), on a synthetic
   1024x1024 source and an adversarial PNG made from it with a seeded
   perturbation inside the L2 ball; K1 at [4, 4096, 10, 64] (UNet) and
   [2, 16384, 1, 512] (VAE), held and timed at both shapes in phase 3;
13. the universal attack: ``universal_attack.main([...])`` at its defaults
   (SD-1.5 at 512x512, f32, the TAESD preview at full width, 4 reps, eps
   0.1, step 0.006, remat "none") over 3 synthetic images for 5 steps in 2
   epochs, a validation collage every 2 steps; the losses finite, every
   step's perturbation in the eps box with its image in [-1, 1] and moved by
   at most step_size in L2 from the previous one re-anchored to that image,
   the artifacts written (``perturbation.npy`` NHWC), K1-K3 launched as the
   code implies; then one step on the same draws through the kernels and
   through plain attention, with the TAESD decode and with the full VAE
   decode (the updates within a relative 1e-2 and 1e-3 in L2, the losses
   within 1e-4; :func:`universal_gate` says why two bounds), one step under
   ``torch.profiler``, and the TAESD decode's forward and backward timed
   against the full VAE decode's;
14. the universal attack on SDXL at its native 1024x1024 with remat
   "full" for 2 steps, with the same checks (every forward runs twice, so
   K1 launches twice per attention), then one step under ``torch.profiler``;
   after each path, once its objects are dropped, at most HELD_LIMIT_GB may
   stay allocated on the card (a model left alive is 4.3 GB for SD-1.5 and
   13.9 GB for SDXL), and each path's peak is counted above what was
   allocated when it began;
15. SDXL immunize at its native 1024x1024 in bf16 (xl1k): ``api.immunize``
   with ``TrainConfig(use_sdxl=True, image_size=1024, dtype="bfloat16",
   remat_policy="full", remat_vae=True)`` (the JAX package's configuration,
   scripts/probe_sdxl_1024.py:134-140; 10 reps, LCM K=4 -> 2 UNet steps)
   for 2 iterations, s/iteration from the second, with the diffusion
   path's checks, K1-K4 launched as ``pgd_launches`` predicts from the UNet
   config, the VAE mid-blocks and the remat recompute; one iteration under
   ``torch.profiler``; its useful FLOPs and their share of the bf16 peak;
   then the kernels against plain attention on one f32 iteration of 1 rep
   at 1024x1024 with the same remat (within 1e-3 and 1e-4);
16. a JSON line naming every kernel with its launches on every path, error
   and times, then the card's name and power limit, then the result line.

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
from typing import Optional

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
#: evaluate: api.evaluate's eval_batch_size, 2 cells of (clean, adv) x CFG
#: through the UNet and (clean, adv) x cells through the VAE
EVAL_BATCH = 2
EVAL_UNET_SHAPE, EVAL_VAE_SHAPE = (4 * EVAL_BATCH, 4096, 8, 40), (2 * EVAL_BATCH, 4096, 1, 512)
EVAL_PROMPTS = 2        # the first two of INFERENCE_PROMPTS
#: SDXL is trained at 512x512 (the reference's dataset transform) and
#: evaluated at its native 1024x1024, one cell at a time; there K1 runs the
#: UNet's 64x64 level (2 images x CFG, 10 heads of 64) and the VAE
#: mid-block (128x128 tokens, the 2 images)
SDXL_EVAL_SIZE = 1024
SDXL_EVAL_UNET_SHAPE, SDXL_EVAL_VAE_SHAPE = (4, 4096, 10, 64), (2, 16384, 1, 512)
#: the universal attack (universal_attack.main at its defaults: 4 reps, eps
#: 0.1, step 0.006, the TAESD preview): SD-1.5 at 512x512 for UNIVERSAL_STEPS
#: steps over UNIVERSAL_IMAGES images with a validation every
#: UNIVERSAL_VIS_EVERY steps (K1-K3 at UNET_SHAPE and VAE_SHAPE); then SDXL
#: at its native 1024x1024 with remat "full" for UNIVERSAL_SDXL_STEPS steps,
#: where K1-K3 run the UNet's 64x64 level (the CFG pair, 10 heads of 64) and
#: the VAE encoder's mid-block (128x128 tokens)
UNIVERSAL_STEPS, UNIVERSAL_VIS_EVERY, UNIVERSAL_IMAGES, UNIVERSAL_SDXL_STEPS = 5, 2, 3, 2
UX_UNET_SHAPE, UX_VAE_SHAPE = (2, 4096, 10, 64), (1, 16384, 1, 512)
#: SDXL immunize at its native 1024x1024 in bf16 (xl1k, the JAX package's
#: scripts/probe_sdxl_1024.py configuration): remat "full" with remat_vae,
#: 10 reps, 2 iterations; K1-K3 in bf16 at the universal-sdxl shapes (the
#: UNet's 64x64 level for the CFG pair, the VAE mid-block), K4 in bf16 at
#: the 1024x1024 image
XL1K_SIZE, XL1K_ITERATIONS, XL1K_IMAGE_SHAPE = 1024, 2, (1, 3, 1024, 1024)
LINF = dict(step_size=0.006, eps=0.1, min_value=-1.0, max_value=1.0)
L2 = dict(step_size=7.5, eps=32.0, min_value=-1.0, max_value=1.0)     # the TrainConfig defaults
#: a write this large between two timed calls leaves none of their operands
#: in the 50 MB L2
COLD_BYTES = 128 << 20
#: device clock cycles (about 25 ms) that hold the device while the host
#: launches the calls ``device_ms`` times
HOLD_CYCLES = 50_000_000
#: K4 runs one kernel where its grid fits on the card at once, else two
K4_KERNELS = ("pgd_l2_resident_kernel", "pgd_l2_partials_kernel", "pgd_l2_write_kernel")
K5_KERNELS = ("pgd_linf_kernel",)
#: what may stay allocated on the card once a path's objects are dropped
HELD_LIMIT_GB = 1.0
#: seconds since the script started at the end of each phase
STARTED = time.perf_counter()
PHASE_END_S: dict = {}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up, by
    CUDA events (``utils.profiling.StepTimer``)."""
    from tml_image_editing_defense_torch.utils.profiling import StepTimer

    timer = StepTimer("cuda")
    with timer:
        fn()
    with timer:
        for _ in range(reps):
            fn()
    return timer.last * 1e3 / reps


def profile_events(prof) -> list:
    """(on the device, start us, end us, name) of every event of a finished
    torch.profiler run, from its raw records: building its Python events
    (``prof.events()``) took minutes for the CPU operators of an SDXL
    iteration."""
    events = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)     # whole ns, before the float
    return [(str(e.device_type()).endswith("CUDA"), (e.start_ns() - base) / 1e3,
             (e.end_ns() - base) / 1e3, e.name()) for e in events]


def device_ms(fn, kernels, reps: int = 50, cold: bool = False) -> dict:
    """Device time of one call of ``fn`` from torch.profiler's kernel spans,
    host time left out.  The kernels of a call are those whose names hold
    one of ``kernels``, in launch order; every call must run the same ones.
    Over ``reps`` calls after one warm-up: the median span from the start
    of a call's first kernel to the end of its last (``ms``), each kernel's
    median duration (``kernels_ms``) and, for two kernels, the median gap
    from the end of the first to the start of the second (negative where
    they overlap).  The calls queue behind a device sleep that outlasts
    their launching, so no gap waits on the host: a kernel of a few µs takes
    longer to launch than to run.  Warm: calls back to back, the operands in
    L2.  Cold: a ``COLD_BYTES`` write before each call evicts them."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.empty(COLD_BYTES // 4, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(HOLD_CYCLES)
        for _ in range(reps):
            if cold:
                scratch.zero_()
            fn()
        torch.cuda.synchronize()
    # device events by (start, end, name): the profiler may list one more than once
    spans = sorted({(start, end, name) for dev, start, end, name in profile_events(prof)
                    if dev and any(k in name for k in kernels)})
    k = len(spans) // reps
    require(k > 0 and len(spans) == reps * k, f"{kernels}: {len(spans)} spans for {reps} calls")
    calls = [spans[i:i + k] for i in range(0, len(spans), k)]
    names = [[next(n for n in kernels if n in span[2]) for span in c] for c in calls]
    require(all(n == names[0] for n in names), f"{kernels}: the calls ran other kernels")
    out = {"ms": statistics.median(c[-1][1] - c[0][0] for c in calls) / 1e3,
           "kernels_ms": {name: statistics.median(c[i][1] - c[i][0] for c in calls) / 1e3
                          for i, name in enumerate(names[0])},
           "reps": reps, "cold": cold}
    if k == 2:
        out["gap_ms"] = statistics.median(c[1][0] - c[0][1] for c in calls) / 1e3
    return out


def bound_ms(flops: float, nbytes: float, peak: float):
    """The least time for the work: the larger of operations over the peak
    rate and bytes over the memory rate; and which one it is."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def bf16_ulp(t):
    """One bf16 ulp at each value of ``t`` (8 significant bits)."""
    import torch

    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), (e - 8).float())


def misaligned_copy(t):
    """``t``'s values in a view one element past a 16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    out = buf[1:].view(t.shape)
    require(out.data_ptr() % 16 != 0, "the misaligned view is aligned")
    return out


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
                        "pgd_l2_resident_kernel", "pgd_l2_partials_kernel",
                        "pgd_l2_write_kernel", "pgd_linf_kernel"):
                if tag in mangled:
                    rest = mangled.split(tag)[1]
                    m = re.match(r"I(f|13__nv_bfloat16)((?:Li\d+E)*)E", rest)
                    e = re.match(r"INS_\d+(F32|BF16)ElemE(Lb1E)?", rest)
                    args = ([{"f": "f32"}.get(m[1], "bf16")] + re.findall(r"Li(\d+)E", m[2])
                            if m else [e[1].lower()] + (["mask"] if e[2] else []) if e
                            else [rest[1:40]])
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
    out["device_ms"] = {
        "fwd": device_ms(lambda: fa.flash_fwd(q, k, v), ("flash_fwd_kernel",), reps)["ms"],
        "bwd_kv": device_ms(lambda: fa.flash_bwd_kv(q, k, v, do, lse_ref, delta),
                            ("flash_bwd_kv_kernel",), reps)["ms"],
        "bwd_q": device_ms(lambda: fa.flash_bwd_q(q, k, v, do, lse_ref, delta),
                           ("flash_bwd_q_kernel",), reps)["ms"],
    }
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    out["library_ms"] = {"fwd": cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)}
    out["library_backend"] = sdpa_backend(qt, kt, vt)
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


def sdpa_backend(q, k, v) -> dict:
    """Which backend SDPA's forward took on these inputs, from the name of
    the aten operator it dispatched to (flash takes no f32 and no head dim
    above 256), with the names of the kernels it ran."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v)
        torch.cuda.synchronize()
    events = profile_events(prof)
    ops = {name for _, _, _, name in events if name.startswith("aten::_scaled_dot_product")}
    backend = next((b for op, b in (("flash", "flash"), ("efficient", "efficient"),
                                    ("cudnn", "cudnn"), ("math", "math"))
                    if any(op in name for name in ops)), "unknown")
    kernels = sorted({name[:100] for dev, _, _, name in events if dev})
    return {"backend": backend, "ops": sorted(ops), "kernels": kernels[:6]}


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


def l2_inputs(gen, shape, case: str, mask: bool):
    """K4's inputs in f32 (x, grad, src, mask or None), by ``case``:
    ``random``: x and src independent, an iterate far outside the ball;
    ``radii``: x = src + delta with ||delta|| of sample b the b-th of 0.3,
    0.8, 1, 1.2, 3, 0.5, 1, 10 eps, so that some samples are projected and
    some are not; ``on-ball``: ||x - src|| = eps, sample 0's gradient
    pointing outward (-delta) and sample 1's inward (delta);
    ``zero-grad``, ``zero-mask``: ||delta|| = 1.5 eps and a zero gradient or
    an all-zero mask."""
    import torch

    b, eps = shape[0], L2["eps"]
    src = (torch.randn(shape, generator=gen, device="cuda") * 0.4).clamp(-1, 1)
    g = torch.randn(shape, generator=gen, device="cuda")
    m = ((torch.rand((b, 1, *shape[2:]), generator=gen, device="cuda") > 0.5).float()
         if mask else None)
    if case == "random":
        return torch.randn(shape, generator=gen, device="cuda") * 0.3, g, src, m
    radii = {"radii": (0.3, 0.8, 1.0, 1.2, 3.0, 0.5, 1.0, 10.0),
             "on-ball": (1.0,)}.get(case, (1.5,))
    delta = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64)
    r = torch.tensor([radii[i % len(radii)] * eps for i in range(b)], dtype=torch.float64,
                     device="cuda")
    delta *= (r / delta.flatten(1).norm(dim=1)).view(b, 1, 1, 1)
    x = (src.double() + delta).float()
    if case == "on-ball":
        g = (x - src) * torch.tensor([-1.0, 1.0], device="cuda")[:b].view(b, 1, 1, 1)
    elif case == "zero-grad":
        g = torch.zeros_like(g)
    elif case == "zero-mask":
        m = torch.zeros_like(m)
    return x, g, src, m


def check_l2(pk, gen, shape, dtype, mask: bool, case: str, misaligned: bool = False,
             times: bool = False) -> dict:
    """K4 against ``l2_perturbation_step`` at the TrainConfig's step and eps:
    in f32 within 1e-5; in bf16 within one bf16 ulp of the plain version
    computed in f32 on the same bf16 inputs and rounded once (K4 computes in
    f32 and rounds once), or within the f32 tolerance 1e-5 where that is
    more: an f32 output near 0 carries the rounding of the norms' sums
    (up to ~1e-7), more than one bf16 ulp of it, so its rounding may land
    further off.  The count of elements beyond one ulp, and the largest
    value among them, are recorded.  Two calls on the same inputs must give
    the same bits.  ``misaligned`` puts every operand (the mask too) one
    element past a 16-byte boundary: K4 takes its scalar path there."""
    import torch

    x, g, src, m = l2_inputs(gen, shape, case, mask)
    x, g, src = (t.to(dtype) for t in (x, g, src))
    if misaligned:
        x, g, src = (misaligned_copy(t) for t in (x, g, src))
        m = None if m is None else misaligned_copy(m)
    args = (x, g, src, *L2.values())
    got = pk.pgd_l2_update(*args, mask=m)
    again = pk.pgd_l2_update(*args, mask=m)
    want = pk.l2_perturbation_step(*(t.float() for t in (x, g, src)), *L2.values(), m)
    torch.cuda.synchronize()
    what = (f"pgd_l2_update {list(shape)} {str(dtype).split('.')[-1]} mask={mask} {case}"
            f"{' misaligned' if misaligned else ''}")
    require(torch.equal(got, again), f"{what}: two calls differ")
    if dtype == torch.float32:
        err, tol = max_err(got, want), 1e-5
        require(err <= tol, f"{what}: max abs err {err:.3e} over {tol:.0e}")
    else:
        want = want.to(dtype)
        err, tol = max_err(got, want), "max(1 bf16 ulp, 1e-5)"
        diff, ulp = (got.float() - want.float()).abs(), bf16_ulp(want)
        beyond = diff > ulp
        require(bool((diff <= ulp.clamp(min=1e-5)).all()),
                f"{what}: off by more than max(one bf16 ulp, 1e-5) (max abs err {err:.3e})")
        tol += (f"; {int(beyond.sum())} beyond one ulp, at |value| <= "
                f"{want.float().abs()[beyond].max().item() if beyond.any() else 0.0:.1e}")
    out = {"what": what, "shape": list(shape), "dtype": str(dtype).split(".")[-1], "mask": mask,
           "case": case, "misaligned": misaligned, "err": err, "tol": tol}
    if times:
        n, item = x.numel(), x.element_size()
        call = lambda: pk.pgd_l2_update(*args, mask=m)                       # noqa: E731
        out.update(host_call_ms=cuda_ms(call, 50), device=device_ms(call, K4_KERNELS),
                   device_cold=device_ms(call, K4_KERNELS, cold=True),
                   plain_ms=cuda_ms(lambda: pk.l2_perturbation_step(*args, m), 20),
                   # ~15 operations per element; x, grad, src (and the mask) read, out written
                   bound=bound_ms(15.0 * n, 4.0 * n * item + (m.numel() * 4 if mask else 0),
                                  H100_F32_FLOPS),
                   blocks=shape[0] * pk.l2_chunks(shape[2] * shape[3], item))
    return out


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
        x, g, src = (misaligned_copy(t) for t in (x, g, src))
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
    dt = str(dtype).split(".")[-1]
    out = {"what": f"pgd_linf_update {list(shape)} {dt}", "shape": list(shape), "dtype": dt,
           "misaligned": misaligned, "nan": nan, "err": err, "tol": tol}
    if times:
        item = x.element_size()
        call = lambda: pk.pgd_linf_update(*args)                             # noqa: E731
        out.update(host_call_ms=cuda_ms(call, 50), device=device_ms(call, K5_KERNELS),
                   device_cold=device_ms(call, K5_KERNELS, cold=True),
                   plain_ms=cuda_ms(lambda: pk.linf_perturbation_step(*args), 50),
                   # ~9 operations per element; 3 reads and 1 write
                   bound=bound_ms(9.0 * n, 4.0 * n * item,
                                  H100_F32_FLOPS if f32 else H100_BF16_FLOPS))
    return out


#: K4's timed cases: (key, shape, dtype, mask, inputs)
K4_TIMED = (("f32", IMAGE_SHAPE, "float32", False, "random"),
            ("f32-mask", IMAGE_SHAPE, "float32", True, "random"),
            ("batch8-f32", ENC_IMAGE_SHAPE, "float32", False, "radii"),
            ("bf16", IMAGE_SHAPE, "bfloat16", False, "random"),
            ("bf16-1024", XL1K_IMAGE_SHAPE, "bfloat16", False, "random"))
RAGGED_L2 = (2, 3, 33, 35)          # H*W = 1155: no multiple of a vector or of a chunk
ON_BALL_L2 = (2, 3, 512, 512)
#: K4's further checks: (shape, dtype, mask, inputs, misaligned)
K4_CHECKS = (
    (ENC_IMAGE_SHAPE, "float32", True, "radii", False),
    (ENC_IMAGE_SHAPE, "bfloat16", True, "radii", False),
    (IMAGE_SHAPE, "bfloat16", True, "random", False),
    *((RAGGED_L2, dt, mask, "radii", False) for dt in ("float32", "bfloat16")
      for mask in (False, True)),
    (IMAGE_SHAPE, "float32", True, "random", True),
    (IMAGE_SHAPE, "bfloat16", False, "random", True),
    (RAGGED_L2, "float32", True, "radii", True),
    (RAGGED_L2, "bfloat16", False, "radii", True),
    (ON_BALL_L2, "float32", False, "on-ball", False),
    (ON_BALL_L2, "float32", True, "on-ball", False),
    (ON_BALL_L2, "bfloat16", False, "on-ball", False),
    (ON_BALL_L2, "float32", False, "zero-grad", False),
    (ON_BALL_L2, "float32", True, "zero-mask", False),
)


def print_update(r: dict) -> None:
    """One timed K4 or K5 case, in microseconds: device time warm (where a
    call runs two kernels, each one and the gap between them) and cold, the
    host-call mean, the plain version and the bound."""
    d, c, (bound, by) = r["device"], r["device_cold"], r["bound"]
    parts = ""
    if "gap_ms" in d:
        parts = (" (" + ", ".join(f"{k.split('_kernel')[0]} {v * 1e3:.2f}"
                                  for k, v in d["kernels_ms"].items())
                 + f", gap {d['gap_ms'] * 1e3:.2f})")
    blocks = f"; {r['blocks']} blocks" if "blocks" in r else ""
    print(f"[kernels] {r['what']}: max abs err {r['err']:.2e} (tol {r['tol']}); device us warm "
          f"{d['ms'] * 1e3:.2f}{parts}, cold {c['ms'] * 1e3:.2f} ({bound / d['ms']:.0%} / "
          f"{bound / c['ms']:.0%} of the bound); host-call mean us {r['host_call_ms'] * 1e3:.2f}; "
          f"plain us {r['plain_ms'] * 1e3:.2f}; bound us {bound * 1e3:.2f} ({by}){blocks}",
          flush=True)


def check_updates(pk, gen) -> dict:
    """The PGD updates on the card: K4 at its timed shapes and its further
    cases (per-sample norms, ragged, misaligned, on the ball, zero gradient,
    zero mask; every case two calls bit-equal), then K5 as before, with
    device and host times."""
    import torch

    l2 = {}
    for key, shape, dtype, mask, case in K4_TIMED:
        l2[key] = check_l2(pk, gen, shape, getattr(torch, dtype), mask, case, times=True)
        print_update(l2[key])
    checks = [check_l2(pk, gen, shape, getattr(torch, dtype), mask, case, misaligned)
              for shape, dtype, mask, case, misaligned in K4_CHECKS]
    for r in checks:
        print(f"[kernels] {r['what']}: max abs err {r['err']:.2e} (tol {r['tol']}); two calls "
              "bit-equal", flush=True)
    linf = {}
    for shape in (IMAGE_SHAPE, ENC_IMAGE_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            r = linf[f"{shape}-{str(dtype).split('.')[-1]}"] = check_linf(pk, gen, shape, dtype,
                                                                          times=True)
            print_update(r)
    for dtype in (torch.float32, torch.bfloat16):
        check_linf(pk, gen, (1, 3, 33, 35), dtype, times=False, nan=True)
        check_linf(pk, gen, IMAGE_SHAPE, dtype, times=False, misaligned=True)
        check_linf(pk, gen, (1, 3, 33, 35), dtype, times=False, misaligned=True)
    print("[kernels] pgd_linf_update ragged [1, 3, 33, 35] with NaN in x, and misaligned views, "
          "agree (f32 bit-equal, bf16 within 4e-3)", flush=True)
    return {"l2": l2, "l2_checks": checks, "linf": linf}


def one_iteration_inputs(model, cfg, source, target, mask=None):
    """What one PGD iteration of an immunize path takes, drawn as immunize
    draws its first iteration, in the source's dtype: (sampler, plan, data,
    draws); ``mask`` is the masked path's [1, 1, H, W]."""
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
        draws = sample_draws(gen0, cfg, len(cfg.prompts), 1, model.latent_shape, plan.num_steps,
                             source.dtype)
    bank = model.embed_prompt_bank([format_prompt(p) for p in cfg.prompts])
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    pool = torch.randn((1, *model.latent_shape), generator=gen, device=dev, dtype=source.dtype)
    data = make_attack_data(model, cfg, source, target, bank, pool, mask=mask)
    return sampler, plan, data, draws


def check_iteration_against_plain(model, cfg, inputs, layers) -> dict:
    """One PGD iteration at full width on the same draws twice: through the
    kernels, and through plain attention with the plain update.  The
    iterates and the losses must agree (f32 on both sides; they differ in
    the order of the attention sums only); with a mask, both equal the
    source outside it."""
    import dataclasses

    import torch

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
    if data.mask is not None:
        # the masked update leaves the source where the mask is 0, on both sides
        outside = (data.mask == 0).expand_as(x_k)
        out["outside_mask_at_source"] = all(torch.equal(x[outside], data.source[outside])
                                            for x in (x_k, x_p))
        require(out["outside_mask_at_source"], f"masked iteration moved outside the mask: {out}")
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
    # cuDNN's FFT algorithms run complex (float2 / cf32) gemm and gemv kernels;
    # its bf16 convolutions run on NHWC copies of the NCHW tensors, which it
    # makes and undoes itself (nchwToNhwc, nhwcToNchw)
    if any(s in n for s in ("conv", "dgrad", "fprop", "wgrad", "implicit", "winograd", "fft",
                            "cf32", "float2", "nchwtonhwc", "nhwctonchw")):
        return "convolution (cuDNN)"
    # cuBLAS's Hopper kernels are named nvjet_*
    if any(s in n for s in ("gemm", "cutlass", "xmma", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    # group norm's statistics (RowwiseMoments) and its fused backward parameters
    if any(s in n for s in ("norm", "rowwisemoments", "fusedparams", "internalgradients")):
        return "group/layer norm"
    return "elementwise and other"


def profile_call(fn) -> dict:
    """One call of ``fn`` under torch.profiler: device time by kernel and by
    group, and the share of the call's wall time in which the device ran no
    kernel (the profiler's own overhead lengthens the wall time, so that
    share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device events by (name, start): the profiler may list one more than once
    spans = {(name, start): end for dev, start, end, name in profile_events(prof) if dev}
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


def profile_iteration(model, cfg, inputs) -> dict:
    """One PGD iteration of ``cfg``'s path under torch.profiler, after one
    warm-up (:func:`profile_call`)."""
    from tml_image_editing_defense_torch.attack.inpaint import make_inpaint_pgd_step
    from tml_image_editing_defense_torch.attack.pgd import make_pgd_step

    sampler, plan, data, draws = inputs
    if cfg.attack_mode == "inpaint":
        step = make_inpaint_pgd_step(model, sampler, plan, cfg)
    else:
        step = make_pgd_step(model, sampler, plan, cfg, decode_vis=False)
    step(data.source, data, draws)
    return profile_call(lambda: step(data.source, data, draws))


def profile_eval_batch(clean, adv) -> dict:
    """One evaluation batch under torch.profiler (:func:`profile_call`):
    ``edit_pairs`` of EVAL_BATCH cells on a model built as ``api.evaluate``
    builds it, at the InferenceConfig defaults (PLMS, 100 steps at strength
    0.6, guidance 7.5).  No warm-up call: the evaluate phase ran these
    shapes in this process just before."""
    import torch

    from tml_image_editing_defense_torch.api import EVAL_ATTN_CHUNK
    from tml_image_editing_defense_torch.configs import INFERENCE_PROMPTS, InferenceConfig
    from tml_image_editing_defense_torch.models.model_zoo import build_model
    from tml_image_editing_defense_torch.pipelines import Img2ImgPipeline

    cfg = InferenceConfig()
    model = build_model("sd15", image_size=cfg.image_size, device="cuda",
                        attn_kv_chunk=EVAL_ATTN_CHUNK)
    pipe = Img2ImgPipeline(model, sampler="plms")
    gen = torch.Generator(device="cuda").manual_seed(2)
    draws = [torch.randn((EVAL_BATCH, 2, *model.latent_shape[1:]), generator=gen, device="cuda")
             for _ in range(2)]
    pairs = pipe.prepare_image([clean, adv]).expand(EVAL_BATCH, 2, 3, cfg.image_size,
                                                     cfg.image_size)
    prompts = [f"{p}, detailed" for p in INFERENCE_PROMPTS[:EVAL_BATCH]]
    return profile_call(lambda: pipe.edit_pairs(
        prompts, pairs, *draws, num_inference_steps=cfg.n_steps,
        guidance_scale=cfg.guidance_scale, strength=cfg.strength))


def synthetic_image(path: Path, seed: int, size=(640, 600)) -> None:
    """A smooth random RGB image of ``size`` (width, height), no file from
    outside the repository."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size[1], 0:size[0]] / 64.0
    arr = np.stack([np.sin(xx * rng.uniform(0.5, 2)) * np.cos(yy * rng.uniform(0.5, 2))
                    for _ in range(3)], -1)
    arr = arr + 0.3 * rng.standard_normal(arr.shape)
    Image.fromarray(np.uint8(np.clip((arr + 1.5) / 3.0, 0, 1) * 255)).save(path)


def immunize_path(api, cfg, kernels, per_iteration: dict, outside: dict, model=None) -> dict:
    """``api.immunize(cfg)`` on the card (on ``model`` where one is given)
    with every count set to 0 just before it and read just after; the
    launches must be those the code implies: ``per_iteration`` times the
    iterations plus ``outside``."""
    import torch

    from tml_image_editing_defense_torch.core.image_ops import load_image

    for kern in kernels:
        kern.launches = 0
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = api.immunize(cfg, model=model)     # on the card: the default device
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kern.symbol: kern.launches for kern in kernels}
    n = cfg.n_optimization_steps
    expected = {kern.symbol: n * per_iteration.get(kern.symbol, 0) + outside.get(kern.symbol, 0)
                for kern in kernels}
    require(launches == expected, (cfg.attack_mode, launches, expected))

    # the images as the attack holds them (in cfg.dtype)
    src = torch.from_numpy(load_image(cfg.source_image_path, cfg.image_size)).cuda()
    tgt = torch.from_numpy(load_image(cfg.target_image_path, cfg.image_size)).cuda()
    src, tgt = src.to(result.x_adv.dtype), tgt.to(result.x_adv.dtype)
    if cfg.norm_type == "l2":
        dist = torch.linalg.vector_norm(result.x_adv.float() - src.float()).item()
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
            "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
            "allocated_before_gb": before / 1e9,
            "history": result.history, "dist": dist, "launches": launches,
            "expected_launches": expected, "_result": result, "_src": src, "_tgt": tgt}


def encoder_path(kernels, images) -> dict:
    """The encoder attack on SD-1.5 at the images' size (512x512,
    batch 8), L-inf, stochastic encode, ENC_STEPS steps, after a one-step
    warm-up; counts set to 0 just before the target encode and read just
    after the loop; the peak counted from the model's build on."""
    import torch

    from tml_image_editing_defense_torch.attack.encoder_attack import (
        make_encoder_attack_loop,
        make_encoder_attack_step,
    )
    from tml_image_editing_defense_torch.models.model_zoo import build_model

    src, tgt = images
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
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
            "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
            "losses": losses.tolist(), "dist": dist, "launches": launches,
            "expected_launches": expected}


def resume_path(api, cfg, model, full_x, kernels, per_iteration: dict, tmp: Path) -> dict:
    """The diffusion path interrupted and resumed on ``model``: ITERATIONS - 1
    iterations with ``checkpoint_interval=1``, whose last save (after the
    second iteration) says ITERATIONS - 1; then ``api.immunize`` from that
    state, which runs the last iteration only, with every count set to 0
    just before it and read just after.  Its launches: one iteration's,
    the target encode and the last iteration's vis decode."""
    import dataclasses

    import torch

    part = dataclasses.replace(cfg, output_path=tmp / "out_part",
                               n_optimization_steps=ITERATIONS - 1, checkpoint_interval=1)
    api.immunize(part, model=model)
    state = part.output_path / "attack_state.npz"
    res_cfg = dataclasses.replace(cfg, output_path=tmp / "out_resume")
    for kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.immunize(res_cfg, model=model, resume_from=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kern.symbol: kern.launches for kern in kernels}
    expected = {kern.symbol: per_iteration.get(kern.symbol, 0) for kern in kernels}
    expected["tid_flash_fwd"] += 2
    require(launches == expected, ("resume", launches, expected))
    require(len(res.history) == 1 and all(math.isfinite(v) for v in res.history[0].values()),
            res.history)
    rows = [json.loads(r) for r in (res_cfg.output_path / "metrics.jsonl").read_text().splitlines()]
    require([r["step"] for r in rows] == [ITERATIONS - 1], rows)
    diff = max_err(res.x_adv, full_x)
    require(diff <= 1e-3, f"resumed x_adv off the uninterrupted run's by {diff:.3e} (gate 1e-3)")
    return {"wall_s": wall, "iteration_row_t_s": rows[0]["t"], "x_adv_max_abs_diff": diff,
            "history": res.history, "launches": launches, "expected_launches": expected}


def write_safetensors(path: Path, tensors: dict) -> int:
    """This script's own writer of the safetensors format (the package has
    a reader only): an 8-byte little-endian header length, the JSON header
    of ``{name: {dtype, shape, data_offsets}}``, then the raw bytes.
    f32 and i64 tensors; returns the file's size in bytes."""
    names = {"float32": "F32", "int64": "I64"}
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        arr = t.detach().cpu().contiguous().numpy()
        blob = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": names[str(arr.dtype)], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    path.write_bytes(len(raw).to_bytes(8, "little") + raw + b"".join(blobs))
    return path.stat().st_size


def isnet_conv_flops(isnet, size: int) -> int:
    """The convolutions' operations (2 per multiply-add) of one ISNet
    forward at [1, 3, size, size], counted on ``meta`` from the RMBG-1.4
    config."""
    import torch

    model = isnet.build_isnet("rmbg", device="meta")
    flops = [0]

    def count(mod, inputs, out):
        flops[0] += 2 * out.numel() * math.prod(mod.weight.shape[1:])

    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_hook(count)
    with torch.no_grad():
        model(torch.empty((1, 3, size, size), device="meta"))
    return flops[0]


def masked_path(api, pk, cfg, model, kernels, per_iteration: dict, outside: dict,
                tmp: Path) -> dict:
    """The masked immunization (path m) on ``model``, after ISNet alone.

    A random RMBG-1.4 at its published widths, made on the card from a
    seed, goes to ``model.safetensors`` and comes back through
    ``load_rmbg_checkpoint``; its forward at the native 1024x1024 and
    ``salient_mask`` at ``cfg.image_size`` are timed and the mask's share
    must lie strictly between 0 and 1.  Then ``api.immunize(cfg)`` with the
    mask from that directory, through :func:`immunize_path`, with a spy on
    ``make_attack_data`` (the mask used, and what is allocated there: ISNet
    must be gone) and on ``ops.pgd_kernels.pgd_l2_update`` (after each
    update with the mask, x_adv at the source where the mask is 0 and moved
    where it is 1).  K4's launches with the mask are counted where K4's
    masked entry launches, as every other count is."""
    import numpy as np
    import torch
    from PIL import Image

    from tml_image_editing_defense_torch.aux_models import segment
    from tml_image_editing_defense_torch.core.image_ops import resize_crop_pil
    from tml_image_editing_defense_torch.models import isnet

    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ckpt = tmp / "rmbg"
    ckpt.mkdir()
    built = isnet.build_isnet("rmbg", device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(14))
    state = built.state_dict()
    file_bytes = write_safetensors(ckpt / "model.safetensors", state)
    seg = isnet.load_rmbg_checkpoint(ckpt)
    loaded = seg.state_dict()
    require(set(loaded) == set(state) and all(torch.equal(loaded[k], state[k]) for k in state),
            "load_rmbg_checkpoint did not give back the written weights")
    n_keys, n_params = len(state), sum(p.numel() for p in seg.parameters())
    del built, state, loaded

    crop = np.asarray(resize_crop_pil(Image.open(cfg.source_image_path).convert("RGB"),
                                      cfg.image_size), np.float32) / 255.0
    native = seg.config.image_size
    x = isnet._resize(torch.from_numpy(crop).permute(2, 0, 1)[None].cuda(), native) - 0.5
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: seg.saliency(x), 10)
    walls, masks = [], []
    for _ in range(2):                      # the first call, then a warm one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks.append(isnet.salient_mask(seg, crop, cfg.image_size))
        walls.append(time.perf_counter() - t0)
    want = masks[0]
    require(np.array_equal(*masks), "two salient_mask calls differ")
    share = float(want.mean())
    require(0.0 < share < 1.0, f"the ISNet mask is {'all ones' if share else 'all zeros'}")
    heuristic = segment._heuristic_saliency(crop)
    require(not np.array_equal(want, heuristic), "the ISNet mask equals the heuristic one")
    isnet_peak_gb = (torch.cuda.max_memory_allocated() - start) / 1e9
    flops = isnet_conv_flops(isnet, native)
    del seg, x
    free_card()

    seen = {"masked_updates": []}
    make_data, l2_update = api.make_attack_data, pk.pgd_l2_update

    def spy_make(*args, **kw):
        data = make_data(*args, **kw)
        seen["mask"] = None if data.mask is None else data.mask.clone()
        seen["allocated_gb"] = (torch.cuda.memory_allocated() - seen["before"]) / 1e9
        return data

    def spy_l2(**kw):
        out = l2_update(**kw)
        if kw.get("mask") is not None:
            out_mask = (kw["mask"] == 0).expand_as(out)
            seen["masked_updates"].append(
                (torch.equal(out[out_mask], kw["x_src"][out_mask]),
                 bool((out != kw["x_src"])[~out_mask].any())))
        return out

    api.make_attack_data, pk.pgd_l2_update = spy_make, spy_l2
    seen["before"] = torch.cuda.memory_allocated()
    try:
        res = immunize_path(api, cfg, kernels, per_iteration, outside, model=model)
    finally:
        api.make_attack_data, pk.pgd_l2_update = make_data, l2_update
    updates = seen["masked_updates"]
    require(len(updates) == cfg.n_optimization_steps,
            f"{len(updates)} masked updates checked in {cfg.n_optimization_steps} iterations")
    require(all(at_source for at_source, _ in updates), "x_adv left the source outside the mask")
    require(all(moved for _, moved in updates), "x_adv did not move inside the mask")
    used = seen["mask"]
    require(used is not None and tuple(used.shape) == (1, 1, cfg.image_size, cfg.image_size),
            f"immunize used no [1, 1, H, W] mask: {None if used is None else used.shape}")
    used = used[0, 0].cpu().numpy()
    differ = int((used != want).sum())
    require(differ == 0, f"immunize's mask differs from ISNet's at {differ} pixels")
    # ISNet (176 MB of weights) is gone before the loop: what is allocated at
    # make_attack_data is the mask, the images, the prompt bank and the pool
    require(seen["allocated_gb"] < 0.1, f"{seen['allocated_gb']:.3f} GB allocated above the "
            "model when the attack data is made: ISNet was kept")
    route = res.pop("_result").mask_route
    require(route == "isnet", f"immunize took its mask from the {route} route, not ISNet")
    res.update(
        mask_route=route, checkpoint_keys=n_keys, checkpoint_bytes=file_bytes, isnet_params=n_params,
        isnet_forward_ms=forward_ms, isnet_forward_flops=flops,
        isnet_forward_bound_ms=flops / H100_F32_FLOPS * 1e3,
        salient_mask_wall_s=walls[0], salient_mask_warm_wall_s=walls[1], mask_share=share,
        heuristic_share=float(heuristic.mean()), isnet_peak_gb=isnet_peak_gb,
        allocated_at_attack_data_gb=seen["allocated_gb"],
        _mask=torch.from_numpy(used).cuda()[None, None])
    return res


def evaluate_gate(model, clean, adv, layers, sampler: str = "plms") -> dict:
    """One (clean, adv) pair through ``Img2ImgPipeline`` on ``model`` twice,
    with the same noise and posterior draws: with K1 in the long
    self-attentions, and with every attention on the plain path (the
    length floor of ``layers.scaled_attention`` raised out of reach), on the
    same weights; ``sampler`` (PLMS for SD-1.5, Euler for SDXL), 10 steps at
    strength 0.6, guidance 7.5.  The images in [0, 1] must be finite and
    agree within 1e-3."""
    import torch

    from tml_image_editing_defense_torch.pipelines import Img2ImgPipeline

    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(1)
    noise, eps = (torch.randn((2, *model.latent_shape[1:]), generator=gen, device=dev)
                  for _ in range(2))
    pipe = Img2ImgPipeline(model, sampler=sampler)
    outs = []
    floor = layers.MIN_CHUNKED_SEQ
    for plain in (False, True):
        layers.MIN_CHUNKED_SEQ = 1 << 30 if plain else floor
        try:
            outs.append(pipe("frozen, detailed", [clean, adv], num_inference_steps=10,
                             strength=0.6, guidance_scale=7.5, noise=noise, vae_eps=eps,
                             output_type="pt"))
        finally:
            layers.MIN_CHUNKED_SEQ = floor
    torch.cuda.synchronize()
    out = {"sampler": sampler, "image_size": model.image_size,
           "unet_steps": pipe.plan(10, 0.6).num_steps, "max_abs_diff": max_err(*outs),
           "finite": bool(torch.isfinite(outs[0]).all() and torch.isfinite(outs[1]).all()),
           "mean_abs_diff": (outs[0] - outs[1]).abs().mean().item()}
    require(out["finite"] and out["max_abs_diff"] <= 1e-3, f"evaluate gate: {out}")
    return out


def evaluate_path(cli, kernels, adv_dir: Path, source: Path, target: Path, val_image: Path,
                  tmp: Path) -> dict:
    """``cli.main(["evaluate", ...])`` on the card at the InferenceConfig
    defaults with two prompts, ``adv_dir``'s adversarial image and noise
    pool, and one validation image; every count set to 0 just before and
    read just after.  Per batch of 2 cells K1 runs once in the VAE encode,
    once in the decode and 5 times in each of the 61 UNet calls."""
    import torch
    from PIL import Image

    from tml_image_editing_defense_torch.configs import INFERENCE_PROMPTS, InferenceConfig
    from tml_image_editing_defense_torch.core.samplers import PLMSSampler
    from tml_image_editing_defense_torch.core.schedule import make_noise_schedule
    from tml_image_editing_defense_torch.models.unet import SD15_UNET

    (tmp / "val.txt").write_text(f"{val_image}\n")
    out_dir = tmp / "eval"
    prompts = INFERENCE_PROMPTS[:EVAL_PROMPTS]
    args = ["evaluate", "--adversarial-image", str(adv_dir / "adversarial_image.png"),
            "--noise-pool", str(adv_dir / "noise.npz"), "--source-image-path", str(source),
            "--target-image-path", str(target), "--output-path", str(out_dir), "--n-noise", "1",
            "--validation-images-path", str(tmp / "val.txt"), "--prompts", *prompts]
    for kern in kernels:
        kern.launches = 0
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(args)                     # on the card: the CLI's default device
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(rc == 0, f"evaluate exited {rc}")
    launches = {kern.symbol: kern.launches for kern in kernels}
    cfg = InferenceConfig()
    unet_steps = PLMSSampler(make_noise_schedule()).plan(cfg.n_steps, cfg.strength).num_steps
    batches = 2                             # the source image's cells, the validation image's
    at_shape = {"unet": batches * unet_steps * unet_long_attentions(SD15_UNET, cfg.image_size),
                "vae": batches * 2}
    expected = {kern.symbol: 0 for kern in kernels}
    expected["tid_flash_fwd"] = sum(at_shape.values())
    require(launches == expected, ("evaluate", launches, expected))
    rows = [json.loads(r) for r in (out_dir / "metrics.jsonl").read_text().splitlines()]
    dispatch = [r["edit_dispatch_s"] for r in rows if "edit_dispatch_s" in r]
    pairs = [int(r["edit_pairs"]) for r in rows if "edit_dispatch_s" in r]
    require(len(dispatch) == batches and pairs == [EVAL_BATCH] * batches, rows)
    size = cfg.image_size
    for p in prompts:
        stem = "-".join(f"{p}, detailed"[:30].split())
        for name, width in ((f"{stem}_noise_0.png", 5 * size),
                            (f"val_{val_image.stem}_{stem}_noise_0.png", 4 * size)):
            with Image.open(out_dir / name) as grid:
                require(grid.size[0] == width and grid.size[1] > size, (name, grid.size))
    return {"wall_s": wall, "dispatch_s": dispatch, "s_per_pair": [d / EVAL_BATCH for d in dispatch],
            "unet_steps": unet_steps, "cells": batches * EVAL_BATCH,
            "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
            "allocated_before_gb": before / 1e9,
            "launches": launches, "expected_launches": expected, "k1_launches_at_shape": at_shape}


def unet_long_attentions(unet_cfg, image_size: int) -> int:
    """Self-attentions of one UNet call that go to K1 at ``image_size``: at
    every level whose token count reaches the flash path's floor
    (``layers.scaled_attention`` with the builds' chunk of 512), a level
    with attention has ``layers_per_block`` transformers down and one more
    up, each ``transformer_layers_per_block`` layers deep; the mid block
    adds the last level's."""
    from tml_image_editing_defense_torch.models import layers

    floor = max(2 * 512, layers.MIN_CHUNKED_SEQ)
    side, levels = image_size // 8, len(unet_cfg.block_out_channels)
    count = sum((2 * unet_cfg.layers_per_block + 1) * unet_cfg.transformer_layers_per_block[i]
                for i in range(levels)
                if unet_cfg.cross_attention_blocks[i] and (side >> i) ** 2 >= floor)
    if (side >> (levels - 1)) ** 2 >= floor:
        count += unet_cfg.transformer_layers_per_block[-1]
    return count


def pgd_launches(unet_cfg, cfg, unet_steps: int) -> dict:
    """K1-K4 launches of one PGD iteration of ``cfg``'s diffusion path: the
    shared encode, and per rep ``unet_steps`` UNet calls with
    :func:`unet_long_attentions` long self-attentions each and one decode,
    all forward and backward, and one update.  Under a remat policy every
    UNet forward runs again in the backward (the checkpoint's recompute),
    under ``remat_vae`` the encode's and each decode's too."""
    unet = unet_steps * unet_long_attentions(unet_cfg, cfg.image_size)
    unet_fwd = 1 if cfg.remat_policy == "none" else 2
    vae_fwd = 2 if cfg.remat_vae else 1
    fwd = cfg.grad_reps * (unet_fwd * unet + vae_fwd) + vae_fwd
    bwd = cfg.grad_reps * (unet + 1) + 1
    return {"tid_flash_fwd": fwd, "tid_flash_bwd_kv": bwd, "tid_flash_bwd_q": bwd,
            "tid_pgd_l2_update": 1}


def path_flops(family: str, cfg, unet_steps: int, n_iterations: int, seconds: float,
               dtype) -> dict:
    """Useful model FLOPs of one iteration of an immunize path
    (``utils/flops.py``, counted on a ``meta`` build with the plain
    attention) and their share of the card's peak for ``dtype`` over the
    path's s/iteration.  The interval that s/iteration measures holds
    ``n_iterations - 1`` iterations and one vis decode (a forward), so each
    iteration carries its share of that decode.  The inpaint path encodes
    the image in every rep."""
    from tml_image_editing_defense_torch.utils import flops

    fwd = flops.diffusion_model_flops(family, cfg.image_size)
    image_loss = cfg.apply_loss_on_images or cfg.perturbation_loss_lambda > 0
    if cfg.attack_mode == "inpaint":
        per_rep = fwd["vae_encode"] + unet_steps * fwd["unet"] + image_loss * fwd["vae_decode"]
        step = cfg.grad_reps * flops.input_grad_flops(per_rep)
    else:
        step = flops.pgd_step_model_flops(unet_steps * fwd["unet"], fwd["vae_encode"],
                                          fwd["vae_decode"], cfg.grad_reps, image_loss)
    return flops_share(fwd, step + fwd["vae_decode"] / (n_iterations - 1), seconds, dtype)


def flops_share(forward: dict, work: float, seconds: float, dtype) -> dict:
    """``work`` useful FLOPs done in ``seconds`` as a share of the card's
    peak for ``dtype`` (``utils.flops.mfu``), beside the forward counts it
    came from."""
    from tml_image_editing_defense_torch.utils import flops

    return {"forward_flops": forward, "iteration_flops": work, "seconds": seconds,
            "dtype": str(dtype).split(".")[-1], "peak_flops": flops.device_peak_flops(dtype=dtype),
            "share_of_peak": flops.mfu(work, seconds, dtype=dtype)}


def universal_flops(family: str, size: int, preset: str, reps: int, seconds: float) -> dict:
    """Useful FLOPs of one universal step (f32): per rep the encode, one UNet
    call for the CFG pair and the TAESD preview's decode, each forward and
    input backward, counted on ``meta`` builds; their share of the f32 peak
    over the step's seconds."""
    import torch

    from tml_image_editing_defense_torch.models.tiny_vae import build_tiny_autoencoder
    from tml_image_editing_defense_torch.utils import flops

    fwd = flops.diffusion_model_flops(family, size)
    preview = build_tiny_autoencoder(preset, device="meta")
    fwd["preview_decode"] = flops.count_fn_flops(
        preview.decode, torch.zeros((1, 4, size // 8, size // 8), device="meta"))
    work = reps * flops.input_grad_flops(fwd["vae_encode"] + fwd["unet"] + fwd["preview_decode"])
    return flops_share(fwd, work, seconds, torch.float32)


def iteration_gate(model, cfg, inputs, changes: dict, tol: float = 1e-3) -> dict:
    """One PGD iteration of ``cfg`` on the card twice on the same draws, as
    it is and with ``changes`` (a remat policy, an EOT chunk): the iterates
    within ``tol`` (cuDNN's convolution gradients are not deterministic,
    so not bit for bit), with each one's seconds (CUDA events) and peak
    memory above what was allocated before it."""
    import dataclasses

    import torch

    from tml_image_editing_defense_torch.attack.pgd import make_pgd_step
    from tml_image_editing_defense_torch.utils.profiling import StepTimer, device_memory_stats

    sampler, plan, data, draws = inputs
    out, iterates = {"changes": changes}, {}
    for tag, c in (("as_is", cfg), ("changed", dataclasses.replace(cfg, **changes))):
        before = device_memory_stats()["bytes_in_use"]
        torch.cuda.reset_peak_memory_stats()
        timer = StepTimer("cuda")
        with timer:
            x, aux = make_pgd_step(model, sampler, plan, c, decode_vis=False)(data.source, data,
                                                                              draws)
        iterates[tag] = x
        out[tag] = {"s": timer.last, "avg_loss": aux["avg_loss"].item(),
                    "peak_gb": (device_memory_stats()["peak_bytes_in_use"] - before) / 1e9}
    out["x_adv_max_abs_diff"] = max_err(iterates["as_is"], iterates["changed"])
    out["avg_loss_rel_diff"] = (abs(out["as_is"]["avg_loss"] - out["changed"]["avg_loss"])
                                / abs(out["as_is"]["avg_loss"]))
    require(out["x_adv_max_abs_diff"] <= tol, f"one PGD iteration with {changes}: {out}")
    return out


def sdxl_eval_images(tmp: Path, eps: float) -> dict:
    """A synthetic SDXL_EVAL_SIZE source and target, and an adversarial PNG
    made from the source with a seeded Gaussian perturbation of L2 norm
    0.9 ``eps`` (in [-1, 1] units); after the uint8 round trip it must lie
    inside the ball.  Not an SDXL immunize at 1024x1024: training there waits
    for a rematerialisation policy."""
    import numpy as np
    import torch

    from tml_image_editing_defense_torch.core.image_ops import load_image, to_pil

    size = SDXL_EVAL_SIZE
    paths = {name: tmp / f"xl_{name}.png" for name in ("source", "target", "adversarial")}
    synthetic_image(paths["source"], 101, (size, size))
    synthetic_image(paths["target"], 102, (size, size))
    src = torch.from_numpy(load_image(paths["source"], size))
    delta = torch.from_numpy(np.random.default_rng(7).standard_normal(src.shape)).float()
    delta *= 0.9 * eps / torch.linalg.vector_norm(delta)
    to_pil((src + delta).clamp(-1, 1)).save(paths["adversarial"])
    dist = torch.linalg.vector_norm(torch.from_numpy(load_image(paths["adversarial"], size))
                                    - src).item()
    require(dist <= eps, f"the SDXL adversarial PNG lies {dist:.2f} from its source (eps {eps})")
    return {"paths": paths, "l2": dist}


def sdxl_evaluate_path(cli, kernels, images: dict, tmp: Path) -> dict:
    """``cli.main(["evaluate", "--use-sdxl", "true", "--image-size", "1024",
    ...])`` on the card at the InferenceConfig defaults with the first of
    INFERENCE_PROMPTS, n_noise 1 and no validation images: one cell, its
    (clean, adv) pair as one pipeline call; every count set to 0 just before
    and read just after.  K1 runs ``unet_long_attentions`` times in each
    UNet call and once each in the VAE encode and decode."""
    import torch
    from PIL import Image

    from tml_image_editing_defense_torch.configs import INFERENCE_PROMPTS, InferenceConfig
    from tml_image_editing_defense_torch.core.samplers import EulerSampler
    from tml_image_editing_defense_torch.core.schedule import make_noise_schedule
    from tml_image_editing_defense_torch.models.unet import SDXL_UNET

    size, paths, out_dir = SDXL_EVAL_SIZE, images["paths"], tmp / "eval_sdxl"
    prompt = INFERENCE_PROMPTS[0]
    args = ["evaluate", "--use-sdxl", "true", "--image-size", str(size),
            "--adversarial-image", str(paths["adversarial"]),
            "--source-image-path", str(paths["source"]),
            "--target-image-path", str(paths["target"]), "--output-path", str(out_dir),
            "--n-noise", "1", "--validation-images-path", str(tmp / "no_validation.txt"),
            "--prompts", prompt]
    for kern in kernels:
        kern.launches = 0
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(args)                     # on the card: the CLI's default device
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(rc == 0, f"SDXL evaluate exited {rc}")
    launches = {kern.symbol: kern.launches for kern in kernels}
    cfg = InferenceConfig()
    unet_steps = EulerSampler(make_noise_schedule()).plan(cfg.n_steps, cfg.strength).num_steps
    at_shape = {"unet": unet_steps * unet_long_attentions(SDXL_UNET, size), "vae": 2}
    expected = {kern.symbol: 0 for kern in kernels}
    expected["tid_flash_fwd"] = sum(at_shape.values())
    require(launches == expected, ("SDXL evaluate", launches, expected))
    rows = [json.loads(r) for r in (out_dir / "metrics.jsonl").read_text().splitlines()]
    cells = [r for r in rows if "edit_dispatch_s" in r]
    require(len(cells) == 1 and cells[0]["edit_pairs"] == 1, rows)
    name = "-".join(f"{prompt}, detailed"[:30].split()) + "_noise_0.png"
    with Image.open(out_dir / name) as grid:
        require(grid.size[0] == 5 * size and grid.size[1] > size, (name, grid.size))
    return {"wall_s": wall, "s_per_cell": cells[0]["edit_dispatch_s"], "unet_steps": unet_steps,
            "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
            "allocated_before_gb": before / 1e9, "adversarial_l2": images["l2"],
            "launches": launches, "expected_launches": expected, "k1_launches_at_shape": at_shape}


def universal_launches(unet_cfg, size: int, reps: int, steps: int, validations: int,
                       remat: str) -> dict:
    """K1-K3 launches of a universal run, by shape: each rep runs one VAE
    encoder mid-block and ``unet_long_attentions`` UNet self-attentions,
    forward and backward (the TAESD decode has no attention); under a remat
    policy every forward runs again in the backward.  A validation edit
    runs the encode, the UNet and the full VAE decode, forward only."""
    unet_n, fwd = unet_long_attentions(unet_cfg, size), 1 if remat == "none" else 2
    unet = {"tid_flash_fwd": fwd * steps * reps * unet_n + validations * unet_n,
            "tid_flash_bwd_kv": steps * reps * unet_n, "tid_flash_bwd_q": steps * reps * unet_n}
    vae = {"tid_flash_fwd": fwd * steps * reps + 2 * validations,
           "tid_flash_bwd_kv": steps * reps, "tid_flash_bwd_q": steps * reps}
    return {"unet": unet, "vae": vae}


def universal_path(ua, universal, kernels, dataset: Path, out: Path, args: list,
                   unet_cfg) -> dict:
    """``universal_attack.main`` on the card (``--dataset-dir dataset
    --output out`` and ``args``), with every count set to 0 just before and
    read just after; the launches must be those of
    :func:`universal_launches`.  Each step is recorded as it runs (a
    wrapper of ``make_universal_step``): its seconds, and its perturbation
    against the box, the step image's range and the step's size -- the
    update moves the previous perturbation, re-anchored to the step's image,
    by at most ``step_size`` (the projections are non-expansive)."""
    import numpy as np
    import torch

    records, real = [], universal.make_universal_step

    def recording(model, cfg, bank, preview=None):
        step = real(model, cfg, bank, preview)

        def timed(pert, source, draws):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, loss = step(pert, source, draws)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            anchored = (source + pert.clamp(-cfg.eps, cfg.eps)).clamp(-1.0, 1.0) - source
            records.append({"s": seconds, "loss": loss.item(),
                            "move_l2": torch.linalg.vector_norm(new - anchored).item(),
                            "pert_max": new.abs().max().item(),
                            "perturbed_max": (source + new).abs().max().item()})
            return new, loss

        return timed

    argv = ["--dataset-dir", str(dataset), "--output", str(out), *args]
    for kern in kernels:
        kern.launches = 0
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    universal.make_universal_step = recording
    try:
        t0 = time.perf_counter()
        run = ua.main(argv)                 # on the card: the entry point's default device
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        universal.make_universal_step = real
    launches = {kern.symbol: kern.launches for kern in kernels}
    cfg, steps = run.cfg, len(run.losses)
    vis_every = int(args[args.index("--vis-every") + 1]) if "--vis-every" in args else None
    validations = len(range(0, steps, vis_every)) if vis_every else 0
    size = run.images[0].shape[-1]
    at_shape = universal_launches(unet_cfg, size, cfg.grad_reps, steps, validations,
                                  cfg.remat_policy)
    expected = {kern.symbol: 0 for kern in kernels}
    for part in at_shape.values():
        for sym, n in part.items():
            expected[sym] += n
    require(launches == expected, ("universal", launches, expected))
    require(steps == cfg.max_steps == len(records), (steps, len(records)))
    require(all(math.isfinite(v) for v in run.losses), f"universal losses {run.losses}")
    require([r["loss"] for r in records] == run.losses, "the recorded steps are not the run's")
    for i, r in enumerate(records):
        require(r["pert_max"] <= cfg.eps + 1e-6, f"step {i}: |pert|_inf {r['pert_max']} over eps")
        require(r["perturbed_max"] <= 1.0 + 1e-6, f"step {i}: source + pert left [-1, 1]")
        require(r["move_l2"] <= cfg.step_size * (1 + 1e-4),
                f"step {i} moved pert by {r['move_l2']} (step_size {cfg.step_size})")
    pert = run.pert
    require(pert.abs().max().item() <= cfg.eps + 1e-6, "the final perturbation left the box")
    saved = np.load(out / "perturbation.npy")
    require(saved.shape == (1, size, size, 3) and saved.dtype == np.float32, saved.shape)
    require(np.array_equal(saved, pert.detach().cpu().permute(0, 2, 3, 1).numpy()),
            "perturbation.npy is not the run's perturbation in NHWC")
    names = ["perturbation.npy", "perturbed_example.png"]
    if vis_every:
        names += [f"validation_{k:05d}.png" for k in range(0, steps, vis_every)]
    require(sorted(p.name for p in out.iterdir()) == sorted(names), sorted(out.iterdir()))
    over = [(im + pert).abs().max().item() - 1.0 for im in run.images]
    return {"wall_s": wall, "s_per_step": [r["s"] for r in records],
            "s_per_step_after_first": sum(r["s"] for r in records[1:]) / max(1, steps - 1),
            "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
            "allocated_before_gb": before / 1e9, "losses": run.losses,
            "move_l2": [r["move_l2"] for r in records], "step_size": cfg.step_size,
            "pert_max": pert.abs().max().item(), "others_over_range": over,
            "remat_policy": cfg.remat_policy, "image_size": size, "validations": validations,
            "launches": launches, "expected_launches": expected, "launches_at_shape": at_shape,
            "artifacts": names, "_run": run}


def universal_step_inputs(universal, run, seed: int = 9):
    """One step of ``run``'s configuration on fresh draws: the step, the
    first dataset image, the final perturbation re-anchored to it (so that
    the update is the step's alone) and the draws."""
    import torch

    model, cfg = run.model, run.cfg
    prompts = [(cfg.default_prompt + " " + e).strip() for e in cfg.edit_prompts]
    bank = model.embed_prompt_bank(prompts)
    step = universal.make_universal_step(model, cfg, bank, preview=run.preview)
    src = run.images[0]
    pert = (src + run.pert.clamp(-cfg.eps, cfg.eps)).clamp(-1.0, 1.0) - src
    f = 2 ** (len(model.vae.config.block_out_channels) - 1)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    draws = universal.sample_universal_draws(
        gen, cfg.grad_reps, len(prompts),
        (model.vae.config.latent_channels, src.shape[-2] // f, src.shape[-1] // f),
        cfg.timestep_range, model.dtype)
    return step, src, pert, draws


def universal_gate(universal, run, layers) -> dict:
    """One universal step of ``run``'s configuration on the same draws
    through the kernels and through plain attention (the flash floor raised
    out of reach), twice: with the TAESD preview decode, as the entry point
    runs it, and with the full VAE decode.  Both run the same K1-K3
    attentions (encode and UNet; the full decode adds its mid-block).  The
    normalized step moves each element by about step_size / sqrt(3 H W)
    (7e-6 at 512x512), so the gate holds the updates, not the
    perturbations: the L2 norm of the difference of the two updates over
    the plain update's, and the losses within a relative 1e-4.

    The update through the preview is far more sensitive to f32 rounding
    than through the full decode (the TAESD decoder's ReLUs flip on tiny
    changes of their input), so each case also records its floor: the plain
    step with the UNet's epsilon moved by a relative 1e-6.  The full-decode
    update must agree within 1e-3, the preview's within 1e-2 (its floor
    measured about 1e-3 on an H100; see PERF.md)."""
    import dataclasses

    import torch

    def rel(a, b) -> float:
        return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

    model, out = run.model, {}
    real_unet = model.apply_unet
    for name, case, tol in (("taesd", run, 1e-2),
                            ("full_vae", dataclasses.replace(run, preview=None), 1e-3)):
        step, src, pert, draws = universal_step_inputs(universal, case)
        new_k, loss_k = step(pert, src, draws)
        floor = layers.MIN_CHUNKED_SEQ
        layers.MIN_CHUNKED_SEQ = 1 << 30        # every attention on the plain path
        gen = torch.Generator(device=model.device).manual_seed(5)

        def noisy_unet(*args, **kw):
            eps = real_unet(*args, **kw)
            return eps * (1 + 1e-6 * torch.randn(eps.shape, generator=gen, device=eps.device))

        try:
            new_p, loss_p = step(pert, src, draws)
            model.apply_unet = noisy_unet
            new_n, _ = step(pert, src, draws)
        finally:
            layers.MIN_CHUNKED_SEQ = floor
            model.__dict__.pop("apply_unet", None)
        r = out[name] = {"update_rel_diff": rel(new_k - pert, new_p - pert),
                         "floor_1e-6_rel_diff": rel(new_n - pert, new_p - pert),
                         "update_l2": torch.linalg.vector_norm(new_p - pert).item(),
                         "avg_loss_rel_diff": abs(loss_k.item() - loss_p.item()) / abs(loss_p.item()),
                         "update_tol": tol}
        require(r["update_rel_diff"] <= tol and r["avg_loss_rel_diff"] <= 1e-4,
                f"one universal step ({name} decode) through the kernels vs plain attention: {r}")
    return out


def decoder_costs(run) -> dict:
    """Device ms of one decode forward and backward at the universal rep's
    latent (CUDA events): the TAESD preview's, which every rep runs, and the
    full VAE decode's, which it replaces."""
    import torch

    model = run.model
    z = torch.randn((1, *model.latent_shape[1:]), device=model.device, requires_grad=True)

    def fwd_bwd(decode):
        def call():
            out = decode(z)
            torch.autograd.grad(out, [z], torch.ones_like(out))
        return call

    return {"taesd_ms": cuda_ms(fwd_bwd(run.preview.decode), 5),
            "full_vae_ms": cuda_ms(fwd_bwd(lambda zz: model.decode_latent(zz, scaled=True)), 3),
            "latent_shape": list(z.shape)}


def load_batch(paths, size):
    import numpy as np
    import torch

    from tml_image_editing_defense_torch.core.image_ops import load_image

    return torch.from_numpy(np.concatenate([load_image(p, size) for p in paths])).cuda()


def print_profile(tag: str, prof: dict) -> None:
    print(f"[profile] one {tag}: wall {prof['wall_ms']:.0f} ms, device busy "
          f"{prof['device_ms']:.0f} ms, idle share <= {prof['idle_share']:.3f}; by group (ms) "
          + ", ".join(f"{g} {ms:.0f}" for g, ms in prof["groups_ms"].items()), flush=True)
    for name, ms in prof["top_kernels_ms"]:
        print(f"[profile]   {ms:9.1f} ms  {name[:110]}")


def print_flops(tag: str, fl: dict, unit: str = "iteration") -> None:
    share = fl["share_of_peak"]
    print(f"[flops] {tag}: forward TFLOP "
          + ", ".join(f"{k} {v / 1e12:.3f}" for k, v in fl["forward_flops"].items())
          + f"; one {unit} {fl['iteration_flops'] / 1e12:.2f} TFLOP of useful work in "
          f"{fl['seconds']:.2f} s: " + (f"{share:.1%}" if share is not None else "not known")
          + f" of the {fl['dtype']} peak ({(fl['peak_flops'] or 0) / 1e12:.0f} TFLOP/s)",
          flush=True)


def free_card(held: Optional[dict] = None, after: str = "") -> None:
    """Drop what nothing references; with ``held``, record there what stays
    allocated ``after`` a path, which must be under HELD_LIMIT_GB."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    if held is not None:
        held[after] = gb = torch.cuda.memory_allocated() / 1e9
        PHASE_END_S[after] = time.perf_counter() - STARTED
        require(gb <= HELD_LIMIT_GB, f"{gb:.2f} GB stay allocated after the {after} path")


def main(argv) -> int:
    import argparse
    import dataclasses

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", type=Path, help="write the full report here as JSON")
    report_path = parser.parse_args(argv).report

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from PIL import Image

    from tml_image_editing_defense_torch import api, cli
    from tml_image_editing_defense_torch import universal_attack as ua
    from tml_image_editing_defense_torch.attack import universal
    from tml_image_editing_defense_torch.configs import TrainConfig
    from tml_image_editing_defense_torch.core.samplers import LCMSampler
    from tml_image_editing_defense_torch.core.schedule import make_noise_schedule
    from tml_image_editing_defense_torch.models import layers
    from tml_image_editing_defense_torch.models.model_zoo import build_model
    from tml_image_editing_defense_torch.models.unet import SD15_UNET, SDXL_UNET
    from tml_image_editing_defense_torch.ops import _lib
    from tml_image_editing_defense_torch.ops import flash_attention as fa
    from tml_image_editing_defense_torch.ops import pgd_kernels as pk
    from tml_image_editing_defense_torch.utils import flops
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
                          (ENC_ATTN_SHAPE, (torch.float32,)),
                          (EVAL_UNET_SHAPE, (torch.float32,)), (EVAL_VAE_SHAPE, (torch.float32,)),
                          (SDXL_EVAL_UNET_SHAPE, (torch.float32,)),
                          (SDXL_EVAL_VAE_SHAPE, (torch.float32,)),
                          (UX_UNET_SHAPE, (torch.float32, torch.bfloat16)),
                          (UX_VAE_SHAPE, (torch.float32, torch.bfloat16))):
        for dtype in dtypes:
            r = check_flash(fa, shape, dtype, gen, times=True)
            flash[f"{shape}-{r['dtype']}"] = r
            print(f"[kernels] flash {shape} {r['dtype']}: max abs err "
                  + ", ".join(f"{k} {r['err'][k]:.2e} (tol {r['tol'][k]:.1e})" for k in r["err"])
                  + "; ms " + ", ".join(f"{k} {v:.3f}" for k, v in r["ms"].items())
                  + "; plain ms " + ", ".join(f"{k} {v:.3f}" for k, v in r["plain_ms"].items())
                  + f"; bound ms at {r['peak_tflops']:.0f} TFLOP/s "
                  + ", ".join(f"{k} {v[0]:.3f} ({v[1]})" for k, v in r["bound"].items())
                  + "; device ms " + ", ".join(f"{k} {v:.3f}" for k, v in r["device_ms"].items())
                  + "; sdpa ms " + ", ".join(f"{k} {v:.3f}" for k, v in r["library_ms"].items())
                  + f"; K1 {r['ms']['fwd']:.3f} ms against SDPA's forward "
                  f"{r['library_ms']['fwd']:.3f} ms ({r['ms']['fwd'] / r['library_ms']['fwd']:.2f}x)"
                  + f" ({r['library_backend']['backend']} backend)"
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
    report["flash"], report["updates"] = flash, check_updates(pk, gen)
    PHASE_END_S["kernels"] = time.perf_counter() - STARTED

    kernels = fa.KERNELS + pk.KERNELS
    held = report["held_after_gb"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for i in range(1, 4 + 2 * ENC_BATCH):
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
        long_attn = unet_long_attentions(SD15_UNET, cfg.image_size)
        per_it = cfg.grad_reps * (2 * long_attn + 1) + 1
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
        print_profile("PGD iteration", report["profile"])
        d_steps = LCMSampler(make_noise_schedule()).plan(
            cfg.n_denoising_steps_per_iteration, limit_t=700).num_steps
        report["main_path"]["flops"] = fl = path_flops(
            "sd15", cfg, d_steps, ITERATIONS, diff["s_per_iteration_after_first"], torch.float32)
        print_flops("diffusion", fl)
        # the remat policies and the EOT chunk change where memory and time
        # go, not the math: path d's first iteration each way on the same draws
        for name, changes in (("remat", dict(remat_policy="full", remat_vae=True)),
                              ("eot_chunk", dict(eot_chunk=2))):
            g = report[f"{name}_gate"] = iteration_gate(result.model, cfg, inputs, changes)
            print(f"[gate] one SD-1.5 512x512 PGD iteration, {changes} against the defaults on "
                  f"the same draws: |x_adv diff|_max = {g['x_adv_max_abs_diff']:.2e} <= 1e-3, "
                  f"avg_loss {g['avg_loss_rel_diff']:.1e} relative; defaults "
                  f"{g['as_is']['s']:.2f} s, peak {g['as_is']['peak_gb']:.2f} GB; changed "
                  f"{g['changed']['s']:.2f} s, peak {g['changed']['peak_gb']:.2f} GB", flush=True)
        del inputs
        free_card()

        # ---- resume, then the evaluate gate, on the diffusion path's model ---
        res = report["resume"] = resume_path(
            api, cfg, result.model, result.x_adv, kernels,
            {"tid_flash_fwd": per_it, "tid_flash_bwd_kv": per_it, "tid_flash_bwd_q": per_it,
             "tid_pgd_l2_update": 1}, tmp)
        print(f"[resume] immunize resumed from the state after iteration 2: iteration 3 alone in "
              f"{res['wall_s']:.2f} s (its metrics row at {res['iteration_row_t_s']:.2f} s after "
              f"the loop's start); |x_adv - uninterrupted|_max = {res['x_adv_max_abs_diff']:.2e} "
              f"<= 1e-3; launches {res['launches']}", flush=True)
        gate = report["evaluate_gate"] = evaluate_gate(
            result.model, Image.open(source).convert("RGB"),
            Image.open(cfg.output_path / "adversarial_image.png").convert("RGB"), layers)
        print(f"[gate] one (clean, adv) pair, PLMS 10 steps at strength 0.6 ({gate['unet_steps']} "
              f"UNet calls), K1 against plain attention on the same weights: max abs diff "
              f"{gate['max_abs_diff']:.2e} (mean {gate['mean_abs_diff']:.2e}) <= 1e-3, finite",
              flush=True)

        # ---- the masked path, on the diffusion path's model ---------------
        # ISNet (RMBG-1.4, 1024x1024) once, then the diffusion path's
        # iterations with K4 taking the mask: the launches of path d, each
        # update through K4's masked entry and none through the unmasked one
        mcfg = dataclasses.replace(cfg, output_path=tmp / "out_masked", use_segmentation_mask=True,
                                   segmentation_model_path=str(tmp / "rmbg"))
        masked_start, masked_t0 = torch.cuda.memory_allocated(), time.perf_counter()
        per_it = cfg.grad_reps * (2 * long_attn + 1) + 1
        msk = masked_path(
            api, pk, mcfg, result.model, kernels,
            {"tid_flash_fwd": per_it, "tid_flash_bwd_kv": per_it, "tid_flash_bwd_q": per_it,
             "tid_pgd_l2_update_masked": 1},
            {"tid_flash_fwd": 1 + n_vis}, tmp)
        mask = msk.pop("_mask")
        del msk["_src"], msk["_tgt"]            # the diffusion path's src and tgt
        report["masked_path"] = msk
        print(f"[masked] RMBG-1.4 ISNet, {msk['isnet_params'] / 1e6:.2f} M parameters: "
              f"model.safetensors {msk['checkpoint_keys']} keys, {msk['checkpoint_bytes']} bytes; "
              f"forward at [1, 3, 1024, 1024] {msk['isnet_forward_ms']:.3f} ms (conv "
              f"{msk['isnet_forward_flops'] / 1e9:.1f} GFLOP, bound "
              f"{msk['isnet_forward_bound_ms']:.3f} ms at 67 TFLOP/s f32); salient_mask "
              f"{msk['salient_mask_wall_s'] * 1e3:.1f} ms wall "
              f"(again {msk['salient_mask_warm_wall_s'] * 1e3:.1f} ms), "
              f"peak {msk['isnet_peak_gb']:.2f} GB; mask share {msk['mask_share']:.4f} (heuristic "
              f"{msk['heuristic_share']:.4f})", flush=True)
        print(f"[masked] immunize sd15 512x512 f32 with the ISNet mask, {ITERATIONS} iterations x "
              f"{mcfg.grad_reps} reps: {msk['wall_s']:.1f} s in all (ISNet included), "
              f"{msk['s_per_iteration_after_first']:.2f} s/iteration after the first, peak "
              f"{msk['max_memory_allocated_gb']:.2f} GB above the "
              f"{msk['allocated_before_gb']:.2f} GB allocated before; losses "
              f"{[round(h['avg_loss'], 4) for h in msk['history']]}; |x_adv - src|_2 = "
              f"{msk['dist']:.3f} <= {mcfg.eps}; K4 with the mask "
              f"{msk['launches']['tid_pgd_l2_update_masked']} times, "
              f"x_adv at the source outside the mask after each; mask equal to ISNet's; "
              f"{msk['allocated_at_attack_data_gb']:.3f} GB above the model at make_attack_data; "
              f"launches {msk['launches']}", flush=True)
        inputs = one_iteration_inputs(result.model, mcfg, src, tgt, mask=mask)
        report["masked_vs_plain"] = check_iteration_against_plain(result.model, mcfg, inputs,
                                                                  layers)
        print(f"[model] one SD-1.5 512x512 masked PGD iteration, kernels vs plain attention and "
              f"the plain masked update: {report['masked_vs_plain']}", flush=True)
        del inputs, mask
        free_card()
        msk["held_above_start_gb"] = (torch.cuda.memory_allocated() - masked_start) / 1e9
        PHASE_END_S["masked"] = time.perf_counter() - STARTED
        msk["phase_s"] = time.perf_counter() - masked_t0
        print(f"[masked] phase m in {msk['phase_s']:.1f} s (ISNet alone, immunize, the gate)",
              flush=True)
        require(msk["held_above_start_gb"] <= HELD_LIMIT_GB,
                f"{msk['held_above_start_gb']:.2f} GB stay allocated after the masked path")
        del result
        free_card(held, "diffusion")

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
        per_it = icfg.grad_reps * (1 + n_unet * long_attn + 1)
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
        print_profile("inpaint iteration", report["inpaint_profile"])
        report["inpaint_path"]["flops"] = fl = path_flops(
            "sd15-inpaint", icfg, n_unet, ITERATIONS, inpaint["s_per_iteration_after_first"],
            torch.float32)
        print_flops("inpaint", fl)
        del result, inputs, src, tgt
        free_card(held, "inpaint")

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
        free_card(held, "encoder")

        # ---- evaluate, through the CLI --------------------------------------
        ev = report["evaluate_path"] = evaluate_path(cli, kernels, tmp / "out", source, target,
                                                     tmp / f"image{3 + 2 * ENC_BATCH}.png", tmp)
        print(f"[evaluate] evaluate sd15 512x512 f32, PLMS {ev['unet_steps']} UNet calls an edit, "
              f"{ev['cells']} cells in batches of {EVAL_BATCH} pairs: "
              + ", ".join(f"{d:.2f}" for d in ev["dispatch_s"]) + " s a batch, "
              + ", ".join(f"{d:.2f}" for d in ev["s_per_pair"]) + f" s a pair; {ev['wall_s']:.1f} s "
              f"in all (model build included); peak {ev['max_memory_allocated_gb']:.2f} GB "
              f"above the {ev['allocated_before_gb']:.2f} GB allocated before; launches {ev['launches']} "
              f"(K1 {ev['k1_launches_at_shape']})", flush=True)
        # a batch: the UNet calls for EVAL_BATCH (clean, adv) pairs with CFG,
        # and the encodes and decodes of its 2 * EVAL_BATCH images, forward only
        fwd = flops.diffusion_model_flops("sd15", 512, unet_batch=4 * EVAL_BATCH)
        ev["flops"] = fl = flops_share(
            fwd, ev["unet_steps"] * fwd["unet"]
            + 2 * EVAL_BATCH * (fwd["vae_encode"] + fwd["vae_decode"]),
            sum(ev["dispatch_s"]) / len(ev["dispatch_s"]), torch.float32)
        print_flops("evaluate", fl, unit="batch")
        free_card(held, "evaluate")
        report["eval_profile"] = profile_eval_batch(
            Image.open(source).convert("RGB"),
            Image.open(tmp / "out" / "adversarial_image.png").convert("RGB"))
        print_profile(f"evaluation batch ({EVAL_BATCH} pairs)", report["eval_profile"])
        free_card(held, "evaluation profile")

        # ---- the SDXL path ------------------------------------------------
        # At 512x512 no SDXL UNet attention reaches K1 (its 64x64 level has
        # none, T <= 1024 elsewhere), so per iteration K1-K3 run in the shared
        # encode and the 10 reps' decodes (VAE mid-block, forward + backward)
        # and K4 once; outside: the target encode and the 2 vis decodes.
        xcfg = TrainConfig(source_image_path=source, target_image_path=target,
                           output_path=tmp / "out_sdxl", n_optimization_steps=ITERATIONS,
                           use_sdxl=True)
        per_it = xcfg.grad_reps * (2 * unet_long_attentions(SDXL_UNET, xcfg.image_size) + 1) + 1
        xl = immunize_path(
            api, xcfg, kernels,
            {"tid_flash_fwd": per_it, "tid_flash_bwd_kv": per_it, "tid_flash_bwd_q": per_it,
             "tid_pgd_l2_update": 1},
            {"tid_flash_fwd": 1 + n_vis})
        result, src, tgt = xl.pop("_result"), xl.pop("_src"), xl.pop("_tgt")
        report["sdxl_path"] = xl
        print(f"[sdxl] immunize sdxl 512x512 f32, {ITERATIONS} iterations x {xcfg.grad_reps} reps: "
              f"{xl['wall_s']:.1f} s in all, {xl['s_per_iteration_after_first']:.2f} s/iteration "
              f"after the first, peak {xl['max_memory_allocated_gb']:.1f} GB above the "
              f"{xl['allocated_before_gb']:.2f} GB allocated before; losses "
              f"{[round(h['avg_loss'], 4) for h in xl['history']]}; |x_adv - src|_2 = "
              f"{xl['dist']:.3f} <= {xcfg.eps}; launches {xl['launches']}", flush=True)
        inputs = one_iteration_inputs(result.model, xcfg, src, tgt)
        report["sdxl_vs_plain"] = check_iteration_against_plain(result.model, xcfg, inputs, layers)
        print(f"[model] one SDXL 512x512 PGD iteration, kernels vs plain attention and plain "
              f"update: {report['sdxl_vs_plain']}", flush=True)
        report["sdxl_profile"] = profile_iteration(result.model, xcfg, inputs)
        print_profile("SDXL PGD iteration", report["sdxl_profile"])
        report["sdxl_path"]["flops"] = fl = path_flops(
            "sdxl", xcfg, d_steps, ITERATIONS, xl["s_per_iteration_after_first"], torch.float32)
        print_flops("sdxl", fl)
        del inputs, src, tgt
        free_card()
        xl_images = sdxl_eval_images(tmp, xcfg.eps)
        gate = report["sdxl_evaluate_gate"] = evaluate_gate(
            dataclasses.replace(result.model, image_size=SDXL_EVAL_SIZE),
            *(Image.open(xl_images["paths"][k]).convert("RGB") for k in ("source", "adversarial")),
            layers, sampler=api.training_sampler_kind(result.model.base_family, use_lcm=False))
        print(f"[gate] one SDXL (clean, adv) pair at {SDXL_EVAL_SIZE}x{SDXL_EVAL_SIZE}, "
              f"{gate['sampler']} 10 steps at strength 0.6 ({gate['unet_steps']} UNet calls), K1 "
              f"against plain attention on the same weights: max abs diff "
              f"{gate['max_abs_diff']:.2e} (mean {gate['mean_abs_diff']:.2e}) <= 1e-3, finite",
              flush=True)
        del result
        free_card(held, "sdxl")

        # ---- SDXL evaluate at 1024x1024, through the CLI ---------------------
        xev = report["sdxl_evaluate_path"] = sdxl_evaluate_path(cli, kernels, xl_images, tmp)
        print(f"[sdxl-evaluate] evaluate sdxl {SDXL_EVAL_SIZE}x{SDXL_EVAL_SIZE} f32, Euler "
              f"{xev['unet_steps']} UNet calls an edit, one cell: {xev['s_per_cell']:.2f} s a "
              f"cell, {xev['wall_s']:.1f} s in all (model build included); peak "
              f"{xev['max_memory_allocated_gb']:.2f} GB above the "
              f"{xev['allocated_before_gb']:.2f} GB allocated before; launches {xev['launches']} "
              f"(K1 {xev['k1_launches_at_shape']}); adversarial PNG at L2 "
              f"{xev['adversarial_l2']:.2f}", flush=True)
        free_card(held, "sdxl-evaluate")

        # ---- the universal attack, SD-1.5 at 512x512 -------------------------
        # universal_attack.main at its defaults (TAESD preview, 4 reps, eps
        # 0.1, step 0.006, remat "none") over UNIVERSAL_IMAGES images; per
        # rep K1-K3 run the VAE encoder's mid-block and the UNet's 5 long
        # self-attentions, forward and backward; a validation adds an
        # encode, a UNet call and a full decode, forward only
        u_data = tmp / "universal_images"
        u_data.mkdir()
        for i in range(UNIVERSAL_IMAGES):
            synthetic_image(u_data / f"u{i}.png", 200 + i)
        uni = universal_path(
            ua, universal, kernels, u_data, tmp / "out_universal",
            ["--family", "sd15", "--steps", str(UNIVERSAL_STEPS), "--epochs", "2",
             "--vis-every", str(UNIVERSAL_VIS_EVERY)], SD15_UNET)
        run = uni.pop("_run")
        report["universal_path"] = uni
        print(f"[universal] universal_attack sd15 512x512 f32, TAESD preview, {UNIVERSAL_STEPS} "
              f"steps x {run.cfg.grad_reps} reps over {UNIVERSAL_IMAGES} images, "
              f"{uni['validations']} validations: {uni['wall_s']:.1f} s in all (model build "
              f"included), {uni['s_per_step_after_first']:.3f} s/step after the first (steps "
              + ", ".join(f"{v:.3f}" for v in uni["s_per_step"]) + f"), peak "
              f"{uni['max_memory_allocated_gb']:.2f} GB; losses "
              f"{[round(v, 4) for v in uni['losses']]}; step moves (L2) "
              + ", ".join(f"{v:.5f}" for v in uni["move_l2"]) + f" <= {run.cfg.step_size}; "
              f"|pert|_inf {uni['pert_max']:.4f} <= {run.cfg.eps}; launches {uni['launches']} "
              f"({uni['launches_at_shape']})", flush=True)
        gate = report["universal_vs_plain"] = universal_gate(universal, run, layers)
        print(f"[model] one SD-1.5 512x512 universal step, kernels vs plain attention, same draws "
              f"(TAESD decode, then the full VAE decode): {gate}", flush=True)
        inputs = universal_step_inputs(universal, run)
        inputs[0](*inputs[1:])                  # warm-up of the profiled step
        report["universal_profile"] = prof = profile_call(lambda: inputs[0](*inputs[1:]))
        print_profile("universal step", prof)
        uni["flops"] = fl = universal_flops("sd15", 512, "taesd", run.cfg.grad_reps,
                                            uni["s_per_step_after_first"])
        print_flops("universal", fl, unit="step")
        dec = report["universal_decoders"] = decoder_costs(run)
        reps = run.cfg.grad_reps
        print(f"[universal] decode forward + backward at {dec['latent_shape']}: TAESD "
              f"{dec['taesd_ms']:.2f} ms, full VAE {dec['full_vae_ms']:.2f} ms; {reps} TAESD "
              f"decodes are {reps * dec['taesd_ms'] / prof['device_ms']:.1%} of the step's device "
              f"time, {reps} full decodes would add "
              f"{reps * (dec['full_vae_ms'] - dec['taesd_ms']):.0f} ms to it", flush=True)
        del run, inputs
        free_card(held, "universal")

        # ---- the universal attack, SDXL at 1024x1024 with remat "full" -------
        # per rep K1-K3 run the VAE encoder's mid-block ([1, 16384, 1, 512])
        # and the UNet's 10 long self-attentions ([2, 4096, 10, 64]); every
        # forward runs twice (the checkpoint's recompute)
        uxr = universal_path(
            ua, universal, kernels, u_data, tmp / "out_universal_sdxl",
            ["--family", "sdxl", "--steps", str(UNIVERSAL_SDXL_STEPS), "--remat-policy", "full"],
            SDXL_UNET)
        run = uxr.pop("_run")
        report["universal_sdxl_path"] = uxr
        print(f"[universal-sdxl] universal_attack sdxl {uxr['image_size']}x{uxr['image_size']} "
              f"f32, remat full, TAESD preview, {UNIVERSAL_SDXL_STEPS} steps x "
              f"{run.cfg.grad_reps} reps: {uxr['wall_s']:.1f} s in all (model build included), "
              f"{uxr['s_per_step_after_first']:.2f} s/step after the first (steps "
              + ", ".join(f"{v:.2f}" for v in uxr["s_per_step"]) + f"), peak "
              f"{uxr['max_memory_allocated_gb']:.2f} GB above the "
              f"{uxr['allocated_before_gb']:.2f} GB allocated before; losses "
              f"{[round(v, 4) for v in uxr['losses']]}; step moves (L2) "
              + ", ".join(f"{v:.5f}" for v in uxr["move_l2"]) + f"; |pert|_inf "
              f"{uxr['pert_max']:.4f}; launches {uxr['launches']} ({uxr['launches_at_shape']})",
              flush=True)
        uxr["flops"] = fl = universal_flops("sdxl", uxr["image_size"], "taesdxl",
                                            run.cfg.grad_reps, uxr["s_per_step_after_first"])
        print_flops("universal-sdxl", fl, unit="step")
        # the path ran these shapes just before: no warm-up
        inputs = universal_step_inputs(universal, run)
        report["universal_sdxl_profile"] = profile_call(lambda: inputs[0](*inputs[1:]))
        print_profile("SDXL 1024x1024 universal step (remat full)", report["universal_sdxl_profile"])
        del run, inputs
        free_card(held, "universal-sdxl")

        # ---- SDXL immunize at 1024x1024 in bf16 (xl1k) -----------------------
        # The JAX package's configuration (scripts/probe_sdxl_1024.py:134-140):
        # bf16, remat "full" with remat_vae, the L2 preset (10 reps, LCM K=4
        # with t < 700: 2 UNet steps).  Per iteration (pgd_launches): each
        # rep's 2 UNet calls run the 10 long self-attentions of the 64x64
        # level, K1 twice (the step's recompute) and K2, K3 once each; the
        # shared encode and each rep's decode K1 twice (remat_vae) and K2, K3
        # once; K4 once.  Outside: the target encode and 2 vis decodes.
        x1t0 = time.perf_counter()
        x1cfg = TrainConfig(source_image_path=xl_images["paths"]["source"],
                            target_image_path=xl_images["paths"]["target"],
                            output_path=tmp / "out_sdxl_1024",
                            n_optimization_steps=XL1K_ITERATIONS, use_sdxl=True,
                            image_size=XL1K_SIZE, dtype="bfloat16", remat_policy="full",
                            remat_vae=True)
        x1_per_it = pgd_launches(SDXL_UNET, x1cfg, d_steps)
        x1 = immunize_path(api, x1cfg, kernels, x1_per_it,
                           {"tid_flash_fwd": 1 + len({0, XL1K_ITERATIONS - 1})})
        result, src, tgt = x1.pop("_result"), x1.pop("_src"), x1.pop("_tgt")
        x1["per_iteration_launches"] = x1_per_it
        # by shape: the UNet's (forward twice under remat "full") and the VAE's
        # (the shared encode and each rep's decode, twice under remat_vae;
        # the target encode and the vis decodes once)
        unet_n = XL1K_ITERATIONS * x1cfg.grad_reps * d_steps * unet_long_attentions(SDXL_UNET,
                                                                                    XL1K_SIZE)
        vae_n = XL1K_ITERATIONS * (x1cfg.grad_reps + 1)
        x1["launches_at_shape"] = {
            "unet": {"tid_flash_fwd": 2 * unet_n, "tid_flash_bwd_kv": unet_n,
                     "tid_flash_bwd_q": unet_n},
            "vae": {"tid_flash_fwd": 2 * vae_n + 1 + len({0, XL1K_ITERATIONS - 1}),
                    "tid_flash_bwd_kv": vae_n, "tid_flash_bwd_q": vae_n}}
        require(all(x1["launches_at_shape"]["unet"][k] + x1["launches_at_shape"]["vae"][k]
                    == x1["launches"][k] for k in x1["launches_at_shape"]["unet"]),
                ("sdxl-1024 launches by shape", x1["launches_at_shape"], x1["launches"]))
        report["sdxl_1024_path"] = x1
        print(f"[sdxl-1024] immunize sdxl {XL1K_SIZE}x{XL1K_SIZE} bf16, remat full + remat_vae, "
              f"{XL1K_ITERATIONS} iterations x {x1cfg.grad_reps} reps: {x1['wall_s']:.1f} s in "
              f"all (model build included), {x1['s_per_iteration_after_first']:.2f} s for the "
              f"second iteration, peak {x1['max_memory_allocated_gb']:.2f} GB above the "
              f"{x1['allocated_before_gb']:.2f} GB allocated before (the model built in the "
              f"path); losses {[round(h['avg_loss'], 4) for h in x1['history']]}; |x_adv - "
              f"src|_2 = {x1['dist']:.3f} <= {x1cfg.eps}; launches per iteration {x1_per_it} "
              f"(predicted from the UNet config, the VAE mid-blocks and the remat recompute), "
              f"in all {x1['launches']}", flush=True)
        inputs = one_iteration_inputs(result.model, x1cfg, src, tgt)
        report["sdxl_1024_profile"] = profile_iteration(result.model, x1cfg, inputs)
        print_profile("SDXL 1024x1024 bf16 PGD iteration (remat full, remat_vae)",
                      report["sdxl_1024_profile"])
        x1["flops"] = fl = path_flops("sdxl", x1cfg, d_steps, XL1K_ITERATIONS,
                                      x1["s_per_iteration_after_first"], torch.bfloat16)
        print_flops("sdxl-1024", fl)
        del result, inputs
        free_card(held, "sdxl-1024")
        # the kernels against plain attention at 1024x1024, in f32 (the other
        # paths' tolerance): one iteration of 1 rep on an f32 SDXL, same remat
        gcfg = dataclasses.replace(x1cfg, dtype="float32", derive_norm_hyperparams=False,
                                   grad_reps=1, output_path=tmp / "out_sdxl_1024_gate")
        gmodel = build_model("sdxl", image_size=XL1K_SIZE, device="cuda", dtype="float32",
                             generator=torch.Generator(device="cuda").manual_seed(gcfg.seed),
                             attn_kv_chunk=api._train_attn_chunk(XL1K_SIZE))
        inputs = one_iteration_inputs(gmodel, gcfg, src.float(), tgt.float())
        report["sdxl_1024_vs_plain"] = check_iteration_against_plain(gmodel, gcfg, inputs, layers)
        print(f"[model] one SDXL {XL1K_SIZE}x{XL1K_SIZE} f32 PGD iteration of 1 rep (remat full, "
              f"remat_vae), kernels vs plain attention and plain update: "
              f"{report['sdxl_1024_vs_plain']}", flush=True)
        del gmodel, inputs, src, tgt
        free_card(held, "sdxl-1024-gate")
        x1["phase_s"] = time.perf_counter() - x1t0
        print(f"[sdxl-1024] phase xl1k in {x1['phase_s']:.1f} s (immunize, the profile, the f32 "
              f"gate)", flush=True)
        print("[memory] GB allocated on the card after each path: "
              + ", ".join(f"{k} {v:.3f}" for k, v in held.items())
              + f" (limit {HELD_LIMIT_GB})", flush=True)
        report["phase_end_s"] = PHASE_END_S
        print("[time] seconds since the start at the end of each phase: "
              + ", ".join(f"{k} {v:.0f}" for k, v in PHASE_END_S.items()), flush=True)

    report["kernels"] = rows = kernel_rows(flash, report["updates"], report)
    if report_path is not None:
        report_path.parent.mkdir(parents=True, exist_ok=True)
        report_path.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def kernel_rows(flash, updates, report) -> list:
    """One row per kernel and shape for the result's kernels line.  Each
    row's ``launches`` is the count of the path named by ``path``, read just
    after that path ran, and ``launches_by_path`` the kernel's count on
    every path (the evaluate rows also split K1's count by shape, as the
    code implies it).  ``ms`` is the CUDA-event mean over back-to-back calls
    from the host (host time included); ``device_ms`` the median of the
    kernels' own spans with the operands in L2, and for K4 and K5
    ``device_cold_ms`` the same after a 128 MB write."""
    src_fa = "tml_image_editing_defense_torch/csrc/flash_attention.cu"
    tpu_fa = "tml_image_editing_defense_tpu/ops/flash_attention.py"
    src_pgd = "tml_image_editing_defense_torch/csrc/pgd_update.cu"
    tpu_pgd = "tml_image_editing_defense_tpu/ops/pgd_kernels.py"
    launches = {"diffusion": report["main_path"]["launches"],
                "inpaint": report["inpaint_path"]["launches"],
                "encoder": report["encoder_path"]["launches"],
                "resume": report["resume"]["launches"],
                "masked": report["masked_path"]["launches"],
                "evaluate": report["evaluate_path"]["launches"],
                "sdxl": report["sdxl_path"]["launches"],
                "sdxl-evaluate": report["sdxl_evaluate_path"]["launches"],
                "universal": report["universal_path"]["launches"],
                "universal-sdxl": report["universal_sdxl_path"]["launches"],
                "sdxl-1024": report["sdxl_1024_path"]["launches"]}
    by_path = lambda sym: {path: counts[sym] for path, counts in launches.items()}  # noqa: E731
    at_shape = {(path, shape): report[f"{path.replace('-', '_')}_path"]["k1_launches_at_shape"][part]
                for path, (unet, vae) in (("evaluate", (EVAL_UNET_SHAPE, EVAL_VAE_SHAPE)),
                                          ("sdxl-evaluate", (SDXL_EVAL_UNET_SHAPE,
                                                             SDXL_EVAL_VAE_SHAPE)))
                for part, shape in (("unet", unet), ("vae", vae))}
    # the universal paths and xl1k run forward and backward: launches at each
    # shape by kernel
    by_shape = {(path, shape): report[f"{path.replace('-', '_')}_path"]["launches_at_shape"][part]
                for path, (unet, vae) in (("universal", (UNET_SHAPE, VAE_SHAPE)),
                                          ("universal-sdxl", (UX_UNET_SHAPE, UX_VAE_SHAPE)),
                                          ("sdxl-1024", (UX_UNET_SHAPE, UX_VAE_SHAPE)))
                for part, shape in (("unet", unet), ("vae", vae))}
    rows = []
    for path, shape in (("diffusion", UNET_SHAPE), ("inpaint", UNET_SHAPE),
                        ("encoder", ENC_ATTN_SHAPE), ("evaluate", EVAL_UNET_SHAPE),
                        ("evaluate", EVAL_VAE_SHAPE), ("sdxl", VAE_SHAPE),
                        ("sdxl-evaluate", SDXL_EVAL_UNET_SHAPE),
                        ("sdxl-evaluate", SDXL_EVAL_VAE_SHAPE), *by_shape):
        dtype = "bfloat16" if path == "sdxl-1024" else "float32"
        r = flash[f"{shape}-{dtype}"]
        for name, sym, key, line in (("flash_fwd", "tid_flash_fwd", "fwd", 69),
                                     ("flash_bwd_kv", "tid_flash_bwd_kv", "bwd_kv", 148),
                                     ("flash_bwd_q", "tid_flash_bwd_q", "bwd_q", 185)):
            if (path, shape) in at_shape and key != "fwd":
                continue                    # evaluation runs the forward only
            row = {
                "name": name, "route": "cuda", "source": src_fa, "replaces": f"{tpu_fa}:{line}",
                "launches": launches[path][sym], "launches_by_path": by_path(sym),
                "max_abs_err": r["err"][key],
                "ms": r["ms"][key], "device_ms": r["device_ms"][key],
                "plain_ms": r["plain_ms"][key],
                "bound_ms": r["bound"][key][0], "bound_by": r["bound"][key][1],
                "library_ms": r["library_ms"]["fwd" if key == "fwd" else "bwd"],
                "library_call": (f"scaled_dot_product_attention forward "
                                 f"({r['library_backend']['backend']} backend)" if key == "fwd"
                                 else "scaled_dot_product_attention backward: K2 and K3 together"),
                "path": path, "shape": list(shape), "dtype": dtype, "ok": True,
            }
            if (path, shape) in at_shape:
                row["launches_at_shape"] = at_shape[(path, shape)]
            if (path, shape) in by_shape:
                row["launches_at_shape"] = by_shape[(path, shape)][sym]
            rows.append(row)
    update_rows = [("pgd_l2_update", path, "tid_pgd_l2_update", 118, updates["l2"][key])
                   for path, key in (("diffusion", "f32"), ("sdxl", "f32"),
                                     ("sdxl-1024", "bf16-1024"))]
    update_rows += [("pgd_linf_update", path, "tid_pgd_linf_update", 64,
                     updates["linf"][f"{shape}-float32"])
                    for path, shape in (("inpaint", IMAGE_SHAPE), ("encoder", ENC_IMAGE_SHAPE))]
    # the masked body (line 133), K4's masked entry, on path m
    update_rows.append(("pgd_l2_update_masked", "masked", "tid_pgd_l2_update_masked", 133,
                        updates["l2"]["f32-mask"]))
    for name, path, sym, line, r in update_rows:
        rows.append({
            "name": name, "route": "cuda", "source": src_pgd, "replaces": f"{tpu_pgd}:{line}",
            "launches": launches[path][sym], "launches_by_path": by_path(sym),
            "max_abs_err": r["err"], "ms": r["host_call_ms"],
            "device_ms": r["device"]["ms"], "device_cold_ms": r["device_cold"]["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None, "path": path, "shape": r["shape"], "dtype": r["dtype"],
            "ok": True,
        })
    return rows


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
