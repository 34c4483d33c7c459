"""Driver of the PGD immunization traffic: a batch of images attacked
through the program's main path, ``attack/pgd.py::run_pgd`` over a batched
``AttackData`` (``batch_attack_data``) with ``make_batched_pgd_step``, as
``api.immunize_batch`` runs it.

Set-up builds the model on ``meta``, loads the benchmark's seeded weights
into its UNet and VAE, assembles the attack's data from the benchmark's
images, prompt bank and noise pools, and runs iteration 0 through
``run_pgd`` (the warm-up, every shape of the window).  The window continues
the same iterate through ``run_pgd`` until its deadline, with no wait
between iterations; ``run_pgd``'s stop flag reads the host clock before each
iteration.  The draws of iteration ``it`` of image ``i`` are the
benchmark's (``portbench/data.py``), handed to the program through
``run_pgd``'s ``draw_sampler``.

The check, after the window: every image-iteration's loss is finite and its
iterate inside the eps-ball and [-1, 1]; and the reference
(``portbench/reference``) recomputes iteration 0 (from the source) and one
window iteration drawn from the seed (from the program's iterate before it)
for every image, on freshly drawn weights.  Compared: ``loss_gap``, the
largest relative gap of an image's mean loss, and ``update_gap``, the
largest ||update - reference update||_2 of an image over the length of one
unprojected step, the reference's iterate rounded to the program's dtype.
The cell's limits file names the numbers compared.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Optional

import torch

from portbench import counts, data, trace
from portbench.reference import attack as ref_attack
from portbench.reference import models as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Deadline:
    """``run_pgd``'s stop flag: true once the host clock passes ``end``."""

    def __init__(self, end: Optional[float] = None):
        self.end = end

    def __bool__(self):
        return self.end is not None and time.perf_counter() >= self.end


def program_step(drv):
    """The program's batched step over the driver's model, sampler and plan."""
    return drv.pgd.make_batched_pgd_step(drv.model, drv.sampler, drv.plan, drv.cfg)


class Driver:
    """One cell's program state.  ``step_factory(driver) -> step`` stands in
    for :func:`program_step` (``portbench/controls.py`` breaks the step or
    puts the reference in its place with it).  ``phases``: the set-up's
    seconds by phase, each ended by a wait for the card."""

    def __init__(self, cell, seed: int, device, step_factory=None):
        from tml_image_editing_defense_torch.api import training_sampler_kind
        from tml_image_editing_defense_torch.attack import pgd
        from tml_image_editing_defense_torch.configs import TrainConfig
        from tml_image_editing_defense_torch.core.samplers import make_sampler
        from tml_image_editing_defense_torch.models.model_zoo import PromptBank, build_model

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.pgd = pgd
        self.phases, t0 = {}, time.perf_counter()
        cfg_file, tr = cell.config, cell.traffic
        self.dtype_name = cfg_file["dtype"]
        self.dtype = DTYPES[self.dtype_name]
        self.size, self.images = tr["image_size"], tr["images"]
        self.train = tr["train"]
        self.cfg = TrainConfig(**self.train, image_size=self.size, dtype=self.dtype_name,
                               derive_norm_hyperparams=False, n_noise=tr["noise_pool"],
                               image_visualization_interval=1, enable_visualization=False)
        model = build_model(cfg_file["port_family"], image_size=self.size, device="meta",
                            dtype=self.dtype, attn_kv_chunk=tr.get("attn_kv_chunk"))
        weights = self._weights()
        for name in ("unet", "vae"):
            net = getattr(model, name).to(self.dtype).to_empty(device=self.device)
            net.load_state_dict(weights[name], strict=True)
        del weights
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = self._phase("model_and_weights", t0)
        self.model = dataclasses.replace(model, device=self.device)
        self.sampler = make_sampler(training_sampler_kind(self.model.base_family,
                                                          self.cfg.use_lcm),
                                    self.model.schedule)
        self.plan = self.sampler.plan(self.cfg.n_denoising_steps_per_iteration,
                                      limit_t=700 if self.cfg.limit_timesteps else None)
        self.latent = tuple(self.model.latent_shape[1:])

        text = cfg_file["text"]
        b = self.images
        self.src = data.images(self.device, seed, b, self.size, self.dtype, 0)
        self.tgt = data.images(self.device, seed, b, self.size, self.dtype, 1)
        self.bank = data.prompt_bank(self.device, seed, tr["bank_rows"], text["tokens"],
                                     text["width"], text.get("pooled_width", 0), self.dtype)
        self.pools, self.target_eps = data.noise_pools(self.device, seed, b, tr["noise_pool"],
                                                       self.latent, self.dtype)
        bank = PromptBank(*(None if t is None else t.clone() for t in self.bank))
        self.batched = pgd.batch_attack_data([
            pgd.make_attack_data(self.model, self.cfg, self.src[i:i + 1].clone(),
                                 self.tgt[i:i + 1].clone(), bank, self.pools[i].clone(),
                                 target_latent_eps=self.target_eps[i].clone())
            for i in range(b)])
        self.step = (step_factory or program_step)(self)
        t0 = self._phase("data_and_step", t0)
        # iterates[it]: the batch after iteration it; losses[it]: its mean losses
        self.iterates, self.losses = {}, {}
        # issued[it]: host clock when iteration it had been issued
        self.issued = {}
        self.window_iterations = 0
        _, hist = self._run(self.src.clone(), 0, 1)
        self.losses[0] = [h[0]["avg_loss"] for h in hist]
        self._phase("warm_iteration", t0)

    def _phase(self, name: str, t0: float) -> float:
        sync(self.device)
        t = time.perf_counter()
        self.phases[name] = t - t0
        return t

    # -- program ----------------------------------------------------------

    def _weights(self):
        unet, vae = counts.meta_models(self.cell.config)
        return data.seeded_weights({"unet": unet, "vae": vae}, self.seed, self.device,
                                   self.dtype)

    def _draws(self, it: int, image: int) -> dict:
        return data.draws(self.device, self.seed, it, image, self.cell.traffic["bank_rows"],
                          self.train["grad_reps"], self.plan.num_steps, self.latent,
                          self.cell.traffic["noise_pool"], self.dtype)

    def _run(self, x, start: int, stop: int, deadline: Optional[float] = None, spans=False):
        """``run_pgd`` from iterate ``x`` at iteration ``start``, up to
        ``stop`` (exclusive) or the deadline."""
        pgd, b = self.pgd, self.images
        counter = [start * b]

        def draw(_generator):
            it, i = divmod(counter[0], b)
            counter[0] += 1
            return pgd.EOTDraws(**self._draws(it, i))

        def keep(it, x_adv, _aux):
            self.iterates[it] = x_adv
            self.issued[it] = time.perf_counter()

        step = self.step
        if spans:
            draw, step = _spanned("portbench.draws", draw), _spanned("portbench.step", step)
        cfg = dataclasses.replace(self.cfg, n_optimization_steps=stop)
        return pgd.run_pgd(self.model, self.sampler, self.plan, cfg, self.batched, [0] * b,
                           vis_callback=keep, vis_needs_image=False, step_fn=step,
                           draw_sampler=draw, x_init=x, start_iteration=start,
                           stop_flag=_Deadline(deadline))

    def window(self, seconds: float, max_steps: Optional[int] = None) -> dict:
        """Whole iterations until ``seconds`` have passed (or ``max_steps``
        are done); the time runs to the wait after the last one."""
        sync(self.device)
        t0 = time.perf_counter()
        stop = 1 + (max_steps or 1 << 60)
        _, hist = self._run(self.iterates[0], 1, stop, deadline=t0 + seconds)
        sync(self.device)
        dt = time.perf_counter() - t0
        n = sum("avg_loss" in h for h in hist[0])  # a stop adds a marker entry
        for k in range(n):
            self.losses[1 + k] = [h[k]["avg_loss"] for h in hist]
        self.window_iterations = n
        marks = [t0] + [self.issued[1 + k] for k in range(n)]
        return {"seconds": dt, "steps": n, "units": n * self.images,
                "issued_s": [b - a for a, b in zip(marks, marks[1:])]}

    def traced(self, steps: int):
        """``steps`` more iterations, with the driver's host spans, for the
        profiler; returns (fn, steps, units)."""
        start = 1 + self.window_iterations

        def fn():
            with trace.span("portbench.run_pgd"):
                self._run(self.iterates[start - 1], start, start + steps, spans=True)
        return fn, steps, steps * self.images

    def work(self) -> dict:
        """The work of one image-iteration and the card's peaks."""
        w = counts.unit_work(self.cell.config, self.cell.traffic)
        kind = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        pk = counts.peak(kind, self.dtype_name)
        w["peak"] = pk
        if pk is not None:
            w["attention_bound_s"] = counts.attention_bound_s(
                w["long_attention"], torch.finfo(self.dtype).bits // 8, pk)
        return w

    def release(self) -> None:
        """Drop the program's state; the iterates the check reads stay."""
        for name in ("model", "batched", "step", "sampler"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- check ------------------------------------------------------------

    def failures(self) -> dict:
        """Image-iterations of the window whose loss is not finite or whose
        iterate left the eps-ball or [-1, 1] (beyond one rounding unit a
        pixel)."""
        eps, unit = self.train["eps"], torch.finfo(self.dtype).eps
        failed = 0
        for it in range(1, self.window_iterations + 1):
            d = (self.iterates[it].float() - self.src.float()).flatten(1)
            if self.train["norm_type"] == "l2":
                dist = torch.linalg.vector_norm(d, dim=1)
                bad = dist > eps + unit * d.shape[1] ** 0.5
            else:
                bad = d.abs().amax(dim=1) > eps + unit
            x = self.iterates[it].flatten(1).float()
            bad |= (x.amin(dim=1) < -1.0) | (x.amax(dim=1) > 1.0)
            bad |= ~torch.isfinite(torch.tensor(self.losses[it], device=bad.device))
            failed += int(bad.sum())
        return {"attempted": self.window_iterations * self.images, "failed": failed}

    def checked_iterations(self):
        """Iteration 0 and one window iteration drawn from the seed."""
        n = self.window_iterations
        return [0, 1 + data.derive(self.seed, data.CHECK) % n] if n else [0]

    def reference(self):
        """The reference's UNet, VAE and attack on freshly drawn weights."""
        unet, vae = counts.meta_models(self.cell.config)
        weights = self._weights()
        for name, net in (("unet", unet), ("vae", vae)):
            net.load_state_dict(weights[name], strict=True, assign=True)
            net.requires_grad_(False)
        atk = ref_attack.make_attack(self.train, self.cell.config["scheduler"],
                                     self.cell.config["vae"]["scaling_factor"])
        return unet, vae, atk

    def reference_iteration(self, models, it: int, x_in, quant=None):
        """The reference's (x_out [B, 3, H, W] in the iterate's dtype, mean
        losses) of iteration ``it`` from ``x_in``, ``reference_block``
        images at a time (the check's file; 1 by default)."""
        unet, vae, atk = models
        emb, unc, pooled, unc_pooled = self.bank
        tid = (ref_attack.time_ids(self.size, self.device)
               if self.cell.config["unet"].get("addition_embed_type") == "text_time" else None)
        block = self.cell.limits.get("reference_block", 1)
        outs, losses = [], []
        ref.NUMERICS.quant = quant
        try:
            for i0 in range(0, self.images, block):
                ids = range(i0, min(i0 + block, self.images))
                draws = [self._draws(it, i) for i in ids]
                conds = []
                for d in draws:
                    p = int(d["prompt_idx"])
                    conds.append((torch.stack([unc, emb[p]]),
                                  None if pooled is None else torch.stack([unc_pooled, pooled[p]]),
                                  tid))
                x, loss = ref_attack.iteration(unet, vae, atk, x_in[ids.start:ids.stop],
                                               self.src[ids.start:ids.stop],
                                               self.tgt[ids.start:ids.stop], conds,
                                               [self.pools[i] for i in ids], draws)
                outs.append(x.to(self.dtype))
                losses += loss
        finally:
            ref.NUMERICS.quant = None
        return torch.cat(outs), losses

    def nominal_step(self) -> float:
        """The L2 length of one unprojected step of one image."""
        if self.train["norm_type"] == "l2":
            return self.train["step_size"]
        return self.train["step_size"] * (3 * self.size * self.size) ** 0.5

    def check(self, limits: dict, models=None, iterations=None) -> dict:
        """``readings``: every number the check computes; ``numbers``: those
        with a limit in the cell's file, each ``{"value", "limit"}``;
        ``iterations``: the iterations they cover (default
        :meth:`checked_iterations`).  ``reference_out`` keeps the
        reference's answers by iteration."""
        models = models or self.reference()
        loss_gap = update_gap = 0.0
        its = iterations or self.checked_iterations()
        self.reference_out = {}
        for it in its:
            x_in = self.src if it == 0 else self.iterates[it - 1]
            x_ref, l_ref = self.reference_out[it] = self.reference_iteration(models, it, x_in)
            loss_gap = max(loss_gap, loss_gaps(self.losses[it], l_ref))
            update_gap = max(update_gap, update_gaps(x_in, self.iterates[it], x_ref,
                                                     self.nominal_step()))
        del models
        readings = {"loss_gap": loss_gap, "update_gap": update_gap}
        return {"readings": readings, "iterations": its,
                "numbers": {k: {"value": v, "limit": limits[k]} for k, v in readings.items()
                            if k in limits}}


def loss_gaps(losses, ref_losses) -> float:
    """The largest relative gap of a loss; infinite where one is not finite."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def update_gaps(x_in, x_out, x_ref, nominal: float) -> float:
    """The largest, over the images, ||update - reference update|| over the
    length of one unprojected step (the projection onto the eps-ball
    shortens later updates, so a ratio to the reference's own update would
    grow through the run)."""
    a = (x_out.float() - x_in.float()).flatten(1)
    r = (x_ref.float() - x_in.float()).flatten(1)
    gaps = torch.linalg.vector_norm(a - r, dim=1) / nominal
    return float(gaps.max()) if bool(torch.isfinite(gaps).all()) else math.inf


def _spanned(name, fn):
    def wrapped(*args, **kwargs):
        with trace.span(name):
            return fn(*args, **kwargs)
    return wrapped
