"""Batched immunization of the port on the CPU (tiny family, 32x32, B = 3).

- ``parallel.sweep.make_batched_pgd_step`` against the JAX
  ``make_batched_pgd_step(..., mesh=None)`` (a ``jax.vmap`` of the one-image
  step) on ``keys = jax.random.split(key, 3)``, each image's draws replayed
  from its key (tests/test_torch_pgd.py::replay_draws, plus the fresh init
  noise of ``use_fixed_noise=False``): the iterates and the per-image
  losses at tests/test_torch_pgd.py's TOL (rtol = atol = 2e-4, the two
  frameworks sum in different orders), L-inf iterates by the sign rule
  (``assert_sign_steps_close``).  L2 with pooled and fresh noise at
  ``eot_chunk`` 1 and 2, L-inf once (the noise and the chunking come before
  the update).  B = 3 with images, targets, pools and draws that differ per
  image: a wrong divisor or row-to-image map passes at B = 1.
- The pool entries are gathered on the device (no host read of an index),
  and ``run_pgd`` keeps one history per image of a batch.
- ``api.immunize_batch(seeds=...)`` against one ``api.immunize`` run per
  seed on the same model: the pools bit-equal (the same set-up stream),
  ``x_adv`` within 1e-5 (the batch's convolutions sum in another order;
  4.3e-7 measured), the PNGs within one uint8 level.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import nchw, nhwc, one_torch_thread, port_model_from_jax  # noqa: F401
from test_torch_pgd import GS, SIZE, TOL, _rand, assert_sign_steps_close, golden_jax_model
from test_torch_pgd import replay_draws
from tml_image_editing_defense_tpu.attack.pgd import make_attack_data as j_make_attack_data
from tml_image_editing_defense_tpu.configs import TrainConfig as JTrainConfig
from tml_image_editing_defense_tpu.core.samplers import make_sampler as j_make_sampler
from tml_image_editing_defense_tpu.models.model_zoo import PromptBank as JBank
from tml_image_editing_defense_tpu.parallel.sweep import batch_attack_data as j_batch_attack_data
from tml_image_editing_defense_tpu.parallel.sweep import (
    make_batched_pgd_step as j_make_batched_pgd_step,
)

from tml_image_editing_defense_torch import api
from tml_image_editing_defense_torch.attack.pgd import (
    AttackData,
    EOTDraws,
    iteration_generator,
    make_attack_data,
    make_batched_eot_grad,
    rep_inputs,
    run_pgd,
)
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.core.samplers import make_sampler
from tml_image_editing_defense_torch.models.model_zoo import PromptBank, build_model
from tml_image_editing_defense_torch.parallel.sweep import (
    batch_attack_data,
    make_batched_pgd_step,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, REPS, LAT = 3, 2, (1, SIZE // 2, SIZE // 2, 4)


@pytest.fixture(scope="module")
def models():
    jmodel = golden_jax_model("tiny")
    return jmodel, port_model_from_jax(jmodel)


def _replay_image_draws(key, n_prompts, n_pool, n_steps, fresh: bool):
    """Image ``key``'s draws of one JAX iteration; with ``fresh`` also the
    init noise each rep draws from its k_noise (pgd.py:229-232)."""
    draws = replay_draws(key, REPS, n_prompts, n_pool, n_steps, LAT)
    if fresh:
        _, k_reps = jax.random.split(key)
        draws.init_noise = torch.stack([
            nchw(np.asarray(jax.random.normal(jax.random.split(rk)[0], LAT, jnp.float32)))[0]
            for rk in jax.random.split(k_reps, REPS)])
    return draws


@pytest.mark.parametrize("norm,fixed,chunk", [("l2", True, 1), ("l2", False, 2),
                                              ("linf", True, 2)],
                         ids=["l2-pool-chunk1", "l2-fresh-chunk2", "linf-pool-chunk2"])
def test_batched_step_matches_jax_vmapped_step(models, norm, fixed, chunk):
    jmodel, pm = models
    radius = dict(eps=12.0, step_size=1.5) if norm == "l2" else dict(eps=0.1, step_size=0.006)
    # L2 takes its loss on the images with the perturbation loss (each row's
    # target and source), L-inf on the latents (each row's target latent)
    loss = (dict(apply_loss_on_images=True, perturbation_loss_lambda=0.3) if norm == "l2" else
            dict(apply_loss_on_images=False, apply_loss_on_latents=True,
                 perturbation_loss_lambda=0.0))
    kw = dict(norm_type=norm, derive_norm_hyperparams=False, **radius, grad_reps=REPS,
              guidance_scale=GS, image_size=SIZE, n_denoising_steps_per_iteration=4,
              limit_timesteps=True, rec_loss_lambda=1.0, prompts=["a", "b", "c"],
              use_fixed_noise=fixed, eot_chunk=chunk, **loss)
    jcfg, cfg = JTrainConfig(**kw), TrainConfig(**kw)
    embeds, uncond = _rand(20, (3, 7, 32)), _rand(21, (7, 32))
    sources = [np.clip(_rand(30 + i, (1, SIZE, SIZE, 3), 0.4), -1, 1) for i in range(B)]
    targets = [np.clip(_rand(40 + i, (1, SIZE, SIZE, 3), 0.4), -1, 1) for i in range(B)]
    pools = [_rand(50 + i, (4, *LAT)) for i in range(B)]
    x0 = np.concatenate([np.clip(s + _rand(60 + i, s.shape, 0.01), -1, 1)
                         for i, s in enumerate(sources)])
    keys = jax.random.split(jax.random.key(77), B)

    jsampler = j_make_sampler("lcm", jmodel.schedule)
    jplan = jsampler.plan(4, limit_t=700)
    jbank = JBank(embeds=jnp.asarray(embeds), uncond=jnp.asarray(uncond))
    jbatched = j_batch_attack_data([
        j_make_attack_data(jmodel, jcfg, jnp.asarray(s), jnp.asarray(t), jbank, jnp.asarray(p))
        for s, t, p in zip(sources, targets, pools)])
    jstep = j_make_batched_pgd_step(jmodel, jsampler, jplan, jcfg, jbatched, mesh=None)
    jx, jaux = jstep(jmodel.params, jnp.asarray(x0)[:, None], jbatched, keys)

    sampler = make_sampler("lcm", pm.schedule)
    plan = sampler.plan(4, limit_t=700)
    pbank = PromptBank(embeds=torch.tensor(embeds), uncond=torch.tensor(uncond))
    datas = [make_attack_data(pm, cfg, nchw(s), nchw(t), pbank,
                              torch.from_numpy(np.ascontiguousarray(p.transpose(0, 1, 4, 2, 3))))
             for s, t, p in zip(sources, targets, pools)]
    draws = [_replay_image_draws(k, 3, 4, plan.num_steps, not fixed) for k in keys]
    x, aux = make_batched_pgd_step(pm, sampler, plan, cfg)(nchw(x0), batch_attack_data(datas),
                                                           draws)

    assert x.shape == (B, 3, SIZE, SIZE)
    for name in ("avg_loss", "rec_loss", "pert_loss"):
        assert aux[name].shape == (B,)
        np.testing.assert_allclose(aux[name].numpy(), np.asarray(jaux[name]), rtol=2e-4,
                                   err_msg=name)
    want = np.asarray(jx)[:, 0]
    if norm == "l2":
        np.testing.assert_allclose(nhwc(x), want, **TOL)
    else:
        g = make_batched_eot_grad(pm, sampler, plan, cfg)(nchw(x0), batch_attack_data(datas),
                                                          draws)[0]
        assert_sign_steps_close(nhwc(x), want, nhwc(g))
    # each image in its own ball
    for i in range(B):
        d = x[i] - nchw(sources[i])[0]
        dist = float(torch.linalg.vector_norm(d)) if norm == "l2" else float(d.abs().max())
        assert dist <= radius["eps"] + 1e-4


def test_batch_attack_data_keeps_the_bank_unbatched(models):
    _, pm = models
    cfg = TrainConfig(image_size=SIZE, prompts=["a", "b"])
    bank = pm.embed_prompt_bank(cfg.prompts)
    datas = [make_attack_data(pm, cfg, nchw(np.clip(_rand(i, (1, SIZE, SIZE, 3), 0.4), -1, 1)),
                              nchw(np.clip(_rand(9 + i, (1, SIZE, SIZE, 3), 0.4), -1, 1)), bank,
                              torch.zeros((2, 1, 4, 16, 16)))
             for i in range(B)]
    batched = batch_attack_data(datas)
    assert batched.source.shape == (B, 1, 3, SIZE, SIZE)
    assert batched.target.shape == (B, 1, 3, SIZE, SIZE)
    assert batched.target_latent.shape == (B, 1, 4, 16, 16)
    assert batched.noise_pool.shape == (B, 2, 1, 4, 16, 16)
    assert batched.mask is None and batched.time_ids is None
    assert batched.bank_embeds is bank.embeds and batched.bank_uncond is bank.uncond
    for i, d in enumerate(datas):
        assert torch.equal(batched.source[i], d.source)
        assert torch.equal(batched.target_latent[i], d.target_latent)


def _images(tmp_path, n=B, same=False):
    rng = np.random.default_rng(5)
    paths, arr = [], None
    for i in range(n):
        if arr is None or not same:
            arr = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
        path = tmp_path / f"im{i}.png"
        Image.fromarray(arr).save(path)
        paths.append(path)
    return paths


def _cfg(tmp_path, **kw):
    base = dict(model_family="tiny", image_size=SIZE, n_optimization_steps=2,
                derive_norm_hyperparams=False, eps=2.0, step_size=1.0, grad_reps=REPS,
                prompts=["a", "b", "c"], n_noise=2, enable_visualization=False,
                output_path=tmp_path / "batch")
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture(scope="module")
def tiny_model():
    return build_model("tiny", image_size=SIZE, device="cpu",
                       generator=torch.Generator().manual_seed(0))


def test_immunize_batch_replays_serial_immunize_per_seed(tmp_path, tiny_model):
    paths = _images(tmp_path)
    cfg = _cfg(tmp_path)
    seeds = [11, 22, 33]
    results = api.immunize_batch(cfg, paths, device="cpu", model=tiny_model, seeds=seeds)
    assert len(results) == B
    for path, seed, res in zip(paths, seeds, results):
        out = cfg.output_path / path.stem
        assert sorted(p.name for p in out.iterdir()) == ["adversarial_image.png", "noise.npz"]
        assert len(res.history) == cfg.n_optimization_steps
        assert all(list(h) == ["avg_loss"] and np.isfinite(h["avg_loss"]) for h in res.history)
        one = api.immunize(dataclasses.replace(cfg, seed=seed, source_image_path=path,
                                               target_image_path=path,
                                               output_path=tmp_path / f"serial{seed}"),
                           device="cpu", model=tiny_model)
        assert torch.equal(res.noise_pool, one.noise_pool)
        np.testing.assert_allclose(res.x_adv.numpy(), one.x_adv.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose([h["avg_loss"] for h in res.history],
                                   [h["avg_loss"] for h in one.history], rtol=1e-5)
        a = np.asarray(Image.open(out / "adversarial_image.png"), np.int16)
        b = np.asarray(Image.open(tmp_path / f"serial{seed}" / "adversarial_image.png"), np.int16)
        assert np.abs(a - b).max() <= 1
    rows = (cfg.output_path / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == B and all('"final_avg_loss"' in r for r in rows)


def test_immunize_batch_without_seeds_draws_per_image(tmp_path, tiny_model):
    """One set-up stream serves every image, and each image has a loop
    seed of its own: identical sources end apart (JAX tests/test_api.py:747)."""
    paths = _images(tmp_path, n=2, same=True)
    results = api.immunize_batch(_cfg(tmp_path, n_optimization_steps=1), paths, device="cpu",
                                 model=tiny_model)
    assert not torch.equal(results[0].noise_pool, results[1].noise_pool)
    assert not torch.equal(results[0].x_adv, results[1].x_adv)


@pytest.mark.parametrize("kw,field", [(dict(attack_mode="inpaint"), "attack_mode"),
                                      (dict(eot_shards=2),
                                       "eot_shards=2 exceeds local device count 1")])
def test_immunize_batch_refuses_inpaint_and_eot_shards(tmp_path, tiny_model, kw, field):
    """No batched inpaint step (as in JAX); ``eot_shards=2`` needs a
    (data, reps) mesh of ranks, and without a process group the world is
    one rank (the 2-D mesh over ranks: tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match=field):
        api.immunize_batch(_cfg(tmp_path, **kw), _images(tmp_path, n=2), device="cpu",
                           model=tiny_model)


def test_pool_entries_are_gathered_on_the_device():
    """``rep_inputs`` picks each rep's pool entry with a gather on the
    pool's device: on the meta device, where a host read of an index raises
    (``pool[idx]`` with a 0-d tensor calls ``.item()``), it runs; on the CPU
    a 1-D tensor, 0-d tensors and ints pick the same entries."""
    def data(dev):
        pool = torch.arange(4 * 2 * 3, dtype=torch.float32, device=dev).view(4, 1, 2, 3)
        return AttackData(source=None, target=None, target_latent=None,
                          bank_embeds=torch.zeros((2, 5, 8), device=dev),
                          bank_uncond=torch.zeros((5, 8), device=dev), noise_pool=pool)

    def draws(dev, pool_idx):
        return EOTDraws(torch.tensor(1, device=dev), pool_idx, torch.zeros((3, 2, 3), device=dev),
                        torch.zeros((3, 2, 2, 3), device=dev))

    idx = torch.tensor([3, 0, 3], device="meta")
    eps, noise, cond, step_noise = rep_inputs(data("meta"), draws("meta", idx), range(0, 3))
    assert noise.shape == (3, 2, 3) and step_noise.shape == (2, 3, 2, 3) and len(cond) == 3

    cpu = data("cpu")
    want = torch.cat([cpu.noise_pool[i] for i in (0, 3)])
    for pool_idx in (torch.tensor([3, 0, 3]), list(torch.tensor([3, 0, 3]).unbind(0)), [3, 0, 3]):
        assert torch.equal(rep_inputs(cpu, draws("cpu", pool_idx), range(1, 3))[1], want)


def test_run_pgd_keeps_a_history_per_image_of_a_batch():
    """With one seed per image ``run_pgd`` draws image i's iteration from
    its own seed's generator, starts from the batch's sources and returns a
    history per image, each ending with the preemption."""
    cfg = TrainConfig(n_optimization_steps=5)
    data = type("Data", (), {"source": torch.zeros(2, 1, 3, 2, 2)})()
    seeds, stop, drawn = [7, 9], [], []

    def step(x, data_, draws):
        drawn.append(draws)
        if len(drawn) == 2:
            stop.append(True)
        return x + 1, {"avg_loss": x.mean((1, 2, 3)) + torch.arange(2.0),
                       "rec_loss": torch.zeros(2), "pert_loss": torch.ones(2)}

    x, histories = run_pgd(None, None, None, cfg, data, seeds, step_fn=step,
                           draw_sampler=lambda gen: gen.initial_seed(), stop_flag=stop)
    assert x.shape == (2, 3, 2, 2) and float(x.mean()) == 2.0
    assert drawn == [[iteration_generator(s, it, "cpu").initial_seed() for s in seeds]
                     for it in range(2)]
    for i, history in enumerate(histories):
        assert history == [{"avg_loss": float(it + i), "rec_loss": 0.0, "pert_loss": 1.0}
                           for it in range(2)] + [{"preempted_at": 2}]
