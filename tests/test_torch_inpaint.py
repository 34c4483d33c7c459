"""The inpaint route of the port against the JAX package, on ``tiny-inpaint``.

Both sides take identical random draws: the JAX key tree of the inpaint EOT
(``split(key, grad_reps)``, then ``k_p, k_r``, then ``k_lat, k_vae,
k_chain``, then ``split(k_chain, K)``; inpaint.py:47-59, 137-139) is replayed
into the port's explicit ``EOTDraws``.  Weights cross through
``from_jax_params``.  Tolerances are those of the diffusion iteration
(tests/test_torch_pgd.py): rtol = atol = 2e-4 through the differentiated
chain, the L-inf rule of ``assert_sign_steps_close`` for sign steps, and
bit-equality for the update applied to one and the same gradient.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import nchw, nhwc, one_torch_thread, port_model_from_jax  # noqa: F401
from test_torch_pgd import GOLDEN_PATH, GS, SIZE, TOL, _port_cfg, _rand, assert_sign_steps_close
from test_torch_pgd import golden_jax_model
from tml_image_editing_defense_tpu.attack.forward import CondInputs as JCond
from tml_image_editing_defense_tpu.api import training_sampler_kind as j_training_sampler_kind
from tml_image_editing_defense_tpu.attack.inpaint import (
    inpaint_attack_forward as j_inpaint_attack_forward,
)
from tml_image_editing_defense_tpu.attack.inpaint import (
    make_inpaint_eot_grad as j_make_inpaint_eot_grad,
)
from tml_image_editing_defense_tpu.attack.inpaint import (
    make_inpaint_pgd_step as j_make_inpaint_pgd_step,
)
from tml_image_editing_defense_tpu.attack.pgd import linf_perturbation_step as j_linf_step
from tml_image_editing_defense_tpu.attack.pgd import make_attack_data as j_make_attack_data
from tml_image_editing_defense_tpu.configs import TrainConfig as JTrainConfig
from tml_image_editing_defense_tpu.core.samplers import LCMSampler as JLCM
from tml_image_editing_defense_tpu.core.samplers import make_sampler as j_make_sampler
from tml_image_editing_defense_tpu.core.schedule import make_noise_schedule as j_schedule
from tml_image_editing_defense_tpu.models.model_zoo import PromptBank as JBank

from tml_image_editing_defense_torch import api
from tml_image_editing_defense_torch.attack.forward import CondInputs
from tml_image_editing_defense_torch.attack.inpaint import (
    inpaint_attack_forward,
    make_inpaint_eot_grad,
    make_inpaint_pgd_step,
    run_inpaint_attack,
    sample_inpaint_draws,
)
from tml_image_editing_defense_torch.attack.pgd import (
    EOTDraws,
    iteration_generator,
    make_attack_data,
)
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.core.image_ops import load_image
from tml_image_editing_defense_torch.core.samplers import LCMSampler, make_sampler
from tml_image_editing_defense_torch.core.schedule import make_noise_schedule
from tml_image_editing_defense_torch.models.model_zoo import PromptBank, build_model
from tml_image_editing_defense_torch.ops import pgd_kernels as pk

LAT = (1, SIZE // 2, SIZE // 2, 4)        # one tiny latent, NHWC

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def models():
    """The golden's JAX ``tiny-inpaint`` model (key 0) and its port twin."""
    jmodel = golden_jax_model("tiny-inpaint")
    return jmodel, port_model_from_jax(jmodel, family="tiny-inpaint")


def replay_inpaint_draws(key, grad_reps, n_prompts, n_steps) -> EOTDraws:
    """The draws the JAX inpaint EOT makes from ``key``, as an EOTDraws: a
    prompt per rep, the fresh latents as ``init_noise``."""
    def normal(k):
        return nchw(np.asarray(jax.random.normal(k, LAT, jnp.float32)))[0]

    prompts, lats, eps, steps = [], [], [], []
    for k in jax.random.split(key, grad_reps):
        k_p, k_r = jax.random.split(k)
        prompts.append(int(jax.random.randint(k_p, (), 0, n_prompts)))
        k_lat, k_vae, k_chain = jax.random.split(k_r, 3)
        lats.append(normal(k_lat))
        eps.append(normal(k_vae))
        steps.append(torch.stack([normal(sk) for sk in jax.random.split(k_chain, max(n_steps, 1))]))
    return EOTDraws(prompts, [], torch.stack(eps), torch.stack(steps), init_noise=torch.stack(lats))


@pytest.mark.parametrize("k,limit_t,min_t", [(4, 800, 101), (4, 700, None), (2, 800, 101),
                                             (8, 800, 101), (4, None, 300)])
def test_min_t_plans_match_jax(k, limit_t, min_t):
    jp = JLCM(j_schedule()).plan(k, limit_t=limit_t, min_t=min_t)
    pp = LCMSampler(make_noise_schedule()).plan(k, limit_t=limit_t, min_t=min_t)
    assert pp.num_steps == jp.num_steps
    for name in ("t_eval", "alpha_prod", "alpha_prod_prev", "is_last"):
        np.testing.assert_array_equal(getattr(pp, name), np.asarray(getattr(jp, name)), name)
    assert pp.init_timestep == int(jp.init_timestep)


def test_inpaint_window_is_three_steps():
    """K = 4 in 100 < t < 800 keeps t = 759, 519, 279 (test_whole_program_oracle.py:461-464);
    the diffusion plan (t < 700) stays 519, 279."""
    sampler = LCMSampler(make_noise_schedule())
    assert sampler.plan(4, limit_t=800, min_t=101).t_eval.tolist() == [759, 519, 279]
    assert sampler.plan(4, limit_t=700).t_eval.tolist() == [519, 279]


def test_inpaint_forward_matches_jax_and_golden(models):
    """The golden's forward (test_whole_program_goldens.py:131-139)."""
    jmodel, pm = models
    image = np.clip(_rand(1, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    ctx = _rand(14, (2, 7, 32))
    key = jax.random.key(15)
    jsampler = JLCM(jmodel.schedule)
    want = j_inpaint_attack_forward(jmodel, jsampler, jsampler.plan(4, limit_t=800, min_t=101),
                                    jmodel.params, jnp.asarray(image), JCond(ctx=jnp.asarray(ctx)),
                                    GS, key, remat_policy="none")
    sampler = LCMSampler(pm.schedule)
    plan = sampler.plan(4, limit_t=800, min_t=101)
    # the forward's own key tree (test_whole_program_oracle.py:475-480)
    k_lat, k_vae, k_chain = jax.random.split(key, 3)
    lat, eps = (nchw(np.asarray(jax.random.normal(k, LAT, jnp.float32))) for k in (k_lat, k_vae))
    steps = torch.stack([nchw(np.asarray(jax.random.normal(k, LAT, jnp.float32)))[0]
                         for k in jax.random.split(k_chain, plan.num_steps)])
    with torch.no_grad():
        got = inpaint_attack_forward(pm, sampler, plan, nchw(image),
                                     CondInputs(ctx=torch.tensor(ctx)), GS, lat, eps, steps)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(nhwc(got), np.load(GOLDEN_PATH)["inpaint_attack_forward_latent"],
                               **TOL)


@pytest.mark.parametrize("family", ["sd15", "sd15-inpaint", "tiny", "tiny-inpaint", "sdxl"])
@pytest.mark.parametrize("use_lcm", [True, False])
def test_training_sampler_kind_matches_jax(family, use_lcm):
    """The rule on one and the same family string equals the JAX package's.
    A model passes its base family ("sd15" for sd15-inpaint, so PLMS without
    LCM), as tests/test_torch_sdxl.py::
    test_training_sampler_follows_the_jax_base_family holds."""
    assert api.training_sampler_kind(family, use_lcm) == j_training_sampler_kind(family, use_lcm)


def test_inpaint_forward_euler_matches_jax(models):
    """The inpaint forward with the sampler of ``use_lcm=False`` (Euler: fresh
    latents scaled by the plan's initial sigma, model inputs scaled, no step
    noise), against the JAX forward on the same key."""
    jmodel, pm = models
    image = np.clip(_rand(1, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    ctx = _rand(14, (2, 7, 32))
    key = jax.random.key(16)
    jsampler = j_make_sampler(j_training_sampler_kind("tiny-inpaint", False), jmodel.schedule)
    want = j_inpaint_attack_forward(jmodel, jsampler, jsampler.plan(4, limit_t=800, min_t=101),
                                    jmodel.params, jnp.asarray(image), JCond(ctx=jnp.asarray(ctx)),
                                    GS, key, remat_policy="none")
    sampler = make_sampler(api.training_sampler_kind("tiny-inpaint", False), pm.schedule)
    plan = sampler.plan(4, limit_t=800, min_t=101)
    assert plan.kind == "euler" and plan.num_steps == 3
    k_lat, k_vae, _ = jax.random.split(key, 3)
    lat, eps = (nchw(np.asarray(jax.random.normal(k, LAT, jnp.float32))) for k in (k_lat, k_vae))
    with torch.no_grad():
        got = inpaint_attack_forward(pm, sampler, plan, nchw(image),
                                     CondInputs(ctx=torch.tensor(ctx)), GS, lat, eps, None)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_inpaint_forward_plms_matches_jax(models):
    """The inpaint forward with PLMS, the sampler SD-1.5-inpaint trains with
    without LCM (its base family is "sd15"; JAX api.py:56-62): the eps
    history carried through the window's steps, against the JAX forward on
    the same key."""
    jmodel, pm = models
    assert api.training_sampler_kind(build_model("sd15-inpaint", device="meta").base_family,
                                     False) == "plms"
    image = np.clip(_rand(1, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    ctx = _rand(14, (2, 7, 32))
    key = jax.random.key(17)
    jsampler = j_make_sampler("plms", jmodel.schedule)
    want = j_inpaint_attack_forward(jmodel, jsampler, jsampler.plan(4, limit_t=800, min_t=101),
                                    jmodel.params, jnp.asarray(image), JCond(ctx=jnp.asarray(ctx)),
                                    GS, key, remat_policy="none")
    sampler = make_sampler("plms", pm.schedule)
    plan = sampler.plan(4, limit_t=800, min_t=101)
    k_lat, k_vae, _ = jax.random.split(key, 3)
    lat, eps = (nchw(np.asarray(jax.random.normal(k, LAT, jnp.float32))) for k in (k_lat, k_vae))
    with torch.no_grad():
        got = inpaint_attack_forward(pm, sampler, plan, nchw(image),
                                     CondInputs(ctx=torch.tensor(ctx)), GS, lat, eps, None)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def _inputs(n_prompts=3):
    embeds, uncond = _rand(20, (n_prompts, 7, 32)), _rand(21, (7, 32))
    source = np.clip(_rand(23, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    target = np.clip(_rand(24, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    x0 = np.clip(source + _rand(25, source.shape, 0.01), -1, 1)
    pool = _rand(22, (2, 1, SIZE // 2, SIZE // 2, 4))
    return embeds, uncond, source, target, x0, pool


def _both_sides(jmodel, pm, jcfg, k):
    """JAX and port (sampler, plan, data) for one config, and the port config."""
    embeds, uncond, source, target, x0, pool = _inputs()
    jsampler = JLCM(jmodel.schedule)
    jplan = jsampler.plan(k, limit_t=800, min_t=101)
    jdata = j_make_attack_data(jmodel, jcfg, jnp.asarray(source), jnp.asarray(target),
                               JBank(embeds=jnp.asarray(embeds), uncond=jnp.asarray(uncond)),
                               jnp.asarray(pool))
    cfg = _port_cfg(jcfg)
    sampler = LCMSampler(pm.schedule)
    plan = sampler.plan(k, limit_t=800, min_t=101)
    data = make_attack_data(pm, cfg, nchw(source), nchw(target),
                            PromptBank(embeds=torch.tensor(embeds), uncond=torch.tensor(uncond)),
                            torch.from_numpy(np.ascontiguousarray(pool.transpose(0, 1, 4, 2, 3))))
    return (jsampler, jplan, jdata), (cfg, sampler, plan, data), x0


@pytest.mark.parametrize("norm", ["linf", "l2"])
def test_inpaint_step_matches_jitted_jax_step(models, norm):
    """One make_inpaint_pgd_step iteration (K = 2: t = 499 in the window)."""
    jmodel, pm = models
    radius = dict(eps=0.1, step_size=0.006) if norm == "linf" else dict(eps=2.0, step_size=0.5)
    jcfg = JTrainConfig(
        attack_mode="inpaint", norm_type=norm, derive_norm_hyperparams=False, **radius,
        grad_reps=2, guidance_scale=GS, image_size=SIZE, n_denoising_steps_per_iteration=2,
        apply_loss_on_images=True, perturbation_loss_lambda=0.3, prompts=["a", "b", "c"])
    (jsampler, jplan, jdata), (cfg, sampler, plan, data), x0 = _both_sides(jmodel, pm, jcfg, 2)
    key = jax.random.key(78)
    jx1, jaux = jax.jit(j_make_inpaint_pgd_step(jmodel, jsampler, jplan, jcfg))(
        jmodel.params, jnp.asarray(x0), jdata, key)
    draws = replay_inpaint_draws(key, cfg.grad_reps, 3, plan.num_steps)
    x1, aux = make_inpaint_pgd_step(pm, sampler, plan, cfg)(nchw(x0), data, draws)

    for name in ("avg_loss", "rec_loss", "pert_loss"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]), rtol=2e-4, err_msg=name)
    np.testing.assert_allclose(nhwc(aux["output_latent"]), np.asarray(jaux["output_latent"]), **TOL)
    assert int(aux["prompt_idx"]) == int(jaux["prompt_idx"])
    src = nchw(np.asarray(jdata.source))
    if norm == "l2":
        np.testing.assert_allclose(nhwc(x1), np.asarray(jx1), **TOL)
        assert float(torch.linalg.vector_norm(x1 - src)) <= 2.0 + 1e-4
        return
    # L-inf: the EOT gradient at the chain tolerance, the update on one and
    # the same gradient bit-equal, the iterates by the sign rule
    jgrad, _ = jax.jit(j_make_inpaint_eot_grad(jmodel, jsampler, jplan, jcfg))(
        jmodel.params, jnp.asarray(x0), jdata, key)
    grad, _ = make_inpaint_eot_grad(pm, sampler, plan, cfg)(nchw(x0), data, draws)
    jgrad = np.asarray(jgrad)
    scale = float(np.abs(jgrad).max())
    np.testing.assert_allclose(nhwc(grad), jgrad, rtol=2e-4, atol=2e-4 * scale)
    same = pk.fused_perturbation_step("linf", x_adv=nchw(x0), grad=nchw(jgrad), x_src=src,
                                      step_size=0.006, eps=0.1, min_value=-1.0, max_value=1.0)
    np.testing.assert_array_equal(
        nhwc(same), np.asarray(j_linf_step(jnp.asarray(x0), jnp.asarray(jgrad),
                                           jdata.source, 0.006, 0.1, -1.0, 1.0)))
    assert_sign_steps_close(nhwc(x1), np.asarray(jx1), jgrad)
    assert float((x1 - src).abs().max()) <= 0.1 + 1e-6


def test_run_inpaint_attack_two_iterations(models):
    """Two iterations from the source: each one is the step on that
    iteration's seeded draws; the losses are finite and x stays in the ball."""
    _, pm = models
    cfg = TrainConfig(attack_mode="inpaint", norm_type="linf", derive_norm_hyperparams=False,
                      eps=0.05, step_size=0.03, grad_reps=2, guidance_scale=GS, image_size=SIZE,
                      n_denoising_steps_per_iteration=4, prompts=["a", "b", "c"])
    embeds, uncond, source, target, _, pool = _inputs()
    sampler = LCMSampler(pm.schedule)
    plan = sampler.plan(4, limit_t=800, min_t=101)
    data = make_attack_data(pm, cfg, nchw(source), nchw(target),
                            PromptBank(embeds=torch.tensor(embeds), uncond=torch.tensor(uncond)),
                            torch.from_numpy(np.ascontiguousarray(pool.transpose(0, 1, 4, 2, 3))))
    x, losses = run_inpaint_attack(pm, sampler, plan, cfg, data, seed=5, iters=2)

    step = make_inpaint_pgd_step(pm, sampler, plan, cfg)
    want = data.source
    for it in range(2):
        draws = sample_inpaint_draws(iteration_generator(5, it, "cpu"), cfg, 3, pm.latent_shape,
                                     plan.num_steps)
        assert draws.step_noise.shape == (2, 3, 4, SIZE // 2, SIZE // 2)
        want, aux = step(want, data, draws)
        assert losses[it].item() == aux["avg_loss"].item()
    assert torch.equal(x, want)
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    assert float((x - data.source).abs().max()) <= 0.05 + 1e-6
    assert float((x - data.source).abs().max()) > 0


def _api_cfg(tmp_path, **kw):
    rng = np.random.default_rng(0)
    for name in ("source.png", "target.png"):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(tmp_path / name)
    base = dict(source_image_path=tmp_path / "source.png",
                target_image_path=tmp_path / "target.png", output_path=tmp_path / "out",
                attack_mode="inpaint", norm_type="linf", model_family="tiny-inpaint",
                image_size=SIZE, n_optimization_steps=3, image_visualization_interval=2,
                prompts=["a", "b", "c"])
    base.update(kw)
    return TrainConfig(**base)


def test_immunize_inpaint_on_cpu(tmp_path, monkeypatch):
    """The inpaint route of immunize: the L-inf preset (eps 0.1, step 0.006,
    5 reps), the K5 dispatch (its plain version on the CPU), the artifacts."""
    seen = []
    plain = pk.linf_perturbation_step
    monkeypatch.setattr(pk, "linf_perturbation_step",
                        lambda *a: seen.append(all(t.is_contiguous() for t in a[:3])) or plain(*a))
    cfg = _api_cfg(tmp_path)
    assert (cfg.eps, cfg.step_size, cfg.grad_reps) == (0.1, 0.006, 5)
    result = api.immunize(cfg, device="cpu")
    assert seen == [True] * 3
    assert result.model.unet.config.in_channels == 9
    out = cfg.output_path
    assert Image.open(out / "adversarial_image.png").size == (SIZE, SIZE)
    assert (out / "noise.npz").is_file()
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert sorted(r["step"] for r in rows) == [0, 1, 2]
    assert all(np.isfinite(h[k]) for h in result.history for k in h)
    src = torch.from_numpy(load_image(cfg.source_image_path, SIZE))
    assert float((result.x_adv - src).abs().max()) <= 0.1 + 1e-6
    assert result.x_adv.min() >= -1 and result.x_adv.max() <= 1


def test_inpaint_family_defaults():
    assert api._default_family(TrainConfig(attack_mode="inpaint")) == "sd15-inpaint"
    assert api._default_family(TrainConfig()) == "sd15"
    meta = build_model("sd15-inpaint", device="meta")
    assert meta.unet.conv_in.weight.shape == (320, 9, 3, 3)


@pytest.mark.parametrize("kw,match", [
    ({"use_sdxl": True, "model_family": None}, "no SDXL variant"),
    ({"model_family": "tiny"}, "needs a 9-channel inpaint UNet"),
    ({"attack_mode": "diffusion", "norm_type": "l2"}, "is an inpaint UNet"),
    ({"attack_mode": "edit"}, "unknown attack_mode"),
])
def test_inpaint_checks_raise_value_error(tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        api.immunize(_api_cfg(tmp_path, **kw), device="cpu")
