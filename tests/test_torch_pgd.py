"""One PGD iteration of the port against the JAX package, on the tiny family.

Both sides take identical random draws: the JAX key tree of one iteration
(pgd.py:301-303 prompt and reps, :226-228 pool index, then
``replay_chain_keys`` for the posterior and step noises) is replayed into the
port's explicit ``EOTDraws``.  Weights cross through ``from_jax_params``.
The iterate must match the jitted JAX ``make_pgd_step`` and the committed
goldens (tests/goldens/whole_program.npz) at rtol = atol = 2e-4, the
tolerance test_whole_program_oracle.py holds its torch transcription to:
the two frameworks sum in different orders through a differentiated chain.

Under L-inf the step is ``sign(g)``, which is discontinuous at 0: an element
whose gradient is near 0 may take the other sign on the two sides and move
by 2 * step.  :func:`assert_sign_steps_close` holds L-inf iterates to that.

The helpers here (the goldens' JAX tiny models, the L-inf rule) are shared
by the other ``test_torch_*`` attack files.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import nchw, nhwc, one_torch_thread, port_model_from_jax  # noqa: F401
from test_whole_program_oracle import replay_chain_keys
from tml_image_editing_defense_tpu.attack.forward import CondInputs as JCond
from tml_image_editing_defense_tpu.attack.forward import attack_forward as j_attack_forward
from tml_image_editing_defense_tpu.attack.pgd import make_attack_data as j_make_attack_data
from tml_image_editing_defense_tpu.attack.pgd import make_pgd_step as j_make_pgd_step
from tml_image_editing_defense_tpu.configs import TrainConfig as JTrainConfig
from tml_image_editing_defense_tpu.core.rng import make_noise_pool as j_make_noise_pool
from tml_image_editing_defense_tpu.core.samplers import LCMSampler as JLCM
from tml_image_editing_defense_tpu.core.samplers import make_sampler as j_make_sampler
from tml_image_editing_defense_tpu.models import build_model as jax_build_model
from tml_image_editing_defense_tpu.models.model_zoo import PromptBank as JBank

from tml_image_editing_defense_torch.attack.forward import (
    CondInputs,
    attack_forward,
    attack_forward_from_latent,
)
from tml_image_editing_defense_torch.attack.pgd import (
    EOTDraws,
    iteration_generator,
    make_attack_data,
    make_eot_grad,
    make_pgd_step,
    sample_draws,
)
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.core.samplers import LCMSampler, make_sampler
from tml_image_editing_defense_torch.models.model_zoo import PromptBank, build_model
from tml_image_editing_defense_torch.models.vae import sample_latent

GOLDEN_PATH = Path(__file__).parent / "goldens" / "whole_program.npz"
SIZE, GS = 32, 3.0
TOL = dict(rtol=2e-4, atol=2e-4)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _rand(seed, shape, scale=1.0):
    return np.asarray(jax.random.normal(jax.random.key(seed), shape, jnp.float32) * scale)


def golden_jax_model(family: str = "tiny"):
    """The goldens' JAX model of ``family`` ("tiny", "tiny-inpaint",
    "tiny-sdxl" or "tiny-sdxl-refiner"; key 0, flax init of each part from
    ``split(key, 2 + encoders)`` as build_model draws them).  The flax inits
    run under ``jax.jit`` (half the time of build_model's eager init; the
    same keys give the same weights to within 1e-7)."""
    from tml_image_editing_defense_tpu.models.clip_text import TINY_TEXT, CLIPTextModel
    from tml_image_editing_defense_tpu.models.unet import (
        TINY_INPAINT_UNET,
        TINY_SDXL_REFINER_UNET,
        TINY_SDXL_UNET,
        TINY_UNET,
        UNet2DCondition,
    )
    from tml_image_editing_defense_tpu.models.vae import TINY_VAE, AutoencoderKL

    unet_cfg = {"tiny": TINY_UNET, "tiny-inpaint": TINY_INPAINT_UNET, "tiny-sdxl": TINY_SDXL_UNET,
                "tiny-sdxl-refiner": TINY_SDXL_REFINER_UNET}[family]
    n_text = 2 if "sdxl" in family else 1
    k_unet, k_vae, *k_txt = jax.random.split(jax.random.key(0), 2 + n_text)
    zeros = jnp.zeros
    kwargs = {}
    if unet_cfg.addition_embed_type == "text_time":
        # build_model's init shapes: the pooled width left beside 6 time ids
        pooled = (unet_cfg.projection_class_embeddings_input_dim
                  - 6 * unet_cfg.addition_time_embed_dim)
        kwargs = dict(text_embeds=zeros((1, pooled)), time_ids=zeros((1, 6)))
    text_init = jax.jit(lambda k: CLIPTextModel(TINY_TEXT).init(
        k, zeros((1, 16), jnp.int32))["params"])
    params = {
        "unet": jax.jit(lambda k: UNet2DCondition(unet_cfg).init(
            k, zeros((1, 16, 16, unet_cfg.in_channels)), zeros((), jnp.int32),
            zeros((1, 16, unet_cfg.cross_attention_dim)), **kwargs)["params"])(k_unet),
        "vae": jax.jit(lambda k: AutoencoderKL(TINY_VAE).init(
            k, zeros((1, SIZE, SIZE, 3)), jax.random.key(0))["params"])(k_vae),
        "text": tuple(text_init(k) for k in k_txt),
    }
    return jax_build_model(family, image_size=SIZE, params=params)


def assert_sign_steps_close(got, want, grad, tol=2e-4, share=1e-3):
    """L-inf iterates from two sides: where |g| > 1e-3 max|g| they agree at
    rtol = atol = ``tol``; elements that do not agree must all lie where
    |g| <= 1e-3 max|g| (a sign that may flip), and be at most ``share`` of
    the elements."""
    got, want, g = (np.asarray(a, np.float64) for a in (got, want, grad))
    off = np.abs(got - want) > tol + tol * np.abs(want)
    sure = np.abs(g) > 1e-3 * np.abs(g).max()
    assert not (off & sure).any(), f"{int((off & sure).sum())} elements off where |g| is large"
    assert off.mean() <= share, f"{int(off.sum())} of {off.size} elements off"


@pytest.fixture(scope="module")
def models():
    """The goldens' JAX model (tiny, key 0, flax init) and its port twin."""
    jmodel = golden_jax_model("tiny")
    return jmodel, port_model_from_jax(jmodel)


def replay_draws(key, grad_reps, n_prompts, n_pool, n_steps, lat_nhwc) -> EOTDraws:
    """The draws the JAX EOT gradient makes from ``key`` (pgd.py:300-303,
    225-228, 237), as the port's explicit EOTDraws."""
    k_prompt, k_reps = jax.random.split(key)
    prompt_idx = int(jax.random.randint(k_prompt, (), 0, n_prompts))
    pool_idx, eps, steps = [], [], []
    for rk in jax.random.split(k_reps, grad_reps):
        k_noise, k_fwd = jax.random.split(rk)
        pool_idx.append(int(jax.random.randint(k_noise, (), 0, n_pool)))
        e, sn = replay_chain_keys(k_fwd, n_steps, lat_nhwc)
        eps.append(nchw(e)[0])
        steps.append(torch.stack([nchw(x)[0] for x in sn]))
    return EOTDraws(prompt_idx, pool_idx, torch.stack(eps), torch.stack(steps))


def _port_cfg(jcfg) -> TrainConfig:
    """The port's config with the JAX config's values (dropped knobs aside)."""
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: v for k, v in jcfg.asdict().items() if k in names})


def _step_both(jmodel, pm, jcfg, jbank, pbank, jpool, source, target, x0, key, k,
               kind="lcm"):
    """One JAX jitted step and one port step on replayed draws, both with
    the ``kind`` sampler; the port's aux also carries its EOT gradient under
    "grad"."""
    jsampler = j_make_sampler(kind, jmodel.schedule)
    jplan = jsampler.plan(k, limit_t=700 if jcfg.limit_timesteps else None)
    jdata = j_make_attack_data(jmodel, jcfg, jnp.asarray(source), jnp.asarray(target), jbank,
                               jnp.asarray(jpool))
    jx1, jaux = jax.jit(j_make_pgd_step(jmodel, jsampler, jplan, jcfg))(
        jmodel.params, jnp.asarray(x0), jdata, key)

    cfg = _port_cfg(jcfg)
    sampler = make_sampler(kind, pm.schedule)
    plan = sampler.plan(k, limit_t=700 if cfg.limit_timesteps else None)
    pool = torch.from_numpy(np.ascontiguousarray(np.asarray(jpool).transpose(0, 1, 4, 2, 3)))
    data = make_attack_data(pm, cfg, nchw(source), nchw(target), pbank, pool)
    draws = replay_draws(key, cfg.grad_reps, pbank.embeds.shape[0], pool.shape[0],
                         plan.num_steps, (1, SIZE // 2, SIZE // 2, 4))
    x1, aux = make_pgd_step(pm, sampler, plan, cfg)(nchw(x0), data, draws)
    aux["grad"] = make_eot_grad(pm, sampler, plan, cfg)(nchw(x0), data, draws)[0]
    return (jx1, jaux), (x1, aux)


def test_pgd_step_matches_jitted_jax_step(models):
    _check_step_against_jax(models, "l2")


def test_pgd_step_linf_matches_jitted_jax_step(models):
    """The L-inf case of the same iteration (eps 0.1, step 0.006): K5's
    plain version on the CPU."""
    _check_step_against_jax(models, "linf")


def test_pgd_step_plms_matches_jitted_jax_step(models):
    """The PLMS training sampler of ``use_lcm=False`` (JAX api.py:56-62):
    K = 4 with t < 700 leaves [501, 501, 251, 1], the warm-up row included;
    the chain carries PLMS's eps history through the differentiated steps."""
    _check_step_against_jax(models, "l2", kind="plms")


def _check_step_against_jax(models, norm, kind="lcm"):
    jmodel, pm = models
    radius = dict(eps=12.0, step_size=1.5) if norm == "l2" else dict(eps=0.1, step_size=0.006)
    jcfg = JTrainConfig(
        norm_type=norm, derive_norm_hyperparams=False, **radius, grad_reps=2,
        guidance_scale=GS, image_size=SIZE, n_denoising_steps_per_iteration=4,
        limit_timesteps=True, apply_loss_on_images=True, perturbation_loss_lambda=0.3,
        rec_loss_lambda=1.0, prompts=["a", "b", "c"],
    )
    embeds, uncond = _rand(20, (3, 7, 32)), _rand(21, (7, 32))
    jbank = JBank(embeds=jnp.asarray(embeds), uncond=jnp.asarray(uncond))
    pbank = PromptBank(embeds=torch.tensor(embeds), uncond=torch.tensor(uncond))
    pool = _rand(22, (4, 1, 16, 16, 4))
    source = np.clip(_rand(23, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    target = np.clip(_rand(24, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    x0 = np.clip(source + _rand(25, source.shape, 0.01), -1, 1)
    (jx1, jaux), (x1, aux) = _step_both(jmodel, pm, jcfg, jbank, pbank, pool, source, target,
                                        x0, jax.random.key(77), 4, kind)
    for name in ("avg_loss", "rec_loss", "pert_loss"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]), rtol=2e-4, err_msg=name)
    np.testing.assert_allclose(nhwc(aux["output_image"]), np.asarray(jaux["output_image"]), **TOL)
    if norm == "l2":
        np.testing.assert_allclose(nhwc(x1), np.asarray(jx1), **TOL)
        assert float(torch.linalg.vector_norm(x1 - nchw(source))) <= 12.0 + 1e-4
    else:
        assert_sign_steps_close(nhwc(x1), np.asarray(jx1), nhwc(aux["grad"]))
        assert float((x1 - nchw(source)).abs().max()) <= 0.1 + 1e-6


def test_pgd_step_matches_goldens(models):
    """The golden iterate of test_whole_program_goldens.py (config :82-89)."""
    jmodel, pm = models
    ref = np.load(GOLDEN_PATH)
    cfg = TrainConfig(
        norm_type="l2", derive_norm_hyperparams=False, eps=8.0, step_size=1.0,
        n_denoising_steps_per_iteration=2, limit_timesteps=False, grad_reps=2,
        guidance_scale=GS, image_size=SIZE, apply_loss_on_images=True,
        apply_loss_on_latents=False, perturbation_loss_lambda=1.0, prompts=["a", "b"],
        use_pallas_update=False,
    )
    image = np.clip(_rand(1, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    bank = pm.embed_prompt_bank(cfg.prompts)
    pool = np.asarray(j_make_noise_pool(jax.random.key(5), 2, jmodel.latent_shape))
    pool = torch.from_numpy(np.ascontiguousarray(pool.transpose(0, 1, 4, 2, 3)))
    sampler = LCMSampler(pm.schedule)
    plan = sampler.plan(2)
    data = make_attack_data(pm, cfg, nchw(image), torch.zeros_like(nchw(image)), bank, pool)
    draws = replay_draws(jax.random.key(7), 2, 2, 2, plan.num_steps, (1, 16, 16, 4))
    x1, aux = make_pgd_step(pm, sampler, plan, cfg, decode_vis=False)(nchw(image), data, draws)
    np.testing.assert_allclose(nhwc(x1), ref["pgd_x_adv"], **TOL)
    np.testing.assert_allclose(aux["avg_loss"].item(), ref["pgd_avg_loss"], rtol=2e-4)


def test_attack_forward_matches_golden_and_jax(models):
    """The image-to-latent forward against the JAX ``attack_forward`` and the
    goldens on replayed draws (the posterior draw of ``k_vae``, the step
    noises of ``k_chain``): the encode, ``sample_latent`` and
    ``attack_forward_from_latent`` in turn, and ``attack_forward``, which
    chains them; with no posterior draw, ``attack_forward`` starts from the
    encode's mean."""
    jmodel, pm = models
    ref = np.load(GOLDEN_PATH)
    image = np.clip(_rand(1, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    ctx = _rand(2, (2, 77, 32))
    noise = _rand(3, (1, 16, 16, 4))
    key = jax.random.key(4)
    jsampler = JLCM(jmodel.schedule)
    want = j_attack_forward(jmodel, jsampler, jsampler.plan(2), jmodel.params,
                            jnp.asarray(image), JCond(ctx=jnp.asarray(ctx)), jnp.asarray(noise),
                            GS, key, "none")
    k_vae, k_chain = jax.random.split(key)
    eps = nchw(np.asarray(jax.random.normal(k_vae, (1, 16, 16, 4), jnp.float32)))
    step_keys = jax.random.split(k_chain, 2)
    steps = torch.stack([nchw(np.asarray(jax.random.normal(k, (1, 16, 16, 4))))[0]
                         for k in step_keys])
    sampler = LCMSampler(pm.schedule)
    cond = CondInputs(ctx=torch.tensor(ctx))
    with torch.no_grad():
        mean, logvar = pm.vae.encode(nchw(image))
        z = sample_latent(mean, logvar, eps) * pm.vae_scaling
        got = attack_forward_from_latent(pm, sampler, sampler.plan(2), z, cond, nchw(noise),
                                         GS, steps)
        entry = attack_forward(pm, sampler, sampler.plan(2), nchw(image), cond, nchw(noise), GS,
                               eps, steps)
        mean_path = attack_forward(pm, sampler, sampler.plan(2), nchw(image), cond, nchw(noise),
                                   GS, None, steps)
        from_mean = attack_forward_from_latent(pm, sampler, sampler.plan(2),
                                               mean * pm.vae_scaling, cond, nchw(noise), GS, steps)
    for out in (got, entry):
        np.testing.assert_allclose(nhwc(out), np.asarray(want), **TOL)
        np.testing.assert_allclose(nhwc(out), ref["attack_forward_latent"], **TOL)
    torch.testing.assert_close(mean_path, from_mean, rtol=0, atol=0)


def test_shared_encode_equals_per_rep_gradient():
    """The EOT gradient with one shared encode and one encoder backward
    equals the mean of per-rep gradients taken through the whole chain
    (what the reference computes, main.py:88-102)."""
    pm = build_model("tiny", device="cpu", generator=torch.Generator().manual_seed(3))
    cfg = TrainConfig(derive_norm_hyperparams=False, grad_reps=3, image_size=SIZE,
                      n_denoising_steps_per_iteration=4, perturbation_loss_lambda=0.5,
                      prompts=["a", "b"])
    sampler = LCMSampler(pm.schedule)
    plan = sampler.plan(4, limit_t=700)
    gen = torch.Generator().manual_seed(0)
    src = torch.rand((1, 3, SIZE, SIZE), generator=gen) * 2 - 1
    bank = pm.embed_prompt_bank(cfg.prompts)
    pool = torch.randn((3, 1, 4, 16, 16), generator=gen)
    data = make_attack_data(pm, cfg, src, -src, bank, pool)
    draws = sample_draws(gen, cfg, 2, 3, pm.latent_shape, plan.num_steps)
    grad, aux = make_eot_grad(pm, sampler, plan, cfg)(src, data, draws)

    grads, losses = [], []
    with torch.enable_grad():
        for r in range(cfg.grad_reps):
            x = src.clone().requires_grad_(True)
            mean, logvar = pm.vae.encode(x)
            z = sample_latent(mean, logvar, draws.vae_eps[r][None]) * pm.vae_scaling
            cond = CondInputs(ctx=torch.stack([bank.uncond, bank.embeds[draws.prompt_idx]]))
            out = attack_forward_from_latent(pm, sampler, plan, z, cond,
                                             pool[draws.pool_idx[r]], GS, draws.step_noise[r])
            img = pm.decode_latent(out, scaled=False)
            loss = (torch.linalg.vector_norm(img - data.target)
                    + 0.5 * torch.mean((img - src) ** 2))
            grads.append(torch.autograd.grad(loss, [x])[0])
            losses.append(loss.item())
    torch.testing.assert_close(grad, torch.stack(grads).mean(0), rtol=1e-5, atol=1e-6)
    assert aux["avg_loss"].item() == pytest.approx(np.mean(losses), rel=1e-5)


def test_iteration_draws_are_positional():
    cfg = TrainConfig(derive_norm_hyperparams=False, grad_reps=2)
    a = sample_draws(iteration_generator(42, 3, "cpu"), cfg, 5, 2, (1, 4, 8, 8), 2)
    b = sample_draws(iteration_generator(42, 3, "cpu"), cfg, 5, 2, (1, 4, 8, 8), 2)
    c = sample_draws(iteration_generator(42, 4, "cpu"), cfg, 5, 2, (1, 4, 8, 8), 2)
    assert a.vae_eps.shape == (2, 4, 8, 8) and a.step_noise.shape == (2, 2, 4, 8, 8)
    assert torch.equal(a.step_noise, b.step_noise) and int(a.prompt_idx) == int(b.prompt_idx)
    assert not torch.equal(a.vae_eps, c.vae_eps)
