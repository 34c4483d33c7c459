"""The port's half-precision paths against the JAX package's:

- ``build_model(vae_dtype=)``: the VAE in f32 beside a bf16 UNet and bf16
  text encoders (JAX model_zoo.py:296, 338-340; the reference's f32 VAE
  upcast for SDXL, sdxl_img2img_pipeline.py:490-515), on ``tiny-sdxl``;
  its encode and decode take a bf16 input and give f32 as flax's dtype
  promotion does, and one PGD iteration runs the bf16 UNet inside an f32
  chain (the latent stays f32, as in the JAX step);
- one all-bf16 iteration on ``tiny`` (the xl1k path's dtype), on draws
  replayed in bf16 (JAX draws its normals in the latent's dtype).

Both sides start from the goldens' f32 weights; a bf16 network rounds them
once (flax casts them at compute, the port's modules hold them rounded),
so both compute with the same weights.  The tolerances were measured on
the CPU and each is stated at its assert with its reason: f32 for the f32
VAE, and for bf16 a few units of bf16's 2^-8 relative rounding, which the
two frameworks apply at different points of the same operations (XLA
rounds the sampler's scalars to bf16, the port and the reference's
diffusers keep them in f32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import nchw, nhwc, one_torch_thread  # noqa: F401
from test_torch_pgd import GS, SIZE, _port_cfg, _rand, _step_both, golden_jax_model
from test_torch_sdxl import CTX_DIM, POOLED
from tml_image_editing_defense_tpu.attack.pgd import make_attack_data as j_make_attack_data
from tml_image_editing_defense_tpu.attack.pgd import make_pgd_step as j_make_pgd_step
from tml_image_editing_defense_tpu.configs import TrainConfig as JTrainConfig
from tml_image_editing_defense_tpu.core.samplers import LCMSampler as JLCM
from tml_image_editing_defense_tpu.models import build_model as jax_build_model
from tml_image_editing_defense_tpu.models.model_zoo import PromptBank as JBank
from tml_image_editing_defense_tpu.models.vae import AutoencoderKL as JVAE

from tml_image_editing_defense_torch.attack.pgd import EOTDraws, make_attack_data, make_pgd_step
from tml_image_editing_defense_torch.core.samplers import LCMSampler
from tml_image_editing_defense_torch.models.convert import from_jax_params
from tml_image_editing_defense_torch.models.model_zoo import PromptBank, build_model


pytestmark = pytest.mark.usefixtures("one_torch_thread")

BF16 = torch.bfloat16
LAT = (1, SIZE // 2, SIZE // 2, 4)


def _twins(family, dtype, vae_dtype=None):
    """The goldens' weights of ``family`` in a JAX bundle built with
    ``dtype`` / ``vae_dtype`` and in a port bundle built the same way."""
    params = jax.device_get(golden_jax_model(family).params)
    jd = {torch.float32: jnp.float32, BF16: jnp.bfloat16}
    jmodel = jax_build_model(family, image_size=SIZE, params=params, dtype=jd[dtype],
                             vae_dtype=None if vae_dtype is None else jd[vae_dtype])
    pm = build_model(family, image_size=SIZE, device="cpu", dtype=dtype, vae_dtype=vae_dtype)
    pm.unet.load_state_dict(from_jax_params(params["unet"], "unet"))
    pm.vae.load_state_dict(from_jax_params(params["vae"], "vae"))
    for text_model, text_params in zip(pm.text_models, params["text"]):
        text_model.load_state_dict(from_jax_params(text_params, "clip"))
    return jmodel, pm


@pytest.fixture(scope="module")
def mixed():
    """tiny-sdxl with a bf16 UNet and text encoders and an f32 VAE."""
    return _twins("tiny-sdxl", BF16, torch.float32)


def _dtypes(module):
    return {p.dtype for p in module.parameters()}


def update_rel_l2(x1, jx1, x0) -> float:
    """||(x1 - x0) - (jx1 - x0)|| / ||jx1 - x0||: how far the port's PGD
    update lies from the JAX one, relative to its size (NHWC arrays)."""
    x1, jx1, x0 = (np.asarray(a, np.float64) for a in (x1, jx1, x0))
    return float(np.linalg.norm(x1 - jx1) / np.linalg.norm(jx1 - x0))


def test_vae_dtype_builds_each_network_in_its_dtype(mixed):
    _, pm = mixed
    assert _dtypes(pm.vae) == {torch.float32}
    assert _dtypes(pm.unet) == {BF16}
    assert all(_dtypes(t) == {BF16} for t in pm.text_models)
    assert (pm.dtype, pm.vae_dtype) == (BF16, torch.float32)
    plain = build_model("tiny-sdxl", device="cpu", dtype=BF16)
    assert plain.vae_dtype == BF16 and _dtypes(plain.vae) == {BF16}


def test_vae_dtype_encode_and_decode_match_jax(mixed):
    """A bf16 image into the f32 VAE and a bf16 latent out of the UNet into
    its decode: f32 out on both sides, at the f32 tolerance of the port's
    VAE tests (1e-5), since past the cast both compute in f32 on
    bf16-exact inputs."""
    jmodel, pm = mixed
    image = np.clip(_rand(1, (1, SIZE, SIZE, 3), 0.4), -1, 1).astype(jnp.bfloat16)
    latent = _rand(2, LAT).astype(jnp.bfloat16)
    jmean, jlogvar = jmodel.vae.apply({"params": jmodel.params["vae"]}, jnp.asarray(image),
                                      method=JVAE.encode)
    jdec = jmodel.decode_latent(jmodel.params["vae"], jnp.asarray(latent), scaled=False)
    with torch.no_grad():
        mean, logvar = pm.vae.encode(nchw(image.astype(np.float32)).to(BF16))
        dec = pm.decode_latent(nchw(latent.astype(np.float32)).to(BF16), scaled=False)
    assert jmean.dtype == jnp.float32 and jdec.dtype == jnp.float32
    assert mean.dtype == logvar.dtype == dec.dtype == torch.float32
    for got, want in ((mean, jmean), (logvar, jlogvar), (dec, jdec)):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_vae_dtype_pgd_step_matches_jax(mixed):
    """One L2 iteration of the mixed bundle against the jitted JAX step on
    replayed draws: f32 source, latent and sampler, a bf16 UNet inside.
    Measured on the CPU: the losses 4.8e-4 apart (relative), the updates
    x1 - x0 5.0 % apart in L2 relative to their size, 7.6e-3 at most at an
    element (the update's largest element is 0.115).  The bf16 UNet rounds
    every activation and gradient to 8 bits, so two frameworks that round
    at other points of the same chain part by percents through four
    differentiated UNet calls.  Held at twice the measurement: the losses
    at 1e-3, the update at 10 % in L2, the iterate at 1.6e-2 (two bf16 ulps
    at |x| <= 1)."""
    jmodel, pm = mixed
    jcfg = JTrainConfig(
        norm_type="l2", derive_norm_hyperparams=False, eps=12.0, step_size=1.5, grad_reps=2,
        guidance_scale=GS, image_size=SIZE, n_denoising_steps_per_iteration=4,
        limit_timesteps=True, apply_loss_on_images=True, perturbation_loss_lambda=0.3,
        rec_loss_lambda=1.0, prompts=["a", "b", "c"], use_sdxl=True)
    embeds, uncond = _rand(20, (3, 7, CTX_DIM)), _rand(21, (7, CTX_DIM))
    pooled, uncond_pooled = _rand(26, (3, POOLED)), _rand(27, (POOLED,))
    jbank = JBank(embeds=jnp.asarray(embeds), uncond=jnp.asarray(uncond),
                  pooled=jnp.asarray(pooled), uncond_pooled=jnp.asarray(uncond_pooled))
    pbank = PromptBank(embeds=torch.tensor(embeds), uncond=torch.tensor(uncond),
                       pooled=torch.tensor(pooled), uncond_pooled=torch.tensor(uncond_pooled))
    source = np.clip(_rand(23, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    target = np.clip(_rand(24, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    x0 = np.clip(source + _rand(25, source.shape, 0.01), -1, 1)
    (jx1, jaux), (x1, aux) = _step_both(jmodel, pm, jcfg, jbank, pbank,
                                        _rand(22, (4, 1, 16, 16, 4)), source, target, x0,
                                        jax.random.key(78), 4)
    assert x1.dtype == torch.float32 and aux["output_latent"].dtype == torch.float32
    for name in ("avg_loss", "rec_loss", "pert_loss"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]), rtol=1e-3, err_msg=name)
    assert update_rel_l2(nhwc(x1), jx1, x0) <= 0.1
    np.testing.assert_allclose(nhwc(x1), np.asarray(jx1), rtol=0, atol=1.6e-2)


def _replay_draws_bf16(key, grad_reps, n_prompts, n_pool, n_steps) -> EOTDraws:
    """The JAX EOT's draws from ``key`` (test_torch_pgd.replay_draws's key
    tree) with the normals drawn in bf16, as JAX draws them for a bf16
    latent (models/vae.py::sample_latent, the LCM step)."""
    def normal(k):
        return nchw(np.asarray(jax.random.normal(k, LAT, jnp.bfloat16), np.float32))[0].to(BF16)

    k_prompt, k_reps = jax.random.split(key)
    prompt_idx = int(jax.random.randint(k_prompt, (), 0, n_prompts))
    pool_idx, eps, steps = [], [], []
    for rk in jax.random.split(k_reps, grad_reps):
        k_noise, k_fwd = jax.random.split(rk)
        pool_idx.append(int(jax.random.randint(k_noise, (), 0, n_pool)))
        k_vae, k_chain = jax.random.split(k_fwd)
        eps.append(normal(k_vae))
        steps.append(torch.stack([normal(k) for k in jax.random.split(k_chain, n_steps)]))
    return EOTDraws(prompt_idx, pool_idx, torch.stack(eps), torch.stack(steps))


def test_bf16_pgd_step_matches_jax():
    """One all-bf16 L2 iteration on tiny (images, latents, pool, draws and
    networks in bf16) against JAX's bf16 iteration.  Measured on the CPU:
    avg_loss 1.6e-3 apart (relative; rec and pert equal), the updates
    5.7 % apart in L2 relative to their size, the iterates 7.8e-3 at most
    at an element (2^-7: the iterate is rounded to bf16 on both sides,
    and the last bit lands either way).  Held at twice the measurement or
    at two bf16 ulps at |x| <= 1: the losses at 4e-3, the update at 10 %
    in L2, the iterate at 1.6e-2."""
    jmodel, pm = _twins("tiny", BF16)
    jcfg = JTrainConfig(
        norm_type="l2", derive_norm_hyperparams=False, eps=12.0, step_size=1.5, grad_reps=2,
        guidance_scale=GS, image_size=SIZE, n_denoising_steps_per_iteration=4,
        limit_timesteps=True, apply_loss_on_images=True, perturbation_loss_lambda=0.3,
        rec_loss_lambda=1.0, prompts=["a", "b", "c"], dtype="bfloat16")
    embeds, uncond = _rand(20, (3, 7, 32)), _rand(21, (7, 32))
    pool = _rand(22, (4, 1, 16, 16, 4)).astype(jnp.bfloat16)
    source = np.clip(_rand(23, (1, SIZE, SIZE, 3), 0.4), -1, 1).astype(jnp.bfloat16)
    target = np.clip(_rand(24, (1, SIZE, SIZE, 3), 0.4), -1, 1).astype(jnp.bfloat16)
    x0 = np.clip(source.astype(np.float32) + _rand(25, source.shape, 0.01), -1, 1).astype(
        jnp.bfloat16)
    key = jax.random.key(77)

    jsampler = JLCM(jmodel.schedule)
    jplan = jsampler.plan(4, limit_t=700)
    jdata = j_make_attack_data(jmodel, jcfg, jnp.asarray(source), jnp.asarray(target),
                               JBank(embeds=jnp.asarray(embeds), uncond=jnp.asarray(uncond)),
                               jnp.asarray(pool))
    jx1, jaux = jax.jit(j_make_pgd_step(jmodel, jsampler, jplan, jcfg))(
        jmodel.params, jnp.asarray(x0), jdata, key)

    def t(a):
        return nchw(np.asarray(a, np.float32)).to(BF16)

    cfg = _port_cfg(jcfg)
    sampler = LCMSampler(pm.schedule)
    plan = sampler.plan(4, limit_t=700)
    ppool = torch.from_numpy(np.ascontiguousarray(
        np.asarray(pool, np.float32).transpose(0, 1, 4, 2, 3))).to(BF16)
    data = make_attack_data(pm, cfg, t(source), t(target),
                            PromptBank(embeds=torch.tensor(embeds), uncond=torch.tensor(uncond)),
                            ppool)
    draws = _replay_draws_bf16(key, cfg.grad_reps, 3, 4, plan.num_steps)
    x1, aux = make_pgd_step(pm, sampler, plan, cfg)(t(x0), data, draws)

    assert x1.dtype == BF16 and jx1.dtype == jnp.bfloat16
    for name in ("avg_loss", "rec_loss", "pert_loss"):
        np.testing.assert_allclose(float(aux[name].float()), float(jaux[name]), rtol=4e-3,
                                   err_msg=name)
    assert update_rel_l2(nhwc(x1.float()), np.asarray(jx1, np.float32),
                         np.asarray(x0, np.float32)) <= 0.1
    np.testing.assert_allclose(nhwc(x1.float()), np.asarray(jx1, np.float32), rtol=0,
                               atol=1.6e-2)
