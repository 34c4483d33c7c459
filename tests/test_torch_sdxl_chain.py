"""The SDXL editing chain of the port against the JAX package's, on
``tiny-sdxl`` and ``tiny-sdxl-refiner`` with the goldens' weights (key 0,
flax init): the attack forward against the JAX forward and the committed
golden, one L2 PGD iteration against the jitted JAX step, and the img2img
pipeline (Euler; the refiner's aesthetic 5-tuple with ``denoising_end``).

The random draws of the JAX key tree are replayed into the port's explicit
draws (``replay_draws``, ``_replay``).  Tolerance rtol = atol = 2e-4, that
of tests/test_torch_pgd.py; see the attack forward's test for its f32 rule.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import nchw, nhwc, one_torch_thread, port_model_from_jax  # noqa: F401
from test_torch_pgd import GOLDEN_PATH, GS, SIZE, TOL, _rand, _step_both, golden_jax_model
from test_torch_pipelines import _replay
from test_torch_sdxl import CTX_DIM, LAT, POOLED
from tml_image_editing_defense_tpu.attack.forward import CondInputs as JCond
from tml_image_editing_defense_tpu.attack.forward import attack_forward as j_attack_forward
from tml_image_editing_defense_tpu.attack.forward import make_time_ids as j_make_time_ids
from tml_image_editing_defense_tpu.configs import TrainConfig as JTrainConfig
from tml_image_editing_defense_tpu.core.samplers import LCMSampler as JLCM
from tml_image_editing_defense_tpu.models.model_zoo import PromptBank as JBank
from tml_image_editing_defense_tpu.pipelines import Img2ImgPipeline as JImg2Img

from tml_image_editing_defense_torch import api
from tml_image_editing_defense_torch.attack.forward import (
    CondInputs,
    attack_forward_from_latent,
    make_time_ids,
)
from tml_image_editing_defense_torch.core.samplers import LCMSampler
from tml_image_editing_defense_torch.models.model_zoo import PromptBank
from tml_image_editing_defense_torch.models.vae import sample_latent
from tml_image_editing_defense_torch.pipelines import Img2ImgPipeline

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def golden():
    """The goldens' tiny-sdxl model and its port twin."""
    jmodel = golden_jax_model("tiny-sdxl")
    return jmodel, port_model_from_jax(jmodel, family="tiny-sdxl")


# ---------------------------------------------------------------------------
# the attack
# ---------------------------------------------------------------------------


def test_sdxl_attack_forward_matches_golden_and_jax(golden):
    """The golden of test_whole_program_goldens.py:109-121: LCM K = 2 on
    tiny-sdxl, a pooled embed and the 6-tuple.

    This chain's output reaches |x| = 322, and it amplifies the UNet's f32
    rounding (guidance 3, 1 / sqrt(alpha_bar) at t = 999, the 1 / 0.13025
    unscale): the JAX package's own f32 forward lies 4.3e-4 from the same
    forward in f64, the port's 5.9e-4, so two f32 forwards may differ by
    more than 2e-4 at an element.  The port's forward is therefore held at
    rtol = atol = 2e-4 in f64 (the function against the JAX f32 forward and
    the golden), and in f32 at rtol 2e-4 with atol 1e-5 of the largest
    |value| (the modules' 1e-5 at the chain's scale)."""
    import copy

    jmodel, pm = golden
    image = np.clip(_rand(1, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    ctx = _rand(10, (2, 77, CTX_DIM))
    pooled = _rand(11, (2, POOLED))
    noise = _rand(12, LAT)
    key = jax.random.key(13)
    jsampler = JLCM(jmodel.schedule)
    jcond = JCond(ctx=jnp.asarray(ctx), text_embeds=jnp.asarray(pooled),
                  time_ids=j_make_time_ids(SIZE, jnp.float32))
    want = np.asarray(j_attack_forward(jmodel, jsampler, jsampler.plan(2), jmodel.params,
                                       jnp.asarray(image), jcond, jnp.asarray(noise), GS, key,
                                       "none"))
    golden_latent = np.load(GOLDEN_PATH)["sdxl_attack_forward_latent"]
    k_vae, k_chain = jax.random.split(key)
    eps = nchw(np.asarray(jax.random.normal(k_vae, LAT, jnp.float32)))
    steps = torch.stack([nchw(np.asarray(jax.random.normal(k, LAT)))[0]
                         for k in jax.random.split(k_chain, 2)])

    def forward(model, dtype):
        sampler = LCMSampler(model.schedule)
        cond = CondInputs(ctx=torch.tensor(ctx, dtype=dtype),
                          text_embeds=torch.tensor(pooled, dtype=dtype),
                          time_ids=make_time_ids(SIZE, dtype))
        with torch.no_grad():
            mean, logvar = model.vae.encode(nchw(image).to(dtype))
            z = sample_latent(mean, logvar, eps.to(dtype)) * model.vae_scaling
            out = attack_forward_from_latent(model, sampler, sampler.plan(2), z, cond,
                                             nchw(noise).to(dtype), GS, steps.to(dtype))
        return nhwc(out).astype(np.float64)

    pm64 = copy.deepcopy(pm)
    pm64.unet.double()
    pm64.vae.double()
    got64 = forward(pm64, torch.float64)
    np.testing.assert_allclose(got64, want, **TOL)
    np.testing.assert_allclose(got64, golden_latent, **TOL)
    got32 = forward(pm, torch.float32)
    for ref in (want, golden_latent):
        np.testing.assert_allclose(got32, ref, rtol=2e-4, atol=1e-5 * np.abs(ref).max())


def test_sdxl_pgd_step_matches_jitted_jax_step(golden):
    """One L2 iteration on tiny-sdxl (pooled bank, 6-tuple time ids made
    from ``cfg.image_size``) against the jitted JAX ``make_pgd_step`` on
    replayed draws."""
    jmodel, pm = golden
    jcfg = JTrainConfig(
        norm_type="l2", derive_norm_hyperparams=False, eps=12.0, step_size=1.5, grad_reps=2,
        guidance_scale=GS, image_size=SIZE, n_denoising_steps_per_iteration=4,
        limit_timesteps=True, apply_loss_on_images=True, perturbation_loss_lambda=0.3,
        rec_loss_lambda=1.0, prompts=["a", "b", "c"], use_sdxl=True,
    )
    embeds, uncond = _rand(20, (3, 7, CTX_DIM)), _rand(21, (7, CTX_DIM))
    pooled, uncond_pooled = _rand(26, (3, POOLED)), _rand(27, (POOLED,))
    jbank = JBank(embeds=jnp.asarray(embeds), uncond=jnp.asarray(uncond),
                  pooled=jnp.asarray(pooled), uncond_pooled=jnp.asarray(uncond_pooled))
    pbank = PromptBank(embeds=torch.tensor(embeds), uncond=torch.tensor(uncond),
                       pooled=torch.tensor(pooled), uncond_pooled=torch.tensor(uncond_pooled))
    pool = _rand(22, (4, 1, 16, 16, 4))
    source = np.clip(_rand(23, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    target = np.clip(_rand(24, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    x0 = np.clip(source + _rand(25, source.shape, 0.01), -1, 1)
    (jx1, jaux), (x1, aux) = _step_both(jmodel, pm, jcfg, jbank, pbank, pool, source, target,
                                        x0, jax.random.key(78), 4)
    for name in ("avg_loss", "rec_loss", "pert_loss"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]), rtol=2e-4, err_msg=name)
    np.testing.assert_allclose(nhwc(aux["output_image"]), np.asarray(jaux["output_image"]), **TOL)
    np.testing.assert_allclose(nhwc(x1), np.asarray(jx1), **TOL)
    assert float(torch.linalg.vector_norm(x1 - nchw(source))) <= 12.0 + 1e-4


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------


def test_sdxl_img2img_euler_matches_jax(golden):
    """A batch of two images on tiny-sdxl with SDXL's training sampler
    without LCM (Euler): pooled embeds and time ids repeated per image."""
    jmodel, pm = golden
    images = np.clip(_rand(2, (2, SIZE, SIZE, 3), 0.4), -1, 1)
    noise = _rand(3, LAT)
    key = jax.random.key(4)
    kind = api.training_sampler_kind(pm.base_family, False)
    assert kind == "euler"
    want = JImg2Img(jmodel, sampler=kind)(
        "a cat", jnp.asarray(images), num_inference_steps=5, guidance_scale=GS, strength=0.6,
        noise=jnp.asarray(noise), key=key, output_type="array")
    vae_eps, _ = _replay(key, 0, 2)
    got = Img2ImgPipeline(pm, sampler=kind)(
        "a cat", nchw(images), num_inference_steps=5, guidance_scale=GS, strength=0.6,
        noise=nchw(noise), vae_eps=vae_eps, output_type="pt")
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_refiner_denoising_end_with_aesthetic_score_matches_jax():
    """The refiner's 5-tuple (aesthetic 6.0, negative 2.5) with
    ``denoising_end`` cutting the LCM plan short, as JAX
    tests/test_api.py:686-730 runs them, against the JAX pipeline on the
    same key."""
    jmodel = golden_jax_model("tiny-sdxl-refiner")
    pm = port_model_from_jax(jmodel, family="tiny-sdxl-refiner")
    image = np.clip(_rand(5, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    noise = _rand(6, LAT)
    key = jax.random.key(7)
    kw = dict(num_inference_steps=4, guidance_scale=4.0, strength=0.8, denoising_end=0.6,
              aesthetic_score=6.0, negative_aesthetic_score=2.5)
    want = JImg2Img(jmodel, sampler="lcm")("gold", jnp.asarray(image), noise=jnp.asarray(noise),
                                           key=key, output_type="array", **kw)
    pipe = Img2ImgPipeline(pm, sampler="lcm")
    plan = pipe.plan(4, 0.8, denoising_end=0.6)
    assert 0 < plan.num_steps < pipe.plan(4, 0.8).num_steps
    vae_eps, step_noise = _replay(key, plan.num_steps, 1)
    got = pipe("gold", nchw(image), noise=nchw(noise), vae_eps=vae_eps, step_noise=step_noise,
               output_type="pt", **kw)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
