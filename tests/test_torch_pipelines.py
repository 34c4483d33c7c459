"""The port's editing pipelines against the JAX package's, on the tiny family
with the goldens' weights (key 0, flax init; ``golden_jax_model``).

The JAX pipelines draw from a key: ``generate`` splits it into the VAE
posterior key and the chain key, whose per-step split feeds DDIM's (eta >
0) and LCM's step noise.  Those draws are replayed here into the port's
explicit ``vae_eps`` and ``step_noise``.  Tolerance rtol = atol = 2e-4, that
of the PGD golden (tests/test_torch_pgd.py): the two frameworks sum in
different orders through a multi-step chain and two VAE passes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import nchw, nhwc, one_torch_thread, port_model_from_jax  # noqa: F401
from test_torch_pgd import GOLDEN_PATH, SIZE, golden_jax_model
from tml_image_editing_defense_tpu.pipelines import Img2ImgPipeline as JImg2Img
from tml_image_editing_defense_tpu.pipelines import Txt2ImgPipeline as JTxt2Img

from tml_image_editing_defense_torch.pipelines import Img2ImgPipeline, Txt2ImgPipeline

TOL = dict(rtol=2e-4, atol=2e-4)
GS = 3.0
LAT = (1, SIZE // 2, SIZE // 2, 4)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _rand(seed, shape, scale=1.0):
    return np.asarray(jax.random.normal(jax.random.key(seed), shape, jnp.float32) * scale)


@pytest.fixture(scope="module")
def models():
    jmodel = golden_jax_model("tiny")
    return jmodel, port_model_from_jax(jmodel)


def _replay(key, n_steps, batch):
    """(vae_eps [B, C, h, w], step noise [K, B, C, h, w]) of the JAX
    ``generate`` (pipelines/img2img.py:83, forward.py:142) from ``key``."""
    k_vae, k_chain = jax.random.split(key)
    lat = (batch, *LAT[1:])
    eps = nchw(np.asarray(jax.random.normal(k_vae, lat, jnp.float32)))
    steps = torch.stack([nchw(np.asarray(jax.random.normal(k, lat, jnp.float32)))
                         for k in jax.random.split(k_chain, max(n_steps, 1))])
    return eps, steps


def test_img2img_matches_golden(models):
    """The golden of test_whole_program_goldens.py:99-107: PLMS, 4 steps at
    strength 0.6, caller-fixed noise, the posterior drawn from key 9."""
    _, pm = models
    image = np.clip(_rand(1, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    pipe = Img2ImgPipeline(pm, sampler="plms")
    vae_eps, _ = _replay(jax.random.key(9), 0, 1)
    got = pipe("a painting", nchw(image), num_inference_steps=4, guidance_scale=GS,
               strength=0.6, noise=nchw(_rand(8, LAT)), vae_eps=vae_eps, output_type="pt")
    np.testing.assert_allclose(nhwc(got), np.load(GOLDEN_PATH)["img2img_image"], **TOL)


@pytest.mark.parametrize("sampler,kwargs,steps,strength", [("ddim", {"eta": 0.7}, 5, 0.8),
                                                            ("lcm", {}, 4, 0.6)])
def test_img2img_batch_matches_jax_with_step_noise(models, sampler, kwargs, steps, strength):
    """A batch of two images through samplers that draw step noise, against
    the JAX pipeline on the same key."""
    jmodel, pm = models
    images = np.clip(_rand(2, (2, SIZE, SIZE, 3), 0.4), -1, 1)
    noise = _rand(3, LAT)
    key = jax.random.key(4)
    want = JImg2Img(jmodel, sampler=sampler, **kwargs)(
        "a cat", jnp.asarray(images), num_inference_steps=steps, guidance_scale=GS,
        strength=strength, noise=jnp.asarray(noise), key=key, output_type="array")
    pipe = Img2ImgPipeline(pm, sampler=sampler, **kwargs)
    plan = pipe.plan(steps, strength)
    vae_eps, step_noise = _replay(key, plan.num_steps, 2)
    got = pipe("a cat", nchw(images), num_inference_steps=steps, guidance_scale=GS,
               strength=strength, noise=nchw(noise), vae_eps=vae_eps, step_noise=step_noise,
               output_type="pt")
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_edit_pairs_equal_sequential_calls(models):
    """Two (clean, adv) cells in one batch give each cell's own call:
    equal within 1e-5 (the convolutions may sum in another order at another
    batch size)."""
    _, pm = models
    pipe = Img2ImgPipeline(pm, sampler="lcm")
    gen = torch.Generator().manual_seed(0)
    pairs = torch.rand((2, 2, 3, SIZE, SIZE), generator=gen) * 2 - 1
    noises, eps = (torch.randn((2, 2, 4, 16, 16), generator=gen) for _ in range(2))
    steps = torch.randn((2, 2, 2, 4, 16, 16), generator=gen)
    prompts = ["gold", "lego"]
    kw = dict(num_inference_steps=4, guidance_scale=GS, strength=0.6)
    batched = pipe.edit_pairs(prompts, pairs, noises, eps, steps, **kw)
    for c in range(2):
        one = pipe(prompts[c], pairs[c], noise=noises[c], vae_eps=eps[c], step_noise=steps[c],
                   output_type="pt", **kw)
        torch.testing.assert_close(batched[c], one, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(batched[0], batched[1])


def test_txt2img_matches_jax(models):
    """Euler from latents drawn on the host and scaled by the plan's initial
    sigma, as the JAX pipeline draws and scales them."""
    jmodel, pm = models
    key = jax.random.key(5)
    want = JTxt2Img(jmodel, sampler="euler")("a cat", num_inference_steps=3, guidance_scale=GS,
                                             key=key, output_type="array")
    _, sub = jax.random.split(key)
    pipe = Txt2ImgPipeline(pm, sampler="euler")
    latents = nchw(np.asarray(jax.random.normal(sub, LAT, jnp.float32))) * pipe.sampler.plan(
        3).init_sigma
    got = pipe("a cat", num_inference_steps=3, guidance_scale=GS, latents=latents,
               output_type="pt")
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("left_out", ["noise", "vae_eps", "step_noise", "latents"])
def test_missing_draws_raise(models, left_out):
    """The pipelines draw nothing themselves: every draw an edit needs is an
    argument, and one left out raises before any model call."""
    _, pm = models
    lat = torch.zeros((1, 4, SIZE // 2, SIZE // 2))
    draws = dict(noise=lat, vae_eps=lat, step_noise=torch.zeros((2, 1, 4, SIZE // 2, SIZE // 2)),
                 latents=lat)
    del draws[left_out]
    with pytest.raises(ValueError, match=left_out):
        if left_out == "latents":
            Txt2ImgPipeline(pm, sampler="lcm")("x", num_inference_steps=2,
                                               step_noise=draws["step_noise"])
        else:
            draws.pop("latents")
            Img2ImgPipeline(pm, sampler="lcm")("x", torch.zeros((1, 3, SIZE, SIZE)),
                                               num_inference_steps=2, **draws)
