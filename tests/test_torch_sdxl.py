"""The port's SDXL family against the JAX package's, on ``tiny-sdxl`` and
``tiny-sdxl-refiner``.

SDXL differs from SD-1.5 in its conditioning: two text encoders whose
penultimate states are concatenated, encoder 2's pooled (projected) output,
and the UNet's ``text_time`` embedding of the pooled embeds and the
micro-conditioning time ids (6-tuple; the refiner's 5-tuple with an
aesthetic score).  Here: the modules (weights through ``from_jax_params``,
rtol = atol = 1e-5 as in tests/test_torch_models.py), the time ids
(exactly), the default family, and ``immunize`` and ``evaluate`` with
``use_sdxl`` on the CPU.  The chain, the PGD iteration and the pipelines
are in tests/test_torch_sdxl_chain.py.

Also the training sampler of every family, which follows the JAX package's
base family ("sd15" for SD-1.5-inpaint, "sdxl" for every SDXL family).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import TOL as MODULE_TOL
from test_torch_models import jittered, nchw, nhwc, one_torch_thread  # noqa: F401
from test_torch_models import port_model_from_jax
from test_torch_pgd import SIZE
from tml_image_editing_defense_tpu import api as j_api
from tml_image_editing_defense_tpu.attack.forward import make_time_ids as j_make_time_ids
from tml_image_editing_defense_tpu.configs import TrainConfig as JTrainConfig
from tml_image_editing_defense_tpu.models import build_model as jax_build_model

from tml_image_editing_defense_torch import api
from tml_image_editing_defense_torch.attack.forward import make_time_ids
from tml_image_editing_defense_torch.configs import InferenceConfig, TrainConfig
from tml_image_editing_defense_torch.models.clip_text import TINY_TEXT, CLIPTextModel
from tml_image_editing_defense_torch.models.convert import from_jax_params
from tml_image_editing_defense_torch.models.model_zoo import build_model
from tml_image_editing_defense_torch.models.unet import (
    TINY_SDXL_REFINER_UNET,
    TINY_SDXL_UNET,
    UNet2DCondition,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAMILIES = ("sd15", "sd15-inpaint", "sdxl", "tiny", "tiny-inpaint", "tiny-sdxl",
            "tiny-sdxl-refiner")
LAT = (1, SIZE // 2, SIZE // 2, 4)
POOLED = TINY_TEXT.projection_dim
CTX_DIM = TINY_SDXL_UNET.cross_attention_dim        # two tiny encoders side by side


@pytest.fixture(scope="module")
def jittered_models():
    """tiny-sdxl and tiny-sdxl-refiner with jittered weights (fast init)."""
    out = {}
    for i, family in enumerate(("tiny-sdxl", "tiny-sdxl-refiner")):
        m = jax_build_model(family, key=jax.random.key(5 + i), image_size=SIZE, fast_init=True)
        out[family] = dataclasses.replace(m, params=jittered(m.params, 30 + i))
    return out


# ---------------------------------------------------------------------------
# the sampler: the JAX base family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("use_lcm", [True, False])
def test_training_sampler_follows_the_jax_base_family(family, use_lcm):
    """immunize and evaluate pick their sampler from the model's base
    family; it must be the sampler the JAX package picks from its
    ``model.family``.  SD-1.5-inpaint without LCM trains with PLMS."""
    j_family = jax_build_model(family, params={}).family
    model = build_model(family, device="meta")
    assert model.base_family == j_family
    got = api.training_sampler_kind(model.base_family, use_lcm)
    assert got == j_api.training_sampler_kind(j_family, use_lcm)
    if family == "sd15-inpaint" and not use_lcm:
        assert got == "plms"


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["tiny-sdxl", "tiny-sdxl-refiner"])
@pytest.mark.parametrize("t", [[519, 41], [279, 279]])
def test_sdxl_unet_matches_jax(jittered_models, family, t):
    """Pooled embeds and time ids through ``add_embedding``: the 6-tuple on
    the base preset, the aesthetic 5-tuple on the refiner."""
    jm = jittered_models[family]
    params = jm.params["unet"]
    rng = np.random.default_rng(sum(t) + len(family))
    sample = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, CTX_DIM)).astype(np.float32)
    pooled = rng.standard_normal((2, POOLED)).astype(np.float32)
    score = 6.0 if family.endswith("refiner") else None
    tids = np.asarray(j_make_time_ids(SIZE, aesthetic_score=score))
    want = np.asarray(jm.unet.apply({"params": params}, sample, jnp.asarray(t), ctx,
                                    text_embeds=pooled, time_ids=tids))
    unet = UNet2DCondition(TINY_SDXL_REFINER_UNET if score else TINY_SDXL_UNET)
    unet.load_state_dict(from_jax_params(params, "unet"))
    with torch.no_grad():
        got = unet(nchw(sample), torch.tensor(t), torch.from_numpy(ctx),
                   torch.from_numpy(pooled), torch.tensor(tids))
        with pytest.raises(ValueError, match="text_embeds and time_ids"):
            unet(nchw(sample), torch.tensor(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(nhwc(got), want, **MODULE_TOL)


def test_clip_gelu_with_projection_matches_jax():
    """The bigG encoder's activation (exact-erf gelu) and its projection, at
    the tiny width."""
    from tml_image_editing_defense_tpu.models.clip_text import TINY_TEXT as J_TEXT
    from tml_image_editing_defense_tpu.models.clip_text import CLIPTextModel as JCLIP

    jcfg = dataclasses.replace(J_TEXT, hidden_act="gelu")
    module = JCLIP(jcfg)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 998, (3, 16)).astype(np.int32)
    ids[:, 0], ids[0, 4:], ids[1, 11:], ids[2, 15] = 998, 999, 999, 999
    params = jittered(module.init(jax.random.key(8), jnp.asarray(ids))["params"], 12)
    want = module.apply({"params": params}, jnp.asarray(ids))
    clip = CLIPTextModel(dataclasses.replace(TINY_TEXT, hidden_act="gelu"))
    clip.load_state_dict(from_jax_params(params, "clip"))
    with torch.no_grad():
        got = clip(torch.from_numpy(ids).long())
    assert got[2].shape == (3, POOLED)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODULE_TOL)


def test_sdxl_prompt_bank_matches_jax(jittered_models):
    """Both encoders' penultimate states side by side, and encoder 2's
    pooled output, for the prompts and the negative prompt."""
    jm = jittered_models["tiny-sdxl"]
    pm = port_model_from_jax(jm, family="tiny-sdxl")
    prompts = ["a painting, detailed", ", detailed", "in a city under the rain, detailed"]
    want = jm.embed_prompt_bank(prompts, "blurry")
    got = pm.embed_prompt_bank(prompts, "blurry")
    assert got.embeds.shape == (3, 16, CTX_DIM) and got.pooled.shape == (3, POOLED)
    for name in ("embeds", "uncond", "pooled", "uncond_pooled"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **MODULE_TOL)
    cond, uncond, pooled, uncond_pooled = pm.encode_prompt(prompts[2], "blurry")
    assert torch.equal(cond, got.embeds[2]) and torch.equal(pooled, got.pooled[2])


@pytest.mark.parametrize("kw", [{}, {"aesthetic_score": 6.0},
                                {"aesthetic_score": 6.0, "negative_aesthetic_score": 3.0}],
                         ids=["six", "aesthetic", "aesthetic-negative"])
@pytest.mark.parametrize("size", [512, 1024])
def test_make_time_ids_equals_jax(kw, size):
    got = make_time_ids(size, **kw)
    want = np.asarray(j_make_time_ids(size, jnp.float32, **kw))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the api on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{"use_sdxl": True}, {"use_sdxl": False},
                                {"use_sdxl": False, "attack_mode": "inpaint"}])
def test_default_family_is_the_jax_one(kw):
    """``use_sdxl`` picks the "sdxl" family, as in the JAX package."""
    for port_cls, jax_cls in ((TrainConfig, JTrainConfig),
                              (InferenceConfig, j_api.InferenceConfig)):
        if "attack_mode" in kw and port_cls is InferenceConfig:
            continue
        assert api._default_family(port_cls(**kw)) == j_api._default_family(jax_cls(**kw))


def _images(tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    for name in ("source.png", "target.png"):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(tmp_path / name)
        paths.append(tmp_path / name)
    return paths


@pytest.fixture(scope="module")
def sdxl_run(tmp_path_factory):
    """``api.immunize`` with ``use_sdxl`` on tiny-sdxl, 2 iterations."""
    tmp = tmp_path_factory.mktemp("sdxl")
    src, tgt = _images(tmp)
    cfg = TrainConfig(source_image_path=src, target_image_path=tgt, output_path=tmp / "out",
                      use_sdxl=True, model_family="tiny-sdxl", image_size=SIZE,
                      n_optimization_steps=2, derive_norm_hyperparams=False, eps=2.0,
                      step_size=1.0, grad_reps=2, prompts=["a", "b"])
    return cfg, api.immunize(cfg, device="cpu")


def test_immunize_sdxl_on_cpu_writes_the_artifacts(sdxl_run):
    cfg, result = sdxl_run
    out = cfg.output_path
    assert result.model.family == "tiny-sdxl" and result.model.base_family == "sdxl"
    for name in ("adversarial_image.png", "noise.npz", "metrics.jsonl"):
        assert (out / name).is_file(), name
    assert len(result.history) == 2
    assert all(np.isfinite(h["avg_loss"]) for h in result.history)
    from tml_image_editing_defense_torch.core.image_ops import load_image

    x_src = torch.from_numpy(load_image(cfg.source_image_path, SIZE))
    assert float(torch.linalg.vector_norm(result.x_adv - x_src)) <= cfg.eps + 1e-4


def test_evaluate_sdxl_on_cpu_writes_the_jax_file_names(sdxl_run, tmp_path):
    """``use_sdxl`` evaluation on tiny-sdxl with Euler (SDXL without LCM) and
    the pinned noise pool; the grids carry the JAX evaluate's names
    (api.py:734-736)."""
    cfg, result = sdxl_run
    icfg = InferenceConfig(source_image_path=cfg.source_image_path,
                           target_image_path=cfg.target_image_path, use_sdxl=True,
                           model_family="tiny-sdxl", image_size=SIZE, n_steps=4,
                           output_path=tmp_path / "eval", validation_images_path=None)
    grids = api.evaluate(icfg, result.adversarial_image, ["gold"], device="cpu",
                         model=result.model, noises=result.noise_pool)
    assert len(grids) == 1 and np.asarray(grids[0]).sum() > 0
    assert sorted(p.name for p in (tmp_path / "eval").glob("*.png")) == ["gold,-detailed_noise_0.png"]
