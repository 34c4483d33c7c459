"""Real weights in the port: a diffusers model directory, the TAESD
directory, the params bundle through every entry point, and
``prepare_real_weights``, all against the JAX package on the tiny families.

The directories are written from JAX models with the JAX exporter and
``safetensors.numpy`` (as tests/test_real_weights_procedure.py writes them);
the port reads them with its own reader.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tml_image_editing_defense_tpu.models import build_model as jax_build_model
from tml_image_editing_defense_tpu.models import checkpoint_io as j_io
from tml_image_editing_defense_tpu.models.convert import export_state_dict
from tml_image_editing_defense_tpu.models.convert import load_sd_checkpoint as j_load_sd
from tml_image_editing_defense_tpu.models.lora import fuse_lora as j_fuse_lora
from tml_image_editing_defense_tpu.models.tiny_vae import build_tiny_autoencoder as j_taesd
from tml_image_editing_defense_tpu.models.tiny_vae import load_taesd_checkpoint as j_load_taesd

from tml_image_editing_defense_torch import api, cli, prepare_real_weights, universal_attack
from tml_image_editing_defense_torch.configs import InferenceConfig, TrainConfig
from tml_image_editing_defense_torch.models import checkpoint_io, tiny_vae
from tml_image_editing_defense_torch.models.convert import (
    from_jax_params,
    load_sd_checkpoint,
)
from tml_image_editing_defense_torch.models.model_zoo import build_model
from tml_image_editing_defense_torch.models.tokenizer import HFCLIPTokenizer
from test_torch_clip_tokenizer import _write_dir as write_tokenizer_dir
from test_torch_models import jittered, nchw, nhwc, one_torch_thread  # noqa: F401
from test_torch_tiny_vae import _random_params

safetensors_numpy = pytest.importorskip("safetensors.numpy")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=1e-5, atol=1e-5)
SUBDIRS = (("unet", "unet"), ("vae", "vae"), ("text_encoder", "clip"), ("text_encoder_2", "clip"))


@functools.lru_cache(maxsize=None)
def _jax_model(family):
    """The JAX bundle of ``family``, built once (its weights are jittered
    per test)."""
    return jax_build_model(family, key=jax.random.key(3), image_size=32, fast_init=True)


def write_diffusers_dir(d, params, dtype=np.float32):
    """A diffusers-layout directory of the JAX tree ``params``."""
    parts = {"unet": params["unet"], "vae": params["vae"], "text_encoder": params["text"][0]}
    if len(params["text"]) > 1:
        parts["text_encoder_2"] = params["text"][1]
    for sub, kind in SUBDIRS:
        if sub in parts:
            (d / sub).mkdir(parents=True, exist_ok=True)
            state = {k: np.ascontiguousarray(v).astype(dtype)
                     for k, v in export_state_dict(parts[sub], kind).items()}
            safetensors_numpy.save_file(state, str(d / sub / "model.safetensors"))
    return d


@pytest.fixture(scope="module", params=["tiny", "tiny-sdxl"])
def ckpt(request, tmp_path_factory):
    """(family, directory, JAX model holding the directory's weights)."""
    family = request.param
    m = _jax_model(family)
    m = dataclasses.replace(m, params=jittered(m.params, 31))
    d = write_diffusers_dir(tmp_path_factory.mktemp(f"ckpt_{family}"), m.params)
    return family, d, m


def _port_template(family):
    return build_model(family, image_size=32, device="cpu",
                       generator=torch.Generator().manual_seed(77))


def test_load_sd_checkpoint_matches_jax(ckpt):
    """The port's loader and the JAX loader on one directory: the UNet call
    and the VAE encode agree within 1e-5."""
    family, d, jm = ckpt
    pm = load_sd_checkpoint(d, _port_template(family))
    jparams = j_load_sd(d, jax.device_get(jm.params))
    rng = np.random.default_rng(0)
    sample = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, pm.unet.config.cross_attention_dim)).astype(np.float32)
    kw_j, kw_p = {}, {}
    if "sdxl" in family:
        pooled = pm.unet.config.projection_class_embeddings_input_dim - 6 * \
            pm.unet.config.addition_time_embed_dim
        te = rng.standard_normal((2, pooled)).astype(np.float32)
        ids = np.tile(np.asarray([32, 32, 0, 0, 32, 32], np.float32), (2, 1))
        kw_j = {"text_embeds": te, "time_ids": ids}
        kw_p = {"text_embeds": torch.from_numpy(te), "time_ids": torch.from_numpy(ids)}
    want = jax.jit(lambda p, *a, **k: jm.unet.apply({"params": p}, *a, **k))(
        jparams["unet"], sample, jnp.asarray([519, 41]), ctx, **kw_j)
    with torch.no_grad():
        got = pm.unet(nchw(sample), torch.tensor([519, 41]), torch.from_numpy(ctx), **kw_p)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    x = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    mean, _ = jax.jit(lambda p, x: jm.vae.apply({"params": p}, x, method="encode"))(
        jparams["vae"], x)
    with torch.no_grad():
        t_mean, _ = pm.vae.encode(nchw(x))
    np.testing.assert_allclose(nhwc(t_mean), np.asarray(mean), **TOL)
    assert len(pm.text_models) == len(jparams["text"])


@pytest.fixture()
def tiny_dir(tmp_path):
    m = _jax_model("tiny")
    return write_diffusers_dir(tmp_path / "ckpt", jittered(m.params, 41)), jittered(m.params, 41)


def _edit(path, fn):
    state = dict(safetensors_numpy.load_file(str(path)))
    fn(state)
    safetensors_numpy.save_file(state, str(path))


def test_missing_key_raises_and_keeps_the_template_when_not_strict(tiny_dir, capsys):
    d, _ = tiny_dir
    key = "conv_in.weight"
    _edit(d / "unet" / "model.safetensors", lambda s: s.pop(key))
    with pytest.raises(KeyError, match="unmapped"):
        load_sd_checkpoint(d, _port_template("tiny"))
    pm = _port_template("tiny")
    kept = pm.unet.conv_in.weight.clone()
    load_sd_checkpoint(d, pm, strict=False)
    assert "warning" in capsys.readouterr().out
    assert torch.equal(pm.unet.conv_in.weight, kept)
    state = safetensors_numpy.load_file(str(d / "unet" / "model.safetensors"))
    np.testing.assert_array_equal(pm.unet.conv_out.weight.numpy(), state["conv_out.weight"])


def test_wrong_shape_raises_before_anything_moves(tiny_dir):
    d, _ = tiny_dir
    _edit(d / "vae" / "model.safetensors",
          lambda s: s.__setitem__("quant_conv.bias", np.zeros(3, np.float32)))
    pm = _port_template("tiny")
    before = pm.vae.encoder.conv_in.weight.clone()
    with pytest.raises(ValueError, match="shape mismatch for quant_conv.bias"):
        load_sd_checkpoint(d, pm)
    assert torch.equal(pm.vae.encoder.conv_in.weight, before)


def test_extra_keys_are_ignored_and_fp16_is_cast(tmp_path):
    """An older CLIP file's ``position_ids`` is ignored; an fp16 checkpoint
    lands cast into the f32 model, as the JAX converter casts it."""
    m = _jax_model("tiny")
    params = jittered(m.params, 51)
    d = write_diffusers_dir(tmp_path / "ckpt", params, dtype=np.float16)
    _edit(d / "text_encoder" / "model.safetensors",
          lambda s: s.__setitem__("text_model.embeddings.position_ids",
                                  np.arange(16, dtype=np.int64)[None]))
    pm = load_sd_checkpoint(d, _port_template("tiny"))
    jp = j_load_sd(d, jax.device_get(m.params))
    for module, tree, kind in ((pm.unet, jp["unet"], "unet"), (pm.vae, jp["vae"], "vae"),
                               (pm.text_models[0], jp["text"][0], "clip")):
        for k, v in from_jax_params(tree, kind).items():
            got = module.state_dict()[k]
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, v, rtol=0, atol=0)


def test_empty_directory_raises(tmp_path):
    (tmp_path / "unet").mkdir()
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        load_sd_checkpoint(tmp_path, _port_template("tiny"))


def test_taesd_checkpoint_decodes_as_jax(tmp_path):
    """A random ``taesd`` export loaded by both packages' loaders: the
    decode of a 64x64 image's latents agrees within 1e-5."""
    jt = j_taesd("taesd", key=jax.random.key(6), fast_init=True)
    params = _random_params(jt.module, (1, 64, 64, 3), 61)
    d = tmp_path / "taesd"
    d.mkdir()
    state = {k: np.ascontiguousarray(v) for k, v in export_state_dict(params, "vae").items()}
    safetensors_numpy.save_file(state, str(d / "diffusion_pytorch_model.safetensors"))
    jl = j_load_taesd(d)
    pt = tiny_vae.load_taesd_checkpoint(d, device="cpu")
    z = np.random.default_rng(6).standard_normal((1, 8, 8, 4)).astype(np.float32)
    want = jax.jit(lambda p, z: jl.module.apply({"params": p}, z, method="decode"))(jl.params, z)
    with torch.no_grad():
        got = pt.decode(nchw(z))
    assert got.shape == (1, 3, 64, 64)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    with pytest.raises(FileNotFoundError):
        tiny_vae.load_taesd_checkpoint(tmp_path / "empty", device="cpu")


# ---------------------------------------------------------------------------
# entry points on a JAX-written bundle
# ---------------------------------------------------------------------------

@pytest.fixture()
def bundle(tmp_path):
    """(bundle path, tokenizer dir, the JAX weights, the images)."""
    m = _jax_model("tiny")
    params = jittered(m.params, 81)
    path = tmp_path / "tiny.msgpack"
    j_io.save_params(path, params)
    tok = write_tokenizer_dir(tmp_path / "tok")
    vocab = json.loads((tok / "vocab.json").read_text())
    assert max(vocab.values()) < 1000                      # within TINY_TEXT's vocab
    rng = np.random.default_rng(0)
    imgs = []
    for name in ("source.png", "target.png"):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(tmp_path / name)
        imgs.append(tmp_path / name)
    return path, tok, params, imgs


def _train_cfg(tmp_path, imgs, out, **kw):
    return TrainConfig(source_image_path=imgs[0], target_image_path=imgs[1],
                       output_path=tmp_path / out, model_family="tiny", image_size=32,
                       n_optimization_steps=2, derive_norm_hyperparams=False, eps=2.0,
                       step_size=1.0, grad_reps=2, image_visualization_interval=5,
                       prompts=["the cat", "a photo"], **kw)


def _handed_model(params, tok=None, seed=0):
    pm = build_model("tiny", image_size=32, device="cpu",
                     generator=torch.Generator().manual_seed(seed),
                     tokenizer_paths=[str(tok)] if tok else None)
    for part, kind, module in (("unet", "unet", pm.unet), ("vae", "vae", pm.vae)):
        module.load_state_dict(from_jax_params(params[part], kind))
    pm.text_models[0].load_state_dict(from_jax_params(params["text"][0], "clip"))
    return pm


def test_immunize_with_params_path_equals_the_handed_model(tmp_path, bundle):
    """``params_path`` and a tokenizer directory (one string, as the CLI
    passes it) give bit for bit the run of ``immunize`` handed the same
    weights and tokenizer."""
    path, tok, params, imgs = bundle
    got = api.immunize(_train_cfg(tmp_path, imgs, "a", params_path=path,
                                  tokenizer_paths=str(tok)), device="cpu")
    assert isinstance(got.model.tokenizers[0], HFCLIPTokenizer)
    want = api.immunize(_train_cfg(tmp_path, imgs, "b"), device="cpu",
                        model=_handed_model(params, tok))
    assert torch.equal(got.x_adv, want.x_adv)
    assert [h["avg_loss"] for h in got.history] == [h["avg_loss"] for h in want.history]


def test_evaluate_with_params_path(tmp_path, bundle):
    path, tok, params, imgs = bundle
    kw = dict(source_image_path=imgs[0], target_image_path=imgs[1], model_family="tiny",
              image_size=32, n_steps=4, n_noise=1, save_images=False)
    adv = Image.open(imgs[0]).convert("RGB").resize((32, 32))
    got = api.evaluate(InferenceConfig(output_path=tmp_path / "a", params_path=path,
                                       tokenizer_paths=[str(tok)], **kw), adv,
                       ["the cat"], device="cpu")
    want = api.evaluate(InferenceConfig(output_path=tmp_path / "b", **kw), adv, ["the cat"],
                        device="cpu", model=_handed_model(params, tok))
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


def test_cli_flags_reach_the_model(tmp_path, bundle, monkeypatch):
    path, tok, _, imgs = bundle
    seen = []
    real = api._cfg_model
    monkeypatch.setattr(api, "_cfg_model",
                        lambda cfg, *a: seen.append((cfg.params_path, cfg.tokenizer_paths))
                        or real(cfg, *a))
    assert cli.main(["immunize", "--device", "cpu", "--model-family", "tiny",
                     "--image-size", "32", "--n-optimization-steps", "1",
                     "--grad-reps", "1", "--params-path", str(path),
                     "--tokenizer-paths", str(tok), "--source-image-path", str(imgs[0]),
                     "--target-image-path", str(imgs[1]),
                     "--output-path", str(tmp_path / "out")]) == 0
    assert seen == [(path, str(tok))]
    assert (tmp_path / "out" / "adversarial_image.png").exists()


def test_universal_attack_takes_params_and_preview_params(tmp_path, bundle, monkeypatch):
    """``--params`` loads the bundle (no cast) and ``--preview-params`` a
    TAESD directory; the tiny preset stands in for "taesd" so that its 2x
    decode fits the tiny family's latents."""
    path, _, params, imgs = bundle
    monkeypatch.setitem(tiny_vae._PRESETS, "taesd", tiny_vae.TINY_TAESD)
    prev = tiny_vae.build_tiny_autoencoder("tiny", device="cpu",
                                           generator=torch.Generator().manual_seed(3))
    d = tmp_path / "taesd"
    d.mkdir()
    from tml_image_editing_defense_torch.models.convert import load_safetensors

    _write_safetensors(d / "model.safetensors", prev.state_dict())
    assert set(load_safetensors(d / "model.safetensors")) == set(prev.state_dict())
    data = tmp_path / "data"
    data.mkdir()
    for p in imgs:
        shutil.copy(p, data / p.name)
    run = universal_attack.main(["--device", "cpu", "--family", "tiny", "--image-size", "32",
                                 "--steps", "1", "--grad-reps", "1", "--dataset-dir", str(data),
                                 "--output", str(tmp_path / "u"), "--params", str(path),
                                 "--preview-params", str(d)])
    for k, v in from_jax_params(params["unet"], "unet").items():
        assert torch.equal(run.model.unet.state_dict()[k], v), k
    for k, v in prev.state_dict().items():
        assert torch.equal(run.preview.state_dict()[k], v), k
    assert np.isfinite(run.losses).all()


def _write_safetensors(path, state):
    safetensors_numpy.save_file({k: v.numpy() for k, v in state.items()}, str(path))


def test_prepare_real_weights_fuses_lora_and_smokes_on_cpu(tmp_path, capsys):
    """The port's preparation (directory, VAE swap, LoRA, bundle, smoke)
    writes what the JAX package's steps give: within 1e-6 of JAX
    ``fuse_lora(load_sd_checkpoint(...))``."""
    m = _jax_model("tiny")
    params = jittered(m.params, 91)
    d = write_diffusers_dir(tmp_path / "ckpt", params)
    vae_params = jittered(m.params, 92)["vae"]
    (tmp_path / "vae2").mkdir()
    safetensors_numpy.save_file({k: np.ascontiguousarray(v) for k, v in
                                 export_state_dict(vae_params, "vae").items()},
                                str(tmp_path / "vae2" / "model.safetensors"))
    rng = np.random.default_rng(9)
    lora = {}
    for name, shape in (("conv_in", (32, 4, 3, 3)),
                        ("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q",
                         (32, 32))):
        a = rng.normal(0, 0.02, (4, *shape[1:])).astype(np.float32)
        b = rng.normal(0, 0.02, (shape[0], 4) + ((1, 1) if len(shape) == 4 else ()))
        lora[f"unet.{name}.lora_A.weight"] = a
        lora[f"unet.{name}.lora_B.weight"] = b.astype(np.float32)
        lora[f"unet.{name}.alpha"] = np.asarray(8.0, np.float32)
    safetensors_numpy.save_file(lora, str(tmp_path / "lora.safetensors"))
    out = tmp_path / "w.msgpack"
    model = prepare_real_weights.main([
        "--device", "cpu", "--family", "tiny", "--image-size", "32", "--model-dir", str(d),
        "--vae-dir", str(tmp_path / "vae2"), "--lora", str(tmp_path / "lora.safetensors"),
        "--lora-scale", "0.7", "--out", str(out), "--smoke"])
    assert "smoke OK" in capsys.readouterr().out
    want = j_load_sd(d, jax.device_get(m.params))
    want["vae"] = vae_params
    want["unet"] = j_fuse_lora(want["unet"], lora, scale=0.7)
    got = j_io.load_params(out, jax.device_get(m.params))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                         rtol=0, atol=1e-6), got, want)
    assert not np.array_equal(np.asarray(got["unet"]["conv_in"]["kernel"]),
                              np.asarray(params["unet"]["conv_in"]["kernel"]))
    pm = checkpoint_io.load_params(out, _port_template("tiny"))
    assert torch.equal(pm.unet.conv_in.weight, model.unet.conv_in.weight)
