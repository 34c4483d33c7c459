"""The port's universal-perturbation attack against the JAX package's
``attack/universal.py``, on ``tiny`` and ``tiny-sdxl``, with the JAX weights
carried by ``from_jax_params`` and every draw replayed from the JAX key tree
(universal.py:130-139: ``split(key, 4)`` into encode, noise, t and prompt
keys, for each rep key of ``split(step_key, grad_reps)``; the loop's
``split(key)`` for each epoch's permutation, each step and each
validation, universal.py:354-371).

Tolerances: one step's perturbation and loss at rtol = atol = 1e-5 (the
step is 0.05 here, so the update is well above that); the whole loop at
the same tolerance; the remat policies against "none" at 1e-6 (the JAX
test ``test_universal_remat_matches_none`` holds the same); collages within
one uint8 level.  Also the schedule's tensor timesteps, the dataset, the
Adam update against ``optax.adam``, and the entry point on the CPU.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import jittered, nchw, nhwc, one_torch_thread  # noqa: F401
from test_torch_models import port_model_from_jax
from tml_image_editing_defense_tpu.attack import universal as ju
from tml_image_editing_defense_tpu.attack.forward import select_cond as j_select_cond
from tml_image_editing_defense_tpu.data import ImagePromptDataset as JDataset
from tml_image_editing_defense_tpu.models import build_model as jax_build_model
from tml_image_editing_defense_tpu.models.tiny_vae import build_tiny_autoencoder as j_tiny_vae

from tml_image_editing_defense_torch import universal_attack
from tml_image_editing_defense_torch.attack import universal as pu
from tml_image_editing_defense_torch.attack.forward import CondInputs, apply_remat, select_cond
from tml_image_editing_defense_torch.data import ImagePromptDataset
from tml_image_editing_defense_torch.models.convert import from_jax_params
from tml_image_editing_defense_torch.models.model_zoo import PromptBank
from tml_image_editing_defense_torch.models.tiny_vae import TINY_TAESD, AutoencoderTiny

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 32
LAT = (1, SIZE // 2, SIZE // 2, 4)           # one latent, NHWC
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPTS = ("a photo", "a sketch", "an oil painting")
#: a step large enough that the update is far above the tolerance
STEP = dict(eps=0.1, step_size=0.05, grad_reps=2, image_size=SIZE, edit_prompts=PROMPTS)


@pytest.fixture(scope="module")
def twins():
    """JAX tiny and tiny-sdxl bundles and a tiny preview autoencoder, with
    jittered weights, and the port's twins."""
    out = {}
    for i, family in enumerate(("tiny", "tiny-sdxl")):
        m = jax_build_model(family, key=jax.random.key(40 + i), image_size=SIZE, fast_init=True)
        jm = dataclasses.replace(m, params=jittered(m.params, 50 + i))
        out[family] = (jm, port_model_from_jax(jm, family=family))
    jp = j_tiny_vae("tiny", key=jax.random.key(60), fast_init=True)
    jp = dataclasses.replace(jp, params=jittered(jp.params, 61, scale=0.1))
    port_preview = AutoencoderTiny(TINY_TAESD)
    port_preview.load_state_dict(from_jax_params(jp.params, "vae"))
    out["preview"] = (jp, port_preview.requires_grad_(False).eval())
    return out


@pytest.fixture(scope="module")
def jbanks(twins):
    """The JAX prompt bank of PROMPTS for each family (embedded once)."""
    return {f: twins[f][0].embed_prompt_bank(list(PROMPTS)) for f in ("tiny", "tiny-sdxl")}


def _port_bank(jbank) -> PromptBank:
    """The JAX bank's arrays as the port's bank (the step's inputs held
    equal; the CLIP encoders are held in tests/test_torch_models.py)."""
    t = (lambda a: None if a is None else torch.tensor(np.asarray(a)))  # noqa: E731
    return PromptBank(t(jbank.embeds), t(jbank.uncond), t(jbank.pooled), t(jbank.uncond_pooled))


def _replay_rows(keys, n_prompts: int, timestep_range=(300, 800)) -> pu.UniversalDraws:
    """The draws of the JAX rep body for each rep key (universal.py:130-138)."""
    eps, noise, ts, ps = [], [], [], []
    for k in keys:
        k_enc, k_noise, k_t, k_p = jax.random.split(k, 4)
        eps.append(nchw(np.asarray(jax.random.normal(k_enc, LAT, jnp.float32))))
        noise.append(nchw(np.asarray(jax.random.normal(k_noise, LAT, jnp.float32))))
        ts.append(int(jax.random.randint(k_t, (), *timestep_range)))
        ps.append(int(jax.random.randint(k_p, (), 0, n_prompts)))
    return pu.UniversalDraws(torch.cat(eps), torch.cat(noise), torch.tensor(ts), torch.tensor(ps))


def replay_step_draws(key, reps: int, n_prompts: int) -> pu.UniversalDraws:
    return _replay_rows(jax.random.split(key, reps), n_prompts)


class JaxKeyReplay:
    """A draw sampler for ``train_universal_perturbation`` that replays the
    JAX loop's key tree: ``split(key)`` before each epoch's permutation,
    each step and each validation (universal.py:355, 360, 371)."""

    def __init__(self, key, reps: int, n_prompts: int):
        self.key, self.reps, self.n_prompts = key, reps, n_prompts

    def _next(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def permutation(self, n):
        return [int(i) for i in np.asarray(jax.random.permutation(self._next(), n))]

    def step(self):
        return replay_step_draws(self._next(), self.reps, self.n_prompts)

    def validation(self):
        return _replay_rows([self._next()], self.n_prompts)


def _images(n: int, seed: int):
    """NHWC images in [-1, 1], some pixels at the edges of the range."""
    rng = np.random.default_rng(seed)
    return [np.clip(rng.standard_normal((1, SIZE, SIZE, 3)) * 0.6, -1, 1).astype(np.float32)
            for _ in range(n)]


def _pert0(seed: int, eps: float = 0.1):
    return np.random.default_rng(seed).uniform(-eps, eps, (1, SIZE, SIZE, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the schedule, the conditioning, the LCM step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [417, [301, 799]])
def test_add_noise_takes_tensor_timesteps(twins, t):
    jm, pm = twins["tiny"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    n = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    want = np.asarray(jm.schedule.add_noise(jnp.asarray(x), jnp.asarray(n), jnp.asarray(t)))
    got = pm.schedule.add_noise(nchw(x), nchw(n), torch.tensor(t))
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-6)
    if isinstance(t, int):          # the host-int path gives the same numbers
        np.testing.assert_allclose(nhwc(pm.schedule.add_noise(nchw(x), nchw(n), t)), want,
                                   rtol=1e-6, atol=1e-6)


def test_select_cond_tensor_index_gathers_the_row(twins, jbanks):
    jm, pm = twins["tiny-sdxl"]
    jbank = jbanks["tiny-sdxl"]
    bank = _port_bank(jbank)
    want = j_select_cond(jbank.embeds, jbank.uncond, 2, jbank.pooled, jbank.uncond_pooled)
    for idx in (2, torch.tensor(2)):
        got = select_cond(bank.embeds, bank.uncond, idx, bank.pooled, bank.uncond_pooled)
        np.testing.assert_array_equal(got.ctx.numpy(), np.asarray(want.ctx))
        np.testing.assert_array_equal(got.text_embeds.numpy(), np.asarray(want.text_embeds))


@pytest.mark.parametrize("family", ["tiny", "tiny-sdxl"])
def test_lcm_denoise_single_step_matches_jax(twins, jbanks, family):
    jm, pm = twins[family]
    jbank = jbanks[family]
    time_ids = ju.make_time_ids(SIZE) if jbank.pooled is not None else None
    jcond = j_select_cond(jbank.embeds, jbank.uncond, 1, jbank.pooled, jbank.uncond_pooled,
                          time_ids)
    cond = CondInputs(*(None if a is None else torch.tensor(np.asarray(a))
                        for a in (jcond.ctx, jcond.text_embeds, jcond.time_ids)))
    noisy = np.random.default_rng(2).standard_normal(LAT).astype(np.float32)
    step = jax.jit(lambda z, t: ju.lcm_denoise_single_step(jm, jm.params, z, t, jcond, 1.5))
    for t in (300, 517, 799):
        want = np.asarray(step(jnp.asarray(noisy), jnp.asarray(t)))
        with torch.no_grad():
            got = pu.lcm_denoise_single_step(pm, nchw(noisy), torch.tensor(t), cond, 1.5)
        # x0 divides by sqrt(abar_t) (0.28 at t = 799) and the output reaches
        # |x| ~ 12: the UNet's f32 rounding is held relative to the largest value
        np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# one step, Adam, remat
# ---------------------------------------------------------------------------

#: (family, preview, l_inf_image_coeff); tiny with the preview and the L2
#: loss alone is the Adam test's and the loop's step
STEP_CASES = [("tiny", False, 1.0), ("tiny-sdxl", True, 0.0)]


@pytest.mark.parametrize("family,preview,linf", STEP_CASES)
def test_universal_step_matches_jax(twins, jbanks, family, preview, linf):
    jm, pm = twins[family]
    jp, pp = twins["preview"]
    cfg = dict(STEP, l_inf_image_coeff=linf)
    jbank = jbanks[family]
    jstep = jax.jit(ju.make_universal_step(jm, ju.UniversalConfig(**cfg), jbank,
                                           preview=jp if preview else None))
    params = dict(jm.params, preview_vae=jp.params) if preview else jm.params
    src, p0 = _images(1, 3)[0], _pert0(4)
    key = jax.random.key(5)
    want, want_loss = jstep(params, jnp.asarray(p0), jnp.asarray(src), key)
    step = pu.make_universal_step(pm, pu.UniversalConfig(**cfg), _port_bank(jbank),
                                  preview=pp if preview else None)
    got, loss = step(nchw(p0), nchw(src), replay_step_draws(key, 2, len(PROMPTS)))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    assert np.abs(nhwc(got) - p0).max() > 100 * TOL["atol"]          # the step moved pert


def test_universal_adam_steps_match_jax(twins, jbanks):
    jm, pm = twins["tiny"]
    jp, pp = twins["preview"]
    cfg = dict(STEP, optimizer="adam", lr=1e-2)
    jbank = jbanks["tiny"]
    jraw = ju.make_universal_step(jm, ju.UniversalConfig(**cfg), jbank, preview=jp)
    jstep = jax.jit(jraw)
    params = dict(jm.params, preview_vae=jp.params)
    step = pu.make_universal_step(pm, pu.UniversalConfig(**cfg), _port_bank(jbank), preview=pp)
    images = _images(3, 6)
    jpert = jnp.asarray(_pert0(7))
    pert = nchw(np.asarray(jpert))
    jstate, state = jraw.init(jpert), step.init(pert)
    for i, key in enumerate(jax.random.split(jax.random.key(8), 3)):
        jpert, jstate, jloss = jstep(params, jpert, jstate, jnp.asarray(images[i]), key)
        pert, state, loss = step(pert, state, nchw(images[i]), replay_step_draws(key, 2, 3))
        np.testing.assert_allclose(nhwc(pert), np.asarray(jpert), **TOL)
        np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
        mu = np.asarray(jstate[0].mu)           # the gradient's scale
        np.testing.assert_allclose(nhwc(state.mu), mu, rtol=1e-5, atol=1e-5 * np.abs(mu).max())
    assert state.count == 3


def test_adam_update_matches_optax():
    import optax

    rng = np.random.default_rng(9)
    tx = optax.adam(3e-2)
    p = rng.standard_normal((1, 3, 4, 4)).astype(np.float32)
    jstate, state = tx.init(jnp.asarray(p)), pu.adam_init(torch.from_numpy(p))
    for _ in range(4):
        g = rng.standard_normal(p.shape).astype(np.float32)
        want, jstate = tx.update(jnp.asarray(g), jstate, jnp.asarray(p))
        got, state = pu.adam_update(torch.from_numpy(g), state, 3e-2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


def test_unknown_optimizer_and_remat_policy_raise(twins):
    _, pm = twins["tiny"]
    bank = PromptBank(torch.zeros(1, 4, 8), torch.zeros(4, 8))
    with pytest.raises(ValueError, match="unknown optimizer"):
        pu.make_universal_step(pm, pu.UniversalConfig(optimizer="sgd"), bank)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        apply_remat(lambda x: x, "some")


@pytest.mark.parametrize("policy", ["full", "dots", "conv_dots"])
def test_remat_policy_matches_none(twins, jbanks, policy):
    """Checkpointing trades memory for recompute and nothing else: the same
    step as "none" within 1e-6, and the encoder's forward runs again in the
    backward (twice per rep, where "none" runs it once)."""
    jm, pm = twins["tiny"]
    _, pp = twins["preview"]
    bank = _port_bank(jbanks["tiny"])
    src, p0 = nchw(_images(1, 10)[0]), nchw(_pert0(11))
    draws = replay_step_draws(jax.random.key(12), 2, len(PROMPTS))
    calls = []
    hook = pm.vae.encoder.register_forward_hook(lambda *a: calls.append(1))
    try:
        out = {}
        for pol in ("none", policy):
            calls.clear()
            step = pu.make_universal_step(pm, pu.UniversalConfig(**STEP, remat_policy=pol),
                                          bank, preview=pp)
            out[pol] = step(p0, src, draws)
            out[pol + "_encodes"] = len(calls)
    finally:
        hook.remove()
    np.testing.assert_allclose(out[policy][0].numpy(), out["none"][0].numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(out[policy][1].item(), out["none"][1].item(), rtol=1e-6)
    assert (out["none_encodes"], out[policy + "_encodes"]) == (2, 4)


# ---------------------------------------------------------------------------
# validation, collage, the loop
# ---------------------------------------------------------------------------


def test_universal_validation_matches_jax(twins, jbanks):
    jm, pm = twins["tiny-sdxl"]
    cfg = ju.UniversalConfig(**STEP)
    jbank = jbanks["tiny-sdxl"]
    src, p0, key = _images(1, 13)[0], _pert0(14), jax.random.key(15)
    want = jax.jit(ju.make_universal_validation(jm, cfg, jbank))(
        jm.params, jnp.asarray(p0), jnp.asarray(src), key)
    got = pu.make_universal_validation(pm, pu.UniversalConfig(**STEP), _port_bank(jbank))(
        nchw(p0), nchw(src), _replay_rows([key], len(PROMPTS)))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    collage = pu._universal_collage(nchw(src), nchw(p0), got, 7)
    jcollage = ju._universal_collage(src, p0, np.asarray(want), 7)
    assert collage.shape == jcollage.shape and collage.shape[1] == 3 * SIZE
    assert np.abs(collage.astype(int) - jcollage.astype(int)).max() <= 1


def test_train_universal_perturbation_matches_jax(twins):
    """3 images x 2 epochs cut at 5 steps, the preview on the loss path and
    a validation collage every 2 steps: the loss of every step, the final
    perturbation and the collages as the JAX loop's."""
    jm, pm = twins["tiny"]
    jp, pp = twins["preview"]
    cfg = dict(STEP, epochs=2, max_steps=5)
    images = _images(3, 16)
    key = jax.random.key(17)
    jcollages, collages = {}, {}
    jpert, jlosses = ju.train_universal_perturbation(
        jm, images, ju.UniversalConfig(**cfg), key, preview=jp, vis_every=2,
        vis_fn=jcollages.__setitem__)
    logged = []
    pert, losses = pu.train_universal_perturbation(
        pm, [nchw(im) for im in images], pu.UniversalConfig(**cfg), preview=pp, vis_every=2,
        vis_fn=collages.__setitem__, log_fn=lambda i, v: logged.append(i),
        draw_sampler=JaxKeyReplay(key, 2, len(PROMPTS)))
    assert len(losses) == len(jlosses) == 5 and logged == [0, 1, 2, 3, 4]
    np.testing.assert_allclose(losses, jlosses, **TOL)
    np.testing.assert_allclose(nhwc(pert), np.asarray(jpert), **TOL)
    assert sorted(collages) == sorted(jcollages) == [0, 2, 4]
    for k in collages:
        assert np.abs(collages[k].astype(int) - jcollages[k].astype(int)).max() <= 1


def test_train_universal_perturbation_own_draws_hold_the_box(twins):
    """With its own generator: seeded, one loss per step, the eps box held.
    The re-anchor keeps the image of the last step in [-1, 1]; another image
    may leave it by up to eps (the entry point clips where it applies it)."""
    _, pm = twins["tiny"]
    images = [nchw(im) for im in _images(2, 18)]
    cfg = pu.UniversalConfig(**dict(STEP, epochs=2, max_steps=3))
    runs = [pu.train_universal_perturbation(pm, images, cfg, seed=4) for _ in range(2)]
    (pert, losses), (pert2, losses2) = runs
    assert torch.equal(pert, pert2) and losses == losses2 and len(losses) == 3
    assert np.isfinite(losses).all() and pert.abs().max().item() <= cfg.eps + 1e-7
    over = [(im + pert).abs().max().item() - 1.0 for im in images]
    assert min(over) <= 1e-6 and max(over) <= cfg.eps


# ---------------------------------------------------------------------------
# the dataset and the entry point
# ---------------------------------------------------------------------------


def _image_folder(root, sizes=((40, 56), (48, 40), (36, 36), (50, 44))):
    rng = np.random.default_rng(19)
    names = ["b.png", "nested/a.jpg", "nested/deeper/c.JPEG", "d.jpeg"]
    for name, (h, w) in zip(names, sizes):
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            path, format="PNG" if name.endswith("png") else "JPEG")
    (root / "notes.txt").write_text("not an image")
    return root


def test_dataset_matches_jax(tmp_path):
    root = _image_folder(tmp_path / "ds")
    ds, jds = ImagePromptDataset(str(root), "a photo", size=SIZE), JDataset(str(root), "a photo",
                                                                           size=SIZE)
    assert len(ds) == len(jds) == 4 and ds.paths == jds.paths
    for i in range(len(ds)):
        (img, prompt), (jimg, jprompt) = ds[i], jds[i]
        assert img.shape == (3, SIZE, SIZE) and img.dtype == np.float32 and prompt == jprompt
        np.testing.assert_array_equal(img, jimg)
    for drop in (False, True):
        got, want = list(ds.batches(3, drop)), list(jds.batches(3, drop))
        assert [b[0].shape for b in got] == [b[0].shape for b in want]
        assert [b[1] for b in got] == [b[1] for b in want]
        for (imgs, _), (jimgs, _) in zip(got, want):
            np.testing.assert_array_equal(imgs, jimgs)
    assert len(list(ImagePromptDataset(str(root), size=SIZE, recursive=False).paths)) == 2


def test_universal_attack_entry_point_on_cpu(tmp_path):
    root = _image_folder(tmp_path / "ds")
    out = tmp_path / "out"
    run = universal_attack.main(["--dataset-dir", str(root), "--output", str(out), "--device",
                                 "cpu", "--family", "tiny", "--image-size", "32", "--steps",
                                 "2", "--vis-every", "1"])
    pert = np.load(out / "perturbation.npy")
    assert pert.shape == (1, 32, 32, 3) and pert.dtype == np.float32          # NHWC
    np.testing.assert_array_equal(pert, nhwc(run.pert))
    assert np.abs(pert).max() <= 0.1 + 1e-6 and len(run.losses) == 2
    assert isinstance(run.preview, AutoencoderTiny) and run.cfg.remat_policy == "none"
    with Image.open(out / "perturbed_example.png") as im:
        assert im.size == (32, 32)
    for step in (0, 1):
        with Image.open(out / f"validation_{step:05d}.png") as im:
            assert im.size[0] == 3 * 32 and im.size[1] > 32


@pytest.mark.parametrize("flags", [["--eot-shards", "2"]])
def test_universal_attack_refuses_later_slices(tmp_path, flags):
    """``--eot-shards 2`` makes a ``reps`` mesh of 2 ranks, which a world of
    one rank (no process group) cannot hold: ``ValueError``, as the JAX
    ``make_mesh`` raises (the sharded step: tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match="incompatible with 1 ranks"):
        universal_attack.main(["--dataset-dir", str(tmp_path), "--device", "cpu", *flags])
