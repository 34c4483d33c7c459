"""The port's multi-rank tier (``parallel/mesh.py``, ``parallel/eot.py``,
``parallel/dp_eot.py`` and the entry points over ranks) on the CPU, with
ranks spawned by the port's own launcher (``launch_host.spawn_local``) on
gloo.

Two spawns serve every case, so that each world starts once: a world of 2
ranks (the mesh layout, the sharded step against the JAX package's
``make_sharded_eot_pgd_step`` on a ``reps`` mesh of 2 of the 8 virtual
devices and against the port's serial step, the sharded universal step and
its entry point, ``immunize`` with ``eot_shards=2``, ``immunize_batch`` with
padding, ``evaluate(eval_shards=2)`` and a stop flag set on one rank), and a
world of 4 (the 2-D layout and ``make_dp_eot_pgd_step`` on data 2 x reps 2
against the JAX ``make_dp_eot_pgd_step`` on the same mesh, L2, L-inf and
masked).  The ranks run this module's ``_world*`` functions, which import
no JAX: a spawned child imports the module of the function it runs.  The
JAX side (weights, replayed draws, the JAX steps) runs in the test process.

Tolerances: against JAX ``TOL`` of ``tests/test_torch_pgd.py`` (2e-4; L-inf
by the sign rule); against the port's serial functions 1e-6 for one step
(only the order of the rep sums differs), 1e-5 for whole runs, PNGs and
grids within one uint8 level.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from tml_image_editing_defense_torch import api, universal_attack
from tml_image_editing_defense_torch.attack.pgd import (
    batch_attack_data,
    make_attack_data,
    make_pgd_step,
)
from tml_image_editing_defense_torch.attack.universal import (
    UniversalConfig,
    make_universal_step,
    sample_universal_draws,
    train_universal_perturbation,
)
from tml_image_editing_defense_torch.configs import InferenceConfig, TrainConfig
from tml_image_editing_defense_torch.core.samplers import make_sampler
from tml_image_editing_defense_torch.launch_host import spawn_local
from tml_image_editing_defense_torch.models.model_zoo import PromptBank, build_model
from tml_image_editing_defense_torch.parallel import mesh as pmesh
from tml_image_editing_defense_torch.parallel.dp_eot import make_dp_eot_pgd_step, shard_batch
from tml_image_editing_defense_torch.parallel.eot import (
    make_sharded_eot_grad,
    make_sharded_eot_pgd_step,
    make_sharded_universal_step,
)
from tml_image_editing_defense_torch.parallel.mesh import DATA_AXIS, REPS_AXIS, make_mesh

SIZE = 32
#: the JAX step's tolerance (tests/test_torch_pgd.py)
TOL = dict(rtol=2e-4, atol=2e-4)
PROMPTS = ["a", "b", "c"]
#: the api cases: the tiny family at 32x32 with random weights from the seed
API_CFG = dict(model_family="tiny", image_size=SIZE, n_optimization_steps=2,
               derive_norm_hyperparams=False, eps=12.0, step_size=1.5, grad_reps=4,
               n_denoising_steps_per_iteration=2, limit_timesteps=False, prompts=["a", "b"])
EVAL_PROMPTS = ["a photo", "a sketch", "an oil painting"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(weights):
    """The tiny bundle carrying ``weights`` (state dicts of the JAX twin)."""
    pm = build_model("tiny", image_size=SIZE, device="cpu")
    pm.unet.load_state_dict(weights["unet"])
    pm.vae.load_state_dict(weights["vae"])
    for text_model, state in zip(pm.text_models, weights["text"]):
        text_model.load_state_dict(state)
    return pm


def _attack_data(pm, cfg, image):
    """The port's AttackData of one image spec (NCHW tensors)."""
    return make_attack_data(pm, cfg, image["source"], image["target"],
                            PromptBank(embeds=image["embeds"], uncond=image["uncond"]),
                            image["pool"], mask=image.get("mask"))


def _plan(pm, cfg):
    sampler = make_sampler("lcm", pm.schedule)
    return sampler, sampler.plan(cfg.n_denoising_steps_per_iteration,
                                 limit_t=700 if cfg.limit_timesteps else None)


def _group_ranks(mesh):
    import torch.distributed as dist

    return {a: dist.get_process_group_ranks(g) for a, g in mesh.groups.items()}


# ---------------------------------------------------------------------------
# rank bodies (no JAX here)
# ---------------------------------------------------------------------------


class _StopOn:
    """A preemption flag that turns true on ``rank`` from its poll ``at``."""

    def __init__(self, rank, at):
        self.rank, self.at, self.polls = rank, at, 0

    def __bool__(self):
        self.polls += 1
        return pmesh.world()[0] == self.rank and self.polls >= self.at


def _world2(spec_file, root):
    spec = torch.load(spec_file, weights_only=False)
    root = Path(root)
    rank, size = pmesh.world()
    out = {"rank": rank, "size": size}

    # the layout: one reps axis over both ranks, -1, a size that does not divide
    reps = make_mesh({REPS_AXIS: 2})
    out["reps_mesh"] = (reps.shape, reps.index, _group_ranks(reps), reps.ranks)
    out["inferred"] = make_mesh({DATA_AXIS: 1, REPS_AXIS: -1}).shape
    with pytest.raises(ValueError, match="incompatible with 2 ranks"):
        make_mesh({DATA_AXIS: 3})
    total = torch.tensor([float(rank + 1)])
    pmesh.all_reduce_([total], reps.group(REPS_AXIS))
    out["sum_over_reps"] = total.item()

    # the sharded step on the JAX draws, and against the serial step
    pm = _port_model(spec["weights"])
    step = spec["step"]
    for tag, cfg in (("plain", step["cfg"]),
                     ("remat_vae", dataclasses.replace(step["cfg"], remat_vae=True))):
        sampler, plan = _plan(pm, cfg)
        data = _attack_data(pm, cfg, step["image"])
        x_sh, aux_sh = make_sharded_eot_pgd_step(pm, sampler, plan, cfg, reps, decode_vis=False)(
            step["x0"], data, step["draws"])
        x_se, aux_se = make_pgd_step(pm, sampler, plan, cfg, decode_vis=False)(
            step["x0"], data, step["draws"])
        out[f"step_{tag}"] = {
            "x_sharded": x_sh.numpy(), "x_serial": x_se.numpy(),
            **{f"{k}_sharded": aux_sh[k].item() for k in ("avg_loss", "rec_loss", "pert_loss")},
            **{f"{k}_serial": aux_se[k].item() for k in ("avg_loss", "rec_loss", "pert_loss")},
            "latent_sharded": aux_sh["output_latent"].numpy(),
            "latent_serial": aux_se["output_latent"].numpy()}

    # the universal step: sharded against serial on the same draws, one step
    # and the loop; then the entry point with --eot-shards 2
    um = build_model("tiny", image_size=SIZE, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    ucfg = UniversalConfig(grad_reps=4, image_size=SIZE, eps=0.1, step_size=0.05,
                           edit_prompts=("a photo", "a sketch"))
    bank = um.embed_prompt_bank(list(ucfg.edit_prompts))
    src = spec["universal_source"]
    draws = sample_universal_draws(torch.Generator().manual_seed(4), 4, 2, um.latent_shape[1:])
    zero = torch.zeros_like(src)
    p_sh, l_sh = make_sharded_universal_step(um, ucfg, bank, reps)(zero, src, draws)
    p_se, l_se = make_universal_step(um, ucfg, bank)(zero, src, draws)
    loop = dataclasses.replace(ucfg, max_steps=2)
    pm_loop, lm_loop = train_universal_perturbation(um, [src], loop, seed=7, mesh=reps)
    ps_loop, ls_loop = train_universal_perturbation(um, [src], loop, seed=7)
    run = universal_attack.main(
        ["--dataset-dir", str(spec["dataset"]), "--output", str(root / "universal_dp"),
         "--device", "cpu", "--family", "tiny", "--image-size", str(SIZE), "--steps", "2",
         "--eot-shards", "2", "--vis-every", "1"])
    out["universal"] = {"step": (p_sh.numpy(), p_se.numpy(), l_sh.item(), l_se.item()),
                        "loop": (pm_loop.numpy(), ps_loop.numpy(), lm_loop, ls_loop),
                        "main": (run.pert.numpy(), run.losses)}

    # immunize with eot_shards=2 through the entry point
    paths = spec["images"]
    cfg = TrainConfig(**API_CFG, source_image_path=paths[0], target_image_path=paths[1],
                      output_path=root / "immunize_dp", eot_shards=2, checkpoint_interval=1,
                      image_visualization_interval=1)
    res = api.immunize(cfg, device="cpu")
    out["immunize"] = {"x_adv": res.x_adv.numpy(), "history": res.history}

    # a stop flag set on rank 1 before the second iteration stops both there
    real_guard = api.preemption_guard
    api.preemption_guard = contextlib.contextmanager(lambda: iter([_StopOn(1, 2)]))
    try:
        res = api.immunize(dataclasses.replace(cfg, output_path=root / "stopped",
                                               n_optimization_steps=3), device="cpu")
    finally:
        api.preemption_guard = real_guard
    out["stopped"] = {"history": res.history, "x_adv": res.x_adv.numpy()}

    # immunize_batch over data 2: three images, the list padded to four
    bcfg = TrainConfig(**{**API_CFG, "grad_reps": 2}, n_noise=2, enable_visualization=False,
                       output_path=root / "batch_dp")
    results = api.immunize_batch(bcfg, paths, device="cpu", seeds=[11, 12, 13])
    out["batch"] = {"x_adv": [r.x_adv.numpy() for r in results],
                    "history": [r.history for r in results]}

    # evaluate with its cells over both ranks
    ecfg = InferenceConfig(source_image_path=paths[0], target_image_path=paths[1],
                           model_family="tiny", image_size=SIZE, n_steps=10, seed=5,
                           output_path=root / "eval_dp", eval_shards=2,
                           validation_images_path=None)
    grids = api.evaluate(ecfg, Image.open(spec["adversarial"]).convert("RGB"), EVAL_PROMPTS,
                         device="cpu")
    out["evaluate"] = [np.asarray(g) for g in grids]
    return out


def _world4(spec_file):
    spec = torch.load(spec_file, weights_only=False)
    rank, size = pmesh.world()
    out = {"rank": rank}
    mesh = make_mesh({DATA_AXIS: 2, REPS_AXIS: 2})
    out["mesh"] = (mesh.shape, mesh.index, _group_ranks(mesh))
    sub = make_mesh({REPS_AXIS: 2})                 # two copies of a mesh of two
    out["sub"] = (sub.index, sub.ranks, _group_ranks(sub))
    pm = _port_model(spec["weights"])
    for case in spec["dp"]:
        cfg = case["cfg"]
        sampler, plan = _plan(pm, cfg)
        batched = batch_attack_data([_attack_data(pm, cfg, im) for im in case["images"]])
        local = shard_batch(mesh, batched)
        mine = list(mesh.block(DATA_AXIS, len(case["images"])))
        x0 = torch.cat([case["x0"][i] for i in mine])
        draws = [case["draws"][i] for i in mine]
        grad, _ = make_sharded_eot_grad(pm, sampler, plan, cfg, mesh)(x0, local, draws)
        x1, aux = make_dp_eot_pgd_step(pm, sampler, plan, cfg, mesh)(x0, local, draws)
        out[case["name"]] = {"images": mine, "x": x1.numpy(), "grad": grad.numpy(),
                             "avg_loss": aux["avg_loss"].numpy()}
    return out


# ---------------------------------------------------------------------------
# the test process: JAX inputs, the spawns, the references
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    """A JAX tiny model (fast init), its port weights, and the helpers of
    tests/test_torch_pgd.py (imported here: the ranks must not import JAX)."""
    import jax
    import test_torch_pgd as tp
    from test_torch_models import port_model_from_jax

    jmodel = tp.jax_build_model("tiny", key=jax.random.key(0), image_size=SIZE, fast_init=True)
    pm = port_model_from_jax(jmodel)
    weights = {"unet": pm.unet.state_dict(), "vae": pm.vae.state_dict(),
               "text": [t.state_dict() for t in pm.text_models]}
    return tp, jmodel, pm, weights


def _jcfg(tp, **kw):
    from tml_image_editing_defense_tpu.configs import TrainConfig as JTrainConfig

    # one denoising step and the loss on the latents (no decode): short JAX
    # compiles; the chain itself is held elsewhere (tests/test_torch_pgd.py)
    base = dict(norm_type="l2", derive_norm_hyperparams=False, eps=12.0, step_size=1.5,
                grad_reps=4, guidance_scale=tp.GS, image_size=SIZE,
                n_denoising_steps_per_iteration=1, limit_timesteps=False,
                apply_loss_on_images=False, apply_loss_on_latents=True,
                perturbation_loss_lambda=0.0, rec_loss_lambda=1.0, prompts=PROMPTS)
    base.update(kw)
    return JTrainConfig(**base)


def _image(tp, seed, mask=None):
    """One image's inputs from seeded JAX draws: NHWC numpy for JAX, NCHW
    tensors for the port."""
    embeds, uncond = tp._rand(20, (3, 7, 32)), tp._rand(21, (7, 32))
    pool = tp._rand(seed, (4, 1, 16, 16, 4))
    source = np.clip(tp._rand(seed + 1, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    target = np.clip(tp._rand(seed + 2, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    x0 = np.clip(source + tp._rand(seed + 3, source.shape, 0.01), -1, 1)
    jax_in = dict(source=source, target=target, pool=pool, embeds=embeds, uncond=uncond,
                  x0=x0, mask=None if mask is None else mask[None, :, :, None])
    port = dict(source=tp.nchw(source), target=tp.nchw(target),
                pool=torch.from_numpy(np.ascontiguousarray(pool.transpose(0, 1, 4, 2, 3))),
                embeds=torch.tensor(embeds), uncond=torch.tensor(uncond))
    if mask is not None:
        port["mask"] = torch.from_numpy(mask)[None, None]
    return jax_in, port, tp.nchw(x0)


def _jdata(jmodel, jcfg, jin):
    import jax.numpy as jnp

    from tml_image_editing_defense_tpu.attack.pgd import make_attack_data as j_make_attack_data
    from tml_image_editing_defense_tpu.models.model_zoo import PromptBank as JBank

    bank = JBank(embeds=jnp.asarray(jin["embeds"]), uncond=jnp.asarray(jin["uncond"]))
    mask = None if jin["mask"] is None else jnp.asarray(jin["mask"])
    return j_make_attack_data(jmodel, jcfg, jnp.asarray(jin["source"]), jnp.asarray(jin["target"]),
                              bank, jnp.asarray(jin["pool"]), mask=mask)


def _draws(tp, key, cfg, pm):
    _, plan = _plan(pm, cfg)
    return tp.replay_draws(key, cfg.grad_reps, len(PROMPTS), 4, plan.num_steps,
                           (1, SIZE // 2, SIZE // 2, 4))


def _spawn_behind(fn, world_size, args, root):
    """Start ``spawn_local`` on a thread, so that the ranks run while this
    process compiles the JAX side; the returned call waits for their
    results."""
    box = {}

    def run():
        try:
            box["ranks"] = spawn_local(fn, world_size, args, backend="gloo", device="cpu",
                                       workdir=root, timeout=300)
        except BaseException as e:           # re-raised in the test process below
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["ranks"]

    return join


def _write_images(root: Path):
    rng = np.random.default_rng(21)
    paths = []
    for i in range(3):
        path = root / "images" / f"im{i}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(path)
        paths.append(path)
    adv = np.asarray(Image.open(paths[0]).convert("RGB").resize((SIZE, SIZE)), np.int16)
    adv = np.clip(adv + rng.integers(-6, 7, adv.shape), 0, 255).astype(np.uint8)
    Image.fromarray(adv).save(root / "adversarial.png")
    return paths


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_side):
    """The world of 2: its inputs (the JAX tiny weights and a replayed
    step), every rank's results, and the JAX sharded step's."""
    import jax

    from tml_image_editing_defense_tpu.core.samplers import make_sampler as j_make_sampler
    from tml_image_editing_defense_tpu.parallel.eot import make_sharded_eot_pgd_step as j_sharded
    from tml_image_editing_defense_tpu.parallel.mesh import REPS_AXIS as J_REPS
    from tml_image_editing_defense_tpu.parallel.mesh import make_mesh as j_make_mesh

    root = tmp_path_factory.mktemp("world2")
    tp, jmodel, pm, weights = jax_side
    jcfg = _jcfg(tp)
    cfg = tp._port_cfg(jcfg)
    jin, port_in, x0 = _image(tp, 22)
    key = jax.random.key(77)
    paths = _write_images(root)
    spec = {"weights": weights, "images": paths, "adversarial": root / "adversarial.png",
            "dataset": paths[0].parent,
            "universal_source": torch.from_numpy(
                np.clip(np.random.default_rng(31).normal(0, 0.3, (1, 3, SIZE, SIZE)), -1, 1)
                .astype(np.float32)),
            "step": {"cfg": cfg, "image": port_in, "x0": x0, "draws": _draws(tp, key, cfg, pm)}}
    spec_file = root / "spec.pt"
    torch.save(spec, spec_file)
    ranks = _spawn_behind(_world2, 2, (spec_file, root), root)

    jsampler = j_make_sampler("lcm", jmodel.schedule)
    jplan = jsampler.plan(jcfg.n_denoising_steps_per_iteration)
    jmesh = j_make_mesh({J_REPS: 2})
    step = jax.jit(j_sharded(jmodel, jsampler, jplan, jcfg, jmesh, decode_vis=False))
    with jax.sharding.set_mesh(jmesh):
        jx, jaux = step(jmodel.params, jin["x0"], _jdata(jmodel, jcfg, jin), key)
    return {"ranks": ranks(), "root": root, "paths": paths, "tp": tp,
            "jax": (np.asarray(jx), {k: float(v) for k, v in jaux.items()
                                     if k in ("avg_loss", "rec_loss", "pert_loss")},
                    np.asarray(jaux["output_latent"]))}


#: L2 with a mask (image 0 under a disk, image 1 under an all-ones mask,
#: which is the unmasked step's arithmetic), and L-inf
DP_CASES = ("l2-masked", "linf")


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_side):
    """The world of 4 (data 2 x reps 2): every rank's 2-D steps, and the
    JAX ``make_dp_eot_pgd_step``'s on the same mesh and draws."""
    import jax
    import jax.numpy as jnp

    from tml_image_editing_defense_tpu.core.samplers import make_sampler as j_make_sampler
    from tml_image_editing_defense_tpu.parallel.dp_eot import make_dp_eot_pgd_step as j_dp
    from tml_image_editing_defense_tpu.parallel.mesh import DATA_AXIS as J_DATA
    from tml_image_editing_defense_tpu.parallel.mesh import REPS_AXIS as J_REPS
    from tml_image_editing_defense_tpu.parallel.mesh import make_mesh as j_make_mesh
    from tml_image_editing_defense_tpu.parallel.sweep import batch_attack_data as j_batch

    root = tmp_path_factory.mktemp("world4")
    tp, jmodel, pm, weights = jax_side
    yy, xx = np.mgrid[:SIZE, :SIZE]
    disk = (((yy - 14) ** 2 + (xx - 18) ** 2) < 100).astype(np.float32)
    keys = jax.random.split(jax.random.key(11), 2)
    cases, jcases = [], {}
    for name in DP_CASES:
        norm = dict(norm_type="linf", eps=0.1, step_size=0.006) if name == "linf" else {}
        masked = dict(use_segmentation_mask=True) if name == "l2-masked" else {}
        jcfg = _jcfg(tp, **norm, **masked)
        cfg = tp._port_cfg(jcfg)
        ims = [_image(tp, 40 + 10 * i, (disk, np.ones_like(disk))[i] if masked else None)
               for i in range(2)]
        cases.append({"name": name, "cfg": cfg, "images": [p for _, p, _ in ims],
                      "x0": [x for _, _, x in ims],
                      "draws": [_draws(tp, k, cfg, pm) for k in keys]})
        jcases[name] = (jcfg, [j for j, _, _ in ims])
    spec_file = root / "spec.pt"
    torch.save({"weights": weights, "dp": cases}, spec_file)
    ranks = _spawn_behind(_world4, 4, (spec_file,), root)

    jsampler = j_make_sampler("lcm", jmodel.schedule)
    jplan = jsampler.plan(1)
    jmesh = j_make_mesh({J_DATA: 2, J_REPS: 2})
    want = {}
    for name, (jcfg, jins) in jcases.items():
        batched = j_batch([_jdata(jmodel, jcfg, j) for j in jins])
        step = j_dp(jmodel, jsampler, jplan, jcfg, batched, jmesh)
        x0s = jnp.stack([jnp.asarray(j["x0"]) for j in jins])
        with jax.sharding.set_mesh(jmesh):
            x, aux = jax.device_get(jax.jit(step)(jmodel.params, x0s, batched, keys))
        want[name] = (np.asarray(x), np.asarray(aux["avg_loss"]))
    return {"ranks": ranks(), "jax": want, "tp": tp}


def test_mesh_layout_and_errors():
    """Without a process group the world is one rank (JAX
    tests/test_parallel.py:50 on 8 devices; here the sizes that fit one)."""
    assert pmesh.world() == (0, 1) and pmesh.local_world_size() == 1 and pmesh.is_writer()
    mesh = make_mesh({DATA_AXIS: -1, REPS_AXIS: 1})
    assert mesh.shape == {DATA_AXIS: 1, REPS_AXIS: 1} and mesh.groups == {DATA_AXIS: None,
                                                                            REPS_AXIS: None}
    assert make_mesh().shape == {DATA_AXIS: 1}
    for axes in ({REPS_AXIS: 2}, {DATA_AXIS: 3}, {DATA_AXIS: -1, REPS_AXIS: -1}):
        with pytest.raises(ValueError):
            make_mesh(axes)
    half = pmesh.Mesh({DATA_AXIS: 2}, {DATA_AXIS: 1}, {DATA_AXIS: None})
    assert half.block(DATA_AXIS, 4) == range(2, 4)
    with pytest.raises(ValueError, match="do not split"):
        half.block(DATA_AXIS, 3)
    t = torch.arange(8.0).view(4, 2)
    assert torch.equal(pmesh.shard_along(half, t, DATA_AXIS), t[2:])
    assert pmesh.replicate(half, t) is t


def test_mesh_over_two_and_four_ranks(world2, world4):
    """Row-major rank layout (the last axis's ranks consecutive), one group
    per axis line, -1 inferred, a non-divisor refused; a mesh smaller than
    the world tiles it in copies."""
    for r in world2["ranks"]:
        shape, index, groups, ranks = r["reps_mesh"]
        assert shape == {REPS_AXIS: 2} and index == {REPS_AXIS: r["rank"]}
        assert groups == {REPS_AXIS: [0, 1]} and ranks == (0, 1)
        assert r["inferred"] == {DATA_AXIS: 1, REPS_AXIS: 2}
        assert r["sum_over_reps"] == 3.0
    for r in world4["ranks"]:
        d, j = divmod(r["rank"], 2)
        shape, index, groups = r["mesh"]
        assert shape == {DATA_AXIS: 2, REPS_AXIS: 2} and index == {DATA_AXIS: d, REPS_AXIS: j}
        assert groups == {DATA_AXIS: [j, 2 + j], REPS_AXIS: [2 * d, 2 * d + 1]}
        assert r["sub"] == ({REPS_AXIS: j}, (2 * d, 2 * d + 1), {REPS_AXIS: [2 * d, 2 * d + 1]})


def test_sharded_step_matches_jax_sharded_step(world2):
    """Reps 2: the port's sharded step on the JAX key tree's draws against
    the JAX ``make_sharded_eot_pgd_step`` on 2 virtual devices, on both
    ranks, the ranks' iterates bit-equal."""
    jx, jloss, jlatent = world2["jax"]
    tp = world2["tp"]
    r0, r1 = (r["step_plain"] for r in world2["ranks"])
    np.testing.assert_array_equal(r0["x_sharded"], r1["x_sharded"])
    for r in (r0, r1):
        np.testing.assert_allclose(tp.nhwc(torch.from_numpy(r["x_sharded"])), jx, **TOL)
        for k, v in jloss.items():
            np.testing.assert_allclose(r[f"{k}_sharded"], v, rtol=2e-4, err_msg=k)
        # the last rep's output latent reaches |200| (one LCM step at t = 999
        # divides by sqrt(alpha_bar)): TOL relative to its largest magnitude
        np.testing.assert_allclose(tp.nhwc(torch.from_numpy(r["latent_sharded"])), jlatent,
                                   rtol=TOL["rtol"], atol=TOL["atol"] * np.abs(jlatent).max())


@pytest.mark.parametrize("tag", ["plain", "remat_vae"])
def test_sharded_step_matches_serial_step(world2, tag):
    """The sharded step against the port's serial step on the same draws:
    only the order of the rep sums differs (JAX tests/test_parallel.py:60,
    :78 for ``remat_vae``); the last rep's losses and output are the
    serial step's on both ranks."""
    for r in world2["ranks"]:
        s = r[f"step_{tag}"]
        np.testing.assert_allclose(s["x_sharded"], s["x_serial"], rtol=0, atol=1e-6)
        for k in ("avg_loss", "rec_loss", "pert_loss"):
            np.testing.assert_allclose(s[f"{k}_sharded"], s[f"{k}_serial"], rtol=1e-6)
        np.testing.assert_allclose(s["latent_sharded"], s["latent_serial"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", DP_CASES)
def test_dp_step_matches_jax_dp_step(world4, case):
    """Data 2 x reps 2, B = 2: each data rank's image against the JAX
    ``make_dp_eot_pgd_step`` on the same mesh; the two ranks of a reps group
    hold one iterate, bit for bit."""
    tp = world4["tp"]
    jx, jloss = world4["jax"][case]
    by_rank = {r["rank"]: r[case] for r in world4["ranks"]}
    for rank, got in by_rank.items():
        (i,) = got["images"]
        assert i == rank // 2
        np.testing.assert_array_equal(got["x"], by_rank[rank ^ 1]["x"])
        np.testing.assert_allclose(got["avg_loss"], jloss[i:i + 1], rtol=2e-4)
        x = tp.nhwc(torch.from_numpy(got["x"]))
        if case == "linf":
            tp.assert_sign_steps_close(x, jx[i], tp.nhwc(torch.from_numpy(got["grad"])))
        else:
            np.testing.assert_allclose(x, jx[i], **TOL)


def test_sharded_universal_step_matches_serial(world2):
    """One universal step with its 4 reps over 2 ranks against the serial
    step on the same draws, the loop with ``mesh=`` against the loop
    without (JAX tests/test_parallel.py:155), and ``universal_attack.main``
    with ``--eot-shards 2`` against the same command on one rank."""
    for r in world2["ranks"]:
        p_sh, p_se, l_sh, l_se = r["universal"]["step"]
        np.testing.assert_allclose(p_sh, p_se, rtol=0, atol=1e-6)
        np.testing.assert_allclose(l_sh, l_se, rtol=1e-6)
        pm_loop, ps_loop, lm, ls = r["universal"]["loop"]
        np.testing.assert_allclose(pm_loop, ps_loop, rtol=0, atol=1e-6)
        np.testing.assert_allclose(lm, ls, rtol=1e-6)
    np.testing.assert_array_equal(*(r["universal"]["main"][0] for r in world2["ranks"]))
    root = world2["root"]
    serial = universal_attack.main(
        ["--dataset-dir", str(world2["paths"][0].parent), "--output", str(root / "universal_1"),
         "--device", "cpu", "--family", "tiny", "--image-size", str(SIZE), "--steps", "2",
         "--vis-every", "1"])
    pert, losses = world2["ranks"][0]["universal"]["main"]
    np.testing.assert_allclose(pert, serial.pert.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(losses, serial.losses, rtol=1e-6)
    np.testing.assert_allclose(np.load(root / "universal_dp" / "perturbation.npy"),
                               np.load(root / "universal_1" / "perturbation.npy"), atol=1e-6)
    assert sorted(p.name for p in (root / "universal_dp").iterdir()) == sorted(
        p.name for p in (root / "universal_1").iterdir())


def test_immunize_with_eot_shards_writes_once_and_matches_serial(world2):
    """``api.immunize(eot_shards=2)`` on two ranks: both return the serial
    run's history and iterate, and the first rank alone wrote the
    artifacts, one metrics row an iteration and the checkpoint."""
    root = world2["root"]
    cfg = TrainConfig(**API_CFG, source_image_path=world2["paths"][0],
                      target_image_path=world2["paths"][1], output_path=root / "immunize_1",
                      checkpoint_interval=1, image_visualization_interval=1)
    serial = api.immunize(cfg, device="cpu")
    r0, r1 = (r["immunize"] for r in world2["ranks"])
    assert r0["history"] == r1["history"]
    np.testing.assert_array_equal(r0["x_adv"], r1["x_adv"])
    np.testing.assert_allclose(r0["x_adv"], serial.x_adv.numpy(), rtol=0, atol=1e-5)
    for got, want in zip(r0["history"], serial.history):
        np.testing.assert_allclose([got[k] for k in sorted(want)],
                                   [want[k] for k in sorted(want)], rtol=1e-5)
    out = root / "immunize_dp"
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert sorted(r["step"] for r in rows) == [0, 1]
    assert sorted(p.name for p in out.iterdir()) == sorted(
        p.name for p in (root / "immunize_1").iterdir())
    a, b = (np.asarray(Image.open(d / "adversarial_image.png"), np.int16)
            for d in (out, root / "immunize_1"))
    assert np.abs(a - b).max() <= 1
    assert (out / "noise.npz").read_bytes() == (root / "immunize_1" / "noise.npz").read_bytes()


def test_stop_flag_on_one_rank_stops_both(world2):
    """A stop flag set on rank 1 before the second iteration stops both
    ranks before it; the first rank saves the state to resume from."""
    hist = [r["stopped"]["history"] for r in world2["ranks"]]
    assert hist[0] == hist[1]
    assert len(hist[0]) == 2 and hist[0][-1] == {"preempted_at": 1}
    np.testing.assert_array_equal(*(r["stopped"]["x_adv"] for r in world2["ranks"]))
    with np.load(world2["root"] / "stopped" / "attack_state.npz") as state:
        assert int(state["iteration"]) == 1


def test_immunize_batch_over_data_ranks_pads_and_matches_serial(world2):
    """Three images over a data axis of 2 (the list padded with the last
    image to 4): every rank returns the three serial results, and the
    artifacts equal the serial ``immunize_batch``'s."""
    root = world2["root"]
    cfg = TrainConfig(**{**API_CFG, "grad_reps": 2}, n_noise=2, enable_visualization=False,
                      output_path=root / "batch_1")
    serial = api.immunize_batch(cfg, world2["paths"], device="cpu", seeds=[11, 12, 13])
    for r in world2["ranks"]:
        assert len(r["batch"]["x_adv"]) == 3
        for got, hist, want in zip(r["batch"]["x_adv"], r["batch"]["history"], serial):
            np.testing.assert_allclose(got, want.x_adv.numpy(), rtol=0, atol=1e-5)
            np.testing.assert_allclose([h["avg_loss"] for h in hist],
                                       [h["avg_loss"] for h in want.history], rtol=1e-5)
    for path in world2["paths"]:
        a, b = (root / d / path.stem for d in ("batch_dp", "batch_1"))
        assert (a / "noise.npz").read_bytes() == (b / "noise.npz").read_bytes()
        pa, pb = (np.asarray(Image.open(d / "adversarial_image.png"), np.int16) for d in (a, b))
        assert np.abs(pa - pb).max() <= 1
    assert len((root / "batch_dp" / "metrics.jsonl").read_text().splitlines()) == 3


def test_evaluate_with_eval_shards_matches_serial(world2):
    """``evaluate(eval_shards=2)``: three cells in one batch of 2 a rank
    (padded to 4), the grids equal to the serial call's within one uint8
    level on both ranks, written once."""
    root = world2["root"]
    cfg = InferenceConfig(source_image_path=world2["paths"][0],
                          target_image_path=world2["paths"][1], model_family="tiny",
                          image_size=SIZE, n_steps=10, seed=5, output_path=root / "eval_1",
                          validation_images_path=None)
    grids = api.evaluate(cfg, Image.open(root / "adversarial.png").convert("RGB"), EVAL_PROMPTS,
                         device="cpu")
    assert len(grids) == 3
    for r in world2["ranks"]:
        assert len(r["evaluate"]) == 3
        for got, want in zip(r["evaluate"], grids):
            assert np.abs(got.astype(np.int16) - np.asarray(want, np.int16)).max() <= 1
    names = sorted(p.name for p in (root / "eval_1").glob("*.png"))
    assert len(names) == 3 and names == sorted(p.name for p in (root / "eval_dp").glob("*.png"))
