"""The frozen reference against itself, at the tiny size on the CPU."""

import json

import pytest
import torch

from portbench import counts, data
from portbench.reference import attack, models as ref

from .conftest import HERE

TINY = json.loads((HERE / "data" / "configs" / "tiny.json").read_text())
TRAIN = json.loads((HERE / "data" / "traffic" / "tiny-l2-b4.json").read_text())["train"]


def _setup(dtype=torch.float32, seed=3):
    unet, vae = counts.meta_models(TINY)
    sd = data.seeded_weights({"unet": unet, "vae": vae}, seed, "cpu", dtype)
    for name, net in (("unet", unet), ("vae", vae)):
        net.load_state_dict(sd[name], assign=True)
        net.requires_grad_(False)
    atk = attack.make_attack(TRAIN, TINY["scheduler"], TINY["vae"]["scaling_factor"])
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((1, 3, 32, 32), generator=g) * 0.4).clamp(-1, 1).to(dtype)
    tgt = (torch.randn((1, 3, 32, 32), generator=g) * 0.4).clamp(-1, 1).to(dtype)
    cond = (torch.randn((2, 16, 32), generator=g, dtype=dtype), None, None)
    pool = torch.randn((1, 1, 4, 16, 16), generator=g, dtype=dtype)
    d = data.draws("cpu", seed, 0, 0, 1, TRAIN["grad_reps"], 2, (4, 16, 16), 1, dtype)
    return unet, vae, atk, x, tgt, cond, pool, d


def test_weights_are_the_seeds():
    unet, vae = counts.meta_models(TINY)
    a = data.seeded_weights({"unet": unet}, 9, "cpu", torch.float32)["unet"]
    b = data.seeded_weights({"unet": unet}, 9, "cpu", torch.float32)["unet"]
    c = data.seeded_weights({"unet": unet}, 10, "cpu", torch.float32)["unet"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_in.weight"], c["conv_in.weight"])


def test_iteration_repeats_and_moves():
    unet, vae, atk, x, tgt, cond, pool, d = _setup()
    x1, l1 = attack.iteration(unet, vae, atk, x, x, tgt, [cond], [pool], [d])
    x2, l2 = attack.iteration(unet, vae, atk, x, x, tgt, [cond], [pool], [d])
    assert torch.equal(x1, x2) and l1 == l2
    moved = float(torch.linalg.vector_norm(x1 - x.float()))
    assert 0.8 * atk.step_size < moved <= atk.step_size * (1 + 1e-5)     # some pixels clamp


def test_shared_encode_is_the_chain_rule():
    """The gradient through the shared encode equals the mean of each rep's
    gradient through its own encode."""
    unet, vae, atk, x, tgt, cond, pool, d = _setup()
    x_out, (loss,) = attack.iteration(unet, vae, atk, x, x, tgt, [cond], [pool], [d])
    grads, losses = [], []
    for r in range(atk.grad_reps):
        xr = x.clone().requires_grad_(True)
        with torch.enable_grad():
            mean, logvar = vae.encode(xr)
            z = (mean + torch.exp(0.5 * logvar) * d["vae_eps"][r:r + 1]) * atk.vae_scaling
            lr = attack.chain_loss(unet, vae, atk, z, pool[int(d["pool_idx"][r])],
                                   d["step_noise"][r][:, None], *cond, tgt, x).sum()
            grads.append(torch.autograd.grad(lr, [xr])[0])
        losses.append(float(lr.detach()))
    want = attack.update(atk, x, sum(grads) / len(grads), x)
    assert loss == pytest.approx(sum(losses) / len(losses), rel=1e-5)
    assert torch.allclose(x_out, want, atol=1e-5)


def test_lower_precision_moves_the_answer():
    unet, vae, atk, x, tgt, cond, pool, d = _setup(torch.bfloat16)
    x1, l1 = attack.iteration(unet, vae, atk, x, x, tgt, [cond], [pool], [d])
    ref.NUMERICS.quant = "fp8"
    try:
        x2, l2 = attack.iteration(unet, vae, atk, x, x, tgt, [cond], [pool], [d])
    finally:
        ref.NUMERICS.quant = None
    r = torch.linalg.vector_norm(x2 - x1) / torch.linalg.vector_norm(x1 - x.float())
    assert float(r) > 0.1 and l1 != l2


def test_a_block_is_its_images_one_by_one():
    """Images batched through the reference give each image's own answer."""
    unet, vae, atk, x, tgt, cond, pool, d = _setup()
    _, _, _, x2, tgt2, cond2, pool2, d2 = _setup(seed=4)
    xb, lb = attack.iteration(unet, vae, atk, torch.cat([x, x2]), torch.cat([x, x2]),
                              torch.cat([tgt, tgt2]), [cond, cond2], [pool, pool2], [d, d2])
    xa, la = attack.iteration(unet, vae, atk, x2, x2, tgt2, [cond2], [pool2], [d2])
    assert torch.allclose(xb[1:], xa, atol=1e-5) and lb[1] == pytest.approx(la[0], rel=1e-5)


def test_lcm_plan_of_the_attack():
    plan = attack.lcm_plan(4, 700)
    assert plan.timesteps == [519, 279] and plan.prev == [279, 279]
    assert attack.lcm_plan(4, None).timesteps == [999, 759, 519, 279]


@pytest.mark.parametrize("name", ["sd15", "sdxl"])
def test_reference_names_the_programs_parameters(name):
    """The seeded state dicts load into the program's modules by name."""
    from tml_image_editing_defense_torch.models.model_zoo import build_model

    from portbench.cells import HERE as PB

    cfg = json.loads((PB / "configs" / f"{name}.json").read_text())
    unet, vae = counts.meta_models(cfg)
    model = build_model(cfg["port_family"], image_size=512, device="meta", attn_kv_chunk=512)
    for a, b in ((unet, model.unet), (vae, model.vae)):
        want = {k: tuple(v.shape) for k, v in b.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in a.state_dict().items()} == want
