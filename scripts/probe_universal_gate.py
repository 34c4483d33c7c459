#!/usr/bin/env python3
"""Why the universal gate of ``chip_smoke.py`` holds the TAESD preview's
update at 1e-2 and the full VAE decode's at 1e-3: on one card, one
SD-1.5 512x512 universal step (``universal_attack.main``'s defaults, one
step to build the model) on fixed draws, with the TAESD decode and with the
full VAE decode:

- with cuDNN deterministic, the update through the kernels twice, through
  plain attention twice, and kernels against plain (L2 of the difference
  over the update's), with the losses;
- the plain step with the UNet's epsilon moved by a relative 1e-7 and
  1e-6 of seeded noise (the update's sensitivity to f32 rounding);
- the kernels' forward difference at the output of one LCM step.

    python3 scripts/probe_universal_gate.py [--report PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from tml_image_editing_defense_torch import universal_attack
    from tml_image_editing_defense_torch.attack import universal
    from tml_image_editing_defense_torch.attack.forward import select_cond
    from tml_image_editing_defense_torch.models import layers
    from tml_image_editing_defense_torch.ops import _lib

    if not torch.cuda.is_available():
        print("probe_universal_gate: CUDA is not available", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    _lib.library()

    def rel(a, b) -> float:
        return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

    def plain(flag: bool):
        layers.MIN_CHUNKED_SEQ = 1 << 30 if flag else floor

    floor = layers.MIN_CHUNKED_SEQ
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "ds").mkdir()
        for i in range(3):
            chip_smoke.synthetic_image(tmp / "ds" / f"u{i}.png", 200 + i)
        run = universal_attack.main(["--dataset-dir", str(tmp / "ds"), "--output",
                                     str(tmp / "out"), "--family", "sd15", "--steps", "1"])
        model = run.model
        real_unet = model.apply_unet
        torch.backends.cudnn.deterministic = True
        try:
            for name, case in (("taesd", run), ("full_vae", dataclasses.replace(run, preview=None))):
                step, src, pert, draws = chip_smoke.universal_step_inputs(universal, case)
                res, ups = {}, {}
                for tag in ("k1", "k2", "p1", "p2"):
                    plain(tag.startswith("p"))
                    new, loss = step(pert, src, draws)
                    ups[tag], res[f"loss_{tag}"] = new - pert, loss.item()
                plain(False)
                res.update(k_vs_k=rel(ups["k2"], ups["k1"]), p_vs_p=rel(ups["p2"], ups["p1"]),
                           k_vs_p=rel(ups["k1"], ups["p1"]))
                plain(True)
                for scale in (1e-7, 1e-6):
                    gen = torch.Generator(device=model.device).manual_seed(5)

                    def noisy_unet(*a, scale=scale, gen=gen, **kw):
                        eps = real_unet(*a, **kw)
                        return eps * (1 + scale * torch.randn(eps.shape, generator=gen,
                                                              device=eps.device))

                    model.apply_unet = noisy_unet
                    new, _ = step(pert, src, draws)
                    model.__dict__.pop("apply_unet", None)
                    res[f"plain_vs_unet_noise_{scale:g}"] = rel(new - pert, ups["p1"])
                plain(False)
                out[name] = res
            bank = model.embed_prompt_bank(list(run.cfg.edit_prompts))
            step, src, pert, draws = chip_smoke.universal_step_inputs(universal, run)
            with torch.no_grad():
                z = model.encode_image(src + pert, draws.vae_eps[0][None])
                noisy = model.schedule.add_noise(z, draws.noise[0][None], draws.t[0])
                cond = select_cond(bank.embeds, bank.uncond, draws.prompt_idx[0])
                outs = []
                for flag in (False, True):
                    plain(flag)
                    outs.append(universal.lcm_denoise_single_step(model, noisy, draws.t[0], cond,
                                                                  run.cfg.guidance_scale))
                plain(False)
            out["lcm_step_output_k_vs_p"] = rel(outs[0], outs[1])
        finally:
            torch.backends.cudnn.deterministic = False
            model.__dict__.pop("apply_unet", None)
            plain(False)
    print("[probe] universal gate, SD-1.5 512x512, one step of 4 reps: " + json.dumps(out),
          flush=True)
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(out, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
