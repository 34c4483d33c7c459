"""Editing pipelines: img2img (SDEdit) and txt2img (port of
``pipelines/img2img.py``).

The reference's vendored SD-1.5 img2img pipeline carries one real change:
a caller-supplied ``noise`` pins the initial latent noise, so that the
evaluation edits with the noise the attack was trained against
(``pipelines/pipeline_stable_diffusion_img2img.py:722, 779-783, 848-875,
1057``).  Here ``noise`` is an argument, and so is every other draw: the
VAE posterior noise (``vae_eps``) and the step noise of a sampler that takes
one (LCM; DDIM with eta > 0).  The pipelines draw nothing themselves: a
draw left out raises.  Everything runs under ``torch.no_grad``.

Evaluation runs in f32, as the reference's inference does
(``Trainer.load_models(dtype=torch.float32)``, main.py:446).  The model's
long self-attentions go to the flash kernel K1 when the model was built
with ``attn_kv_chunk`` (``api.evaluate`` builds with 512); see
``api.evaluate`` for why.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from PIL import Image

from tml_image_editing_defense_torch.attack.forward import CondInputs, denoise_chain, make_time_ids
from tml_image_editing_defense_torch.core import image_ops
from tml_image_editing_defense_torch.core.samplers import DenoisePlan, make_sampler
from tml_image_editing_defense_torch.models.model_zoo import DiffusionModel


def _require(draw: Optional[torch.Tensor], what: str) -> torch.Tensor:
    if draw is None:
        raise ValueError(f"pass {what}: the pipeline draws nothing itself")
    return draw


def _to_pils(images: torch.Tensor) -> List[Image.Image]:
    """[B, 3, H, W] in [0, 1] -> B PIL images."""
    return [image_ops.to_pil(images[i], denormalize=False) for i in range(images.shape[0])]


class Img2ImgPipeline:
    """SDEdit-style image editing (reference ``__call__`` semantics at
    ``pipeline_stable_diffusion_img2img.py:846-1148``)."""

    def __init__(self, model: DiffusionModel, sampler: str = "plms", eta: float = 0.0):
        self.model = model
        kwargs = {"eta": eta} if sampler == "ddim" else {}
        self.sampler = make_sampler(sampler, model.schedule, **kwargs)

    # -- host side ---------------------------------------------------------

    def plan(self, num_inference_steps: int, strength: Optional[float] = 0.6,
             denoising_start: Optional[float] = None,
             denoising_end: Optional[float] = None) -> DenoisePlan:
        """The edit's plan.  SDXL's windowing (sdxl_img2img_pipeline.py:
        306-320, 392-412): ``denoising_start`` drops the head
        (t >= T (1 - start)) in place of ``strength``; ``denoising_end``
        drops the tail (t < T (1 - end))."""
        t_train = self.model.schedule.num_train_timesteps
        limit_t = None if denoising_start is None else int(round(t_train * (1.0 - denoising_start)))
        min_t = None if denoising_end is None else int(round(t_train * (1.0 - denoising_end)))
        return self.sampler.plan(num_inference_steps,
                                 strength=None if denoising_start is not None else strength,
                                 limit_t=limit_t, min_t=min_t)

    def prepare_image(self, image) -> torch.Tensor:
        """PIL image(s) or a [B, 3, H, W] / [3, H, W] tensor in [-1, 1] ->
        [B, 3, H, W] on the model's device."""
        m = self.model
        if isinstance(image, (list, tuple)):
            return torch.cat([self.prepare_image(im) for im in image])
        if isinstance(image, Image.Image):
            image = torch.from_numpy(image_ops.preprocess_pil(image, m.image_size))
        image = image.to(device=m.device, dtype=m.dtype)
        return image[None] if image.dim() == 3 else image

    def cond(self, prompts: Sequence[str], negative_prompt: str, copies: int,
             aesthetic_score: Optional[float] = None,
             negative_aesthetic_score: Optional[float] = None) -> CondInputs:
        """CFG conditioning for ``copies`` images of each prompt in turn:
        the unconditional rows of the whole batch, then the prompts' rows.
        An SDXL model also takes the pooled embeds and the time ids at its
        image size, the refiner's 5-tuple when ``aesthetic_score`` is set
        (JAX ``_prepare_cond``, pipelines/img2img.py:113-125)."""
        m = self.model
        bank = m.embed_prompt_bank(list(prompts), negative_prompt)

        def cfg_rows(uncond, cond):
            cond = cond.repeat_interleave(copies, dim=0)
            return torch.cat([uncond.expand(cond.shape[0], *uncond.shape), cond]).to(m.dtype)

        out = CondInputs(ctx=cfg_rows(bank.uncond, bank.embeds))
        if bank.pooled is not None:
            n = len(prompts) * copies
            out.text_embeds = cfg_rows(bank.uncond_pooled, bank.pooled)
            out.time_ids = make_time_ids(m.image_size, m.dtype, m.device, aesthetic_score,
                                         negative_aesthetic_score).repeat_interleave(n, dim=0)
        return out

    # -- device side -------------------------------------------------------

    @torch.no_grad()
    def generate(self, plan: DenoisePlan, image: Optional[torch.Tensor], cond: CondInputs,
                 noise: Optional[torch.Tensor], vae_eps: Optional[torch.Tensor],
                 step_noise: Optional[torch.Tensor], guidance_scale: float,
                 latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode (posterior draw with ``vae_eps``), noise to the plan's
        first timestep with ``noise``, denoise, decode; or, with ``latents``,
        denoise those from the plan's first step.  [B, 3, H, W] in [0, 1]."""
        m = self.model
        if latents is None:
            x = self.sampler.add_noise(plan, m.encode_image(image, vae_eps), noise)
        else:
            x = latents
        x = denoise_chain(m, self.sampler, plan, x, cond, guidance_scale, step_noise)
        return (m.decode_latent(x, scaled=True) / 2.0 + 0.5).clamp(0.0, 1.0)

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        image=None,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        strength: float = 0.6,
        noise: Optional[torch.Tensor] = None,
        negative_prompt: str = "",
        vae_eps: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
        output_type: str = "pil",
        latents: Optional[torch.Tensor] = None,
        denoising_start: Optional[float] = None,
        denoising_end: Optional[float] = None,
        aesthetic_score: Optional[float] = None,
        negative_aesthetic_score: Optional[float] = None,
    ):
        """Edit ``image`` (one, a list, or a batch) with ``prompt``.

        ``noise`` ([1 or B, C, h, w]) pins the initial latent noise, as the
        reference's ``noise=``; ``vae_eps`` ([B, C, h, w]) is the posterior
        draw; ``step_noise`` ([K, B, C, h, w]) the step draws of a sampler
        that takes them; each one the edit needs must be passed.
        ``latents`` with ``denoising_start`` continue a partly
        denoised latent (SDXL's base-to-refiner handoff); ``denoising_end``
        stops early; ``aesthetic_score`` gives a refiner its 5-tuple of
        time ids.  Returns PIL images (one, or a list for a batch), or
        with ``output_type="pt"`` a [B, 3, H, W] tensor in [0, 1]."""
        m = self.model
        plan = self.plan(num_inference_steps, strength, denoising_start, denoising_end)
        c, hw = m.latent_shape[1], m.latent_shape[2:]
        img = None
        if latents is not None:
            b = latents.shape[0]
            latents = latents.to(device=m.device, dtype=m.dtype)
        else:
            img = self.prepare_image(image)
            b = img.shape[0]
            noise = _require(noise, "noise").to(device=m.device, dtype=m.dtype)
            noise = noise.expand(b, c, *hw)
            vae_eps = _require(vae_eps, "vae_eps")
        if self.sampler.uses_step_noise:
            _require(step_noise, "step_noise")
        cond = self.cond([prompt], negative_prompt, b, aesthetic_score, negative_aesthetic_score)
        out = self.generate(plan, img, cond, noise, vae_eps, step_noise, guidance_scale, latents)
        if output_type != "pil":
            return out
        pils = _to_pils(out)
        return pils[0] if b == 1 else pils

    @torch.no_grad()
    def edit_pairs(
        self,
        prompts: Sequence[str],
        pair_images: torch.Tensor,           # [P, 2, 3, H, W] (clean, adv) in [-1, 1]
        pair_noises: torch.Tensor,           # [P, 2, C, h, w]
        vae_eps: torch.Tensor,               # [P, 2, C, h, w]
        step_noise: Optional[torch.Tensor] = None,   # [P, K, 2, C, h, w]
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        strength: float = 0.6,
        negative_prompt: str = "",
        denoising_end: Optional[float] = None,
        aesthetic_score: Optional[float] = None,
        negative_aesthetic_score: Optional[float] = None,
    ) -> torch.Tensor:
        """Batched (clean, adv) double edits: the P cells' 2P images go
        through one chain as one batch.  Each cell keeps its prompt and its
        draws, so each equals the cell's own ``__call__`` (the reference runs
        19 x n_noise sequential pipeline pairs, main.py:469-521).  Returns
        [P, 2, 3, H, W] in [0, 1]."""
        p = len(prompts)
        plan = self.plan(num_inference_steps, strength, None, denoising_end)
        flat = lambda t: t.reshape(2 * p, *t.shape[2:])                      # noqa: E731
        if step_noise is not None:
            step_noise = step_noise.transpose(0, 1).reshape(plan.num_steps, 2 * p,
                                                            *step_noise.shape[3:])
        cond = self.cond(prompts, negative_prompt, 2, aesthetic_score, negative_aesthetic_score)
        out = self.generate(plan, flat(pair_images), cond, flat(pair_noises), flat(vae_eps),
                            step_noise, guidance_scale)
        return out.reshape(p, 2, *out.shape[1:])


class Txt2ImgPipeline(Img2ImgPipeline):
    """Text-to-image generation (reference ``sdxl_pipeline.py``); also takes
    precomputed ``latents``, as the legacy universal-perturbation trainer
    does (``old/train_noise.py:141-149``)."""

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        latents: Optional[torch.Tensor] = None,
        negative_prompt: str = "",
        step_noise: Optional[torch.Tensor] = None,
        output_type: str = "pil",
    ):
        """Denoise ``latents`` ([1, C, h, w]), which the caller draws
        (for Euler, scaled by the plan's ``init_sigma``); ``step_noise``
        ([K, 1, C, h, w]) as for img2img."""
        m = self.model
        plan = self.sampler.plan(num_inference_steps)
        latents = _require(latents, "latents").to(device=m.device, dtype=m.dtype)
        if self.sampler.uses_step_noise:
            _require(step_noise, "step_noise")
        out = self.generate(plan, None, self.cond([prompt], negative_prompt, 1), None, None,
                            step_noise, guidance_scale, latents)
        return _to_pils(out)[0] if output_type == "pil" else out
