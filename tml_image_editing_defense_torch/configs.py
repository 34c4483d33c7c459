"""Configuration: the immunization, evaluation and sweep configs and the prompt banks.

Port of ``tml_image_editing_defense_tpu/configs.py`` (``TrainConfig``,
``InferenceConfig``, ``SweepConfig`` and the prompt data).  Every field, default and the
norm-conditional ``__post_init__`` override (reference configs.py:152-159)
are the same, except two knobs that shaped the compiled TPU program and have
no counterpart in an eager loop, which are dropped:

- ``unroll_denoise``: whether XLA unrolls the K-step ``lax.scan``; the port's
  chain is a Python loop, unrolled by nature;
- ``dispatch_block``: iterations fused into one compiled dispatch; the port
  launches each iteration's kernels from the host.

``use_pallas_update`` keeps its name and now means "use the CUDA update
kernels" (K4 for L2, K5 for L-inf; ops/pgd_kernels.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

_TEXTURE_PROMPTS = (
    "",
    "melting",
    "shattered",
    "moldy",
    "plush",
    "futuristic",
    "glowing",
    "wet",
    "marble",
    "origami",
    "hologram",
    "made of glass",
    "covered in moss",
)

_STYLE_PROMPTS = (
    "painting",
    "sketch",
    "mosaic",
    "oil painting",
    "pencil drawing",
    "charcoal drawing",
    "pastel drawing",
    "ink drawing",
    "3d rendering",
    "comic drawing",
    "animation",
    "anime",
    "pixel art",
    "concept art",
    "minimalist art",
    "in the style of picasso",
    "in the style of van gogh",
    "in the style of monet",
    "wooden sculpture",
    "street art stencil",
    "chalk drawing",
)

_SCENE_PROMPTS = (
    "underwater",
    "on mars",
    "in utopian world",
    "in a desert",
    "in a city",
    "in an apocalypse",
    "in a fantasy world",
    "in a lightning storm",
    "in a medieval setting",
    "in a futuristic city",
    "in a forest",
    "in a jungle",
    "in a mountain",
    "on an alien planet",
    "during a sunset",
    "in an enchanted forest",
)

#: Training-time EOT prompt bank (50 entries, reference ``configs.py:7-60``).
PROMPTS_LIST: List[str] = list(_TEXTURE_PROMPTS + _STYLE_PROMPTS + _SCENE_PROMPTS)

#: Held-out evaluation prompts (reference ``configs.py:61-82``).
INFERENCE_PROMPTS: List[str] = [
    "frozen",
    "muddy",
    "gold",
    "lego",
    "made of candy",
    "watercolor painting",
    "cartoon",
    "pixel art",
    "grafiti",
    "abstract art",
    "cubism",
    "in space",
    "underwater",
    "in a snowstorm",
    "on a beach",
    "expressionist style",
    "disney style",
    "in a sci-fi world",
]

#: Negative prompt bank (reference ``configs.py:83``; commented out at every
#: call site in the reference, kept for parity).
NEGATIVE_PROMPT: str = (
    "(worst quality, low quality, blurry:1.3), (bad teeth, deformed teeth, "
    "deformed lips), (bad anatomy, bad proportions:1.1), (deformed iris, "
    "deformed pupils), (deformed eyes, bad eyes), (deformed face, ugly face, "
    "bad face), (deformed hands, bad hands, fused fingers), morbid, mutilated, "
    "mutation, disfigured"
)


def format_prompt(prompt: str, caption: str = "") -> str:
    """Optional caption prefix + ``, detailed`` suffix (main.py:86-87)."""
    if caption:
        prompt = f"{caption} {prompt}"
    return f"{prompt}, detailed"


@dataclass
class TrainConfig:
    """Immunization (PGD attack) configuration (reference configs.py:86-159).

    ``use_segmentation_mask`` restricts the L2 step to the source's salient
    region: ISNet from the RMBG-1.4 checkpoint directory
    ``segmentation_model_path``, else the JAX package's fallbacks (the
    ``transformers`` pipeline, then a heuristic).
    ``add_image_caption_to_prompts`` prefixes the prompts with the source's
    BLIP-2 caption (``caption_model_path``).  ``params_path`` (a params
    bundle from ``prepare_real_weights``, of either package) and
    ``tokenizer_paths`` (CLIP tokenizer directories) give real weights.
    ``eot_shards`` spreads the EOT reps over the ranks of a process group
    (``api.immunize``, ``parallel/eot.py``)."""

    # --- paths / bookkeeping ---
    source_image_path: Path = Path("data/images/japan.jpg")
    target_image_path: Path = Path("data/images/stick-figure-sticker.jpg")
    default_source_image_caption: str = ""
    output_path: Path = Path("./output")
    experiment_name: str = "experiment_l2_fixed_noise"

    # --- optimization schedule ---
    n_optimization_steps: int = 200
    n_denoising_steps_per_iteration: int = 4
    apply_loss_on_images: bool = True
    apply_loss_on_latents: bool = False
    limit_timesteps: bool = True          # drop denoise steps with t >= 700 (main.py:198-199)
    rec_loss_lambda: float = 1.0
    perturbation_loss_lambda: float = 1.0
    seed: int = 42

    # --- EOT distribution ---
    prompts: List[str] = field(default_factory=lambda: list(PROMPTS_LIST))
    #: CFG negative prompt shared by every EOT sample ("" is the reference's
    #: behaviour; NEGATIVE_PROMPT is defined but unused there).
    negative_prompt: str = ""

    # --- PGD hyperparameters ---
    norm_type: str = "l2"                 # "l2" | "linf"
    eps: float = 0.1
    step_size: float = 0.006
    min_value: float = -1.0
    max_value: float = 1.0
    guidance_scale: float = 3.0
    grad_reps: int = 5
    eta: float = 0.9                      # DDIM eta; the LCM sampler ignores it

    # --- behaviour toggles ---
    add_image_caption_to_prompts: bool = False
    use_segmentation_mask: bool = False
    use_fixed_noise: bool = True
    n_noise: int = 1
    caption_model_path: Optional[str] = None
    segmentation_model_path: Optional[str] = None

    # --- visualization ---
    image_visualization_interval: int = 25

    # --- model selection ---
    #: SDXL (the "sdxl" family) in place of SD-1.5; trained at image_size,
    #: 512 by default, as the reference trains it
    use_sdxl: bool = False
    use_lcm: bool = True
    image_size: int = 512
    #: "sd15" | "sd15-inpaint" | "sdxl" | "tiny" | "tiny-inpaint" |
    #: "tiny-sdxl" | "tiny-sdxl-refiner"; None derives from attack_mode and
    #: use_sdxl.
    model_family: Optional[str] = None
    #: "diffusion" (the reference's live path) | "inpaint" (PhotoGuard's
    #: attack on the 9-channel inpaint UNet, attack/inpaint.py).
    attack_mode: str = "diffusion"

    # --- knobs without a reference equivalent ---
    #: Replicate the reference's ``__post_init__`` override of
    #: eps/step_size/grad_reps by norm type (configs.py:152-159).
    derive_norm_hyperparams: bool = True
    #: Compute dtype of the models ("float32" | "bfloat16").
    dtype: str = "float32"
    #: How the EOT reps run (JAX configs.py:216-219): "scan" (chunks of
    #: ``eot_chunk`` reps one after another), "vmap" (all reps in one
    #: batch); "shard" runs as "scan", as in the JAX serial step: the reps
    #: go over ranks with ``eot_shards``.
    eot_mode: str = "scan"
    #: Reps batched through the chain together under "scan" (JAX
    #: configs.py:220-224): the UNet and VAE batches grow from 2 (CFG) to
    #: 2 x chunk, the activations by x chunk.  Must divide grad_reps.
    eot_chunk: int = 1
    #: Ranks the reps spread over (JAX configs.py:225-231), one per card:
    #: None takes the largest divisor of grad_reps that divides the
    #: machine's ranks (1 without a process group), 1 the serial step, N
    #: must divide grad_reps (``api._reps_sharding``).  In ``immunize_batch``
    #: above 1 it adds a ``reps`` axis beside the images' ``data`` axis.
    eot_shards: Optional[int] = None
    #: What the backward recomputes inside each denoising step (JAX
    #: configs.py:232-240, attack/forward.py::apply_remat): "none", "dots"
    #: (save the unbatched matmul outputs), "conv_dots" (and the
    #: convolutions'), "full" (recompute everything; SDXL at 1024x1024).
    remat_policy: str = "none"
    #: Checkpoint the shared VAE encode and each rep's decode, recomputed in
    #: the backward instead of saved (JAX configs.py:253-258).
    remat_vae: bool = False
    #: Use the CUDA update kernels (ops/pgd_kernels.py) for the PGD step.
    use_pallas_update: bool = True
    #: Decode and render the visualization grid at vis intervals.
    enable_visualization: bool = True
    #: Save the PGD state to ``output_path/attack_state.npz`` every N
    #: iterations (0 = off).
    checkpoint_interval: int = 0
    #: Params bundle of ``prepare_real_weights`` (None = random weights).
    params_path: Optional[Path] = None
    #: Local CLIP tokenizer directories (None = hash tokenizer).
    tokenizer_paths: Optional[List[Optional[str]]] = None

    def __post_init__(self):
        self.source_image_path = Path(self.source_image_path)
        self.target_image_path = Path(self.target_image_path)
        self.output_path = Path(self.output_path)
        if self.derive_norm_hyperparams:
            # reference semantics: overridden unconditionally by norm type
            if self.norm_type == "l2":
                self.eps = 32.0
                self.step_size = 7.5
                self.grad_reps = 10
            else:
                self.eps = 0.1
                self.step_size = 0.006
                self.grad_reps = 5

    @property
    def latent_size(self) -> int:
        return self.image_size // 8

    def asdict(self) -> dict:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, Path):
                d[k] = str(v)
        return d


@dataclass
class InferenceConfig:
    """Evaluation configuration (reference ``configs.py:162-193``).

    ``eval_shards`` splits the (prompt x noise) cells over the ranks of a
    process group.  ``add_image_caption_to_prompts``
    prefixes the prompts with the source's BLIP-2 caption
    (``caption_model_path``).  ``params_path`` and ``tokenizer_paths`` give
    real weights, as in :class:`TrainConfig`."""

    source_image_path: Path = Path("data/images/japan.jpg")
    target_image_path: Path = Path("data/images/japan.jpg")
    default_source_image_caption: str = ""
    output_path: Path = Path("./output")
    experiment_name: str = "experiment_inference"
    n_steps: int = 100                    # denoising steps for the edit
    strength: float = 0.6                 # SDEdit strength
    guidance_scale: float = 7.5
    seed: int = 42
    add_image_caption_to_prompts: bool = False
    use_fixed_noise: bool = True
    n_noise: int = 1
    #: CFG negative prompt for every evaluation edit ("" is the reference's)
    negative_prompt: str = ""
    caption_model_path: Optional[str] = None
    validation_images_path: Optional[Path] = Path("validation_images.txt")

    # --- model selection ---
    #: SDXL (the "sdxl" family; Euler without LCM); its native size is
    #: image_size=1024, where the edits run one cell at a time
    use_sdxl: bool = False
    use_lcm: bool = False
    image_size: int = 512
    model_family: Optional[str] = None

    # --- SDXL refiner-style knobs (sdxl_img2img_pipeline.py:306-320, 344-378) ---
    denoising_end: Optional[float] = None
    #: set: the refiner's 5-tuple of time ids (a "tiny-sdxl-refiner" UNet)
    aesthetic_score: Optional[float] = None
    #: the negative row's score in that 5-tuple (2.5 when unset)
    negative_aesthetic_score: Optional[float] = None

    # --- knobs without a reference equivalent ---
    dtype: str = "float32"
    save_images: bool = True
    #: Ranks the (prompt x noise) cells are split over (JAX
    #: configs.py:341-345): None is every rank of the machine (1 without a
    #: process group), 1 no split (``api._eval_shards``).
    eval_shards: Optional[int] = None
    params_path: Optional[Path] = None
    tokenizer_paths: Optional[List[Optional[str]]] = None

    def __post_init__(self):
        self.source_image_path = Path(self.source_image_path)
        self.target_image_path = Path(self.target_image_path)
        self.output_path = Path(self.output_path)
        if self.validation_images_path is not None:
            self.validation_images_path = Path(self.validation_images_path)

    def asdict(self) -> dict:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, Path):
                d[k] = str(v)
        return d


@dataclass
class SweepConfig:
    """Grid-sweep configuration (reference ``run_all.py:23-93``): {images} x
    {n_prompts in 1, 10, 25, all} x {n_noises in 1, 3, 5, fresh}.  On one
    card the cells run one after another (``api.sweep``)."""

    images_dir: Path = Path("./images")
    output_root: Path = Path("./output/sweep")
    n_prompts_grid: Tuple[Optional[int], ...] = (1, 10, 25, None)   # None = all prompts
    n_noises_grid: Tuple[Optional[int], ...] = (1, 3, 5, None)      # None = fresh noise
    n_optimization_steps: int = 250
    use_sdxl: bool = False
    use_lcm: bool = True
    inference_n_steps: int = 4
    inference_strength: float = 0.6
    inference_guidance_scale: float = 7.5
    seed: Optional[int] = None            # None = random per cell (run_all.py:41)
    #: Evaluate each cell after training (run_all.py:69-93); False writes
    #: the adversarial artifacts only.
    run_inference: bool = True

    def __post_init__(self):
        self.images_dir = Path(self.images_dir)
        self.output_root = Path(self.output_root)
