"""The port's ``TrainConfig``, ``InferenceConfig``, ``SweepConfig`` and prompt data
against the JAX package's."""

from __future__ import annotations

import dataclasses

import pytest

from tml_image_editing_defense_tpu import configs as jc

from tml_image_editing_defense_torch import configs as pc

#: XLA-program knobs the port drops (configs.py docstring says why).
DROPPED = {"unroll_denoise", "dispatch_block"}


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            out[f.name] = f.default_factory()
    return out


def test_fields_and_defaults_match_jax_minus_dropped_knobs():
    jf, pf = _defaults(jc.TrainConfig), _defaults(pc.TrainConfig)
    assert DROPPED <= set(jf)
    assert set(pf) == set(jf) - DROPPED
    assert {k: pf[k] for k in pf} == {k: jf[k] for k in pf}


@pytest.mark.parametrize("norm_type", ["l2", "linf"])
@pytest.mark.parametrize("derive", [True, False])
def test_post_init_matches_jax(norm_type, derive):
    kw = dict(norm_type=norm_type, derive_norm_hyperparams=derive, eps=3.0, step_size=0.5,
              grad_reps=2, source_image_path="a.png", output_path="out")
    j, p = jc.TrainConfig(**kw), pc.TrainConfig(**kw)
    assert (p.eps, p.step_size, p.grad_reps) == (j.eps, j.step_size, j.grad_reps)
    assert p.source_image_path == j.source_image_path and p.output_path == j.output_path
    assert p.latent_size == j.latent_size
    assert {k: v for k, v in p.asdict().items()} == {
        k: v for k, v in j.asdict().items() if k not in DROPPED}


def test_prompt_data_matches_jax():
    assert pc.PROMPTS_LIST == jc.PROMPTS_LIST and len(pc.PROMPTS_LIST) == 50
    assert pc.NEGATIVE_PROMPT == jc.NEGATIVE_PROMPT
    for p, cap in (("painting", ""), ("in a city", "a dog")):
        assert pc.format_prompt(p, cap) == jc.format_prompt(p, cap)


def test_inference_config_and_prompts_match_jax():
    """``InferenceConfig``: every field and default, and ``__post_init__``'s
    paths; ``INFERENCE_PROMPTS`` equal."""
    assert _defaults(pc.InferenceConfig) == _defaults(jc.InferenceConfig)
    kw = dict(source_image_path="a.png", output_path="out", validation_images_path="v.txt")
    assert pc.InferenceConfig(**kw).asdict() == jc.InferenceConfig(**kw).asdict()
    assert pc.INFERENCE_PROMPTS == jc.INFERENCE_PROMPTS


def test_sweep_config_matches_jax():
    """``SweepConfig``: every field and default, and ``__post_init__``'s paths."""
    assert _defaults(pc.SweepConfig) == _defaults(jc.SweepConfig)
    assert [f.name for f in dataclasses.fields(pc.SweepConfig)] == [
        f.name for f in dataclasses.fields(jc.SweepConfig)]
    p = pc.SweepConfig(images_dir="imgs", output_root="out")
    j = jc.SweepConfig(images_dir="imgs", output_root="out")
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
