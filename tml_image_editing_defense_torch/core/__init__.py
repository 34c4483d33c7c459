"""Schedules, samplers, noise pools and image I/O."""

from tml_image_editing_defense_torch.core.rng import load_noise_pool, make_noise_pool, save_noise_pool
from tml_image_editing_defense_torch.core.samplers import DenoisePlan, LCMSampler, make_sampler
from tml_image_editing_defense_torch.core.schedule import NoiseSchedule, make_noise_schedule

__all__ = [
    "DenoisePlan", "LCMSampler", "NoiseSchedule", "load_noise_pool", "make_noise_pool",
    "make_noise_schedule", "make_sampler", "save_noise_pool",
]
