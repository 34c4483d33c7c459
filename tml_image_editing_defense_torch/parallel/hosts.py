"""The sweep's image list (port of ``parallel/hosts.py:22-31``).

The host-sharding helpers beside it in the JAX package
(``shard_for_host``, ``describe_host_shards``) serve several processes and
wait for the multi-GPU slice."""

from __future__ import annotations

from pathlib import Path
from typing import List

#: Image suffixes the sweep globs (reference ``run_all.py:14`` globs ./images).
SWEEP_IMAGE_SUFFIXES = (".jpg", ".png", ".jpeg")


def list_sweep_images(images_dir) -> List[Path]:
    """The images of ``images_dir`` with a suffix of
    :data:`SWEEP_IMAGE_SUFFIXES`, sorted by path."""
    return sorted(p for p in Path(images_dir).glob("*") if p.suffix in SWEEP_IMAGE_SUFFIXES)
