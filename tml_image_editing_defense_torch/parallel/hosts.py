"""The sweep's work over machines (port of ``parallel/hosts.py``).

The reference's only "distribution" is a hand-split image list pinned to two
GPUs (``run_all.py:16-21``).  Here each machine takes a disjoint strided
slice of the sorted image list and sweeps it over its own ranks
(``launch_host.py``): no tensor crosses machines, all tensor-level
parallelism (images x reps) stays inside one machine's ranks.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, TypeVar

T = TypeVar("T")

#: Image suffixes the sweep globs (reference ``run_all.py:14`` globs ./images).
SWEEP_IMAGE_SUFFIXES = (".jpg", ".png", ".jpeg")


def list_sweep_images(images_dir) -> List[Path]:
    """The images of ``images_dir`` with a suffix of
    :data:`SWEEP_IMAGE_SUFFIXES`, sorted by path: every machine derives the
    same list, the precondition of disjoint shards."""
    return sorted(p for p in Path(images_dir).glob("*") if p.suffix in SWEEP_IMAGE_SUFFIXES)


def shard_for_host(items: Sequence[T], process_index: int, process_count: int) -> List[T]:
    """Machine ``process_index``'s slice of the work, ``items[index::count]``
    (JAX :34-48): strided, so a sorted list spreads evenly over the machines
    for any length; the slices are disjoint and their union is ``items``."""
    if process_count < 1:
        raise ValueError(f"process_count must be >= 1, got {process_count}")
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} out of range for {process_count} hosts")
    return list(items)[process_index::process_count]


def describe_host_shards(images_dir, process_count: int) -> str:
    """Each machine's images as a readable table (JAX :51-59)."""
    images = list_sweep_images(images_dir)
    lines = [f"{len(images)} images in {images_dir}, {process_count} hosts:"]
    for h in range(process_count):
        mine = shard_for_host(images, h, process_count)
        names = ", ".join(p.name for p in mine) or "(idle)"
        lines.append(f"  host {h}: {len(mine)} images — {names}")
    return "\n".join(lines)
