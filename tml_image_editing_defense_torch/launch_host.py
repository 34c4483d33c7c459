"""One machine's share of a sweep over several machines (port of
``launch_host.py``):
``python -m tml_image_editing_defense_torch.launch_host IMAGES_DIR OUTPUT_ROOT``.

Every rank runs this module.  The ranks of one machine form its node;
node ``k`` of ``n`` takes ``shard_for_host(list_sweep_images(IMAGES_DIR), k,
n)`` (``parallel/hosts.py``) and sweeps it with ``api.sweep(...,
data_parallel=True)`` over its own ranks: no tensor crosses machines, as in
the JAX package's DCN tier.  Three ways to start the ranks:

- under torchrun, one process per card: ``torchrun --nnodes M
  --nproc-per-node N ... -m tml_image_editing_defense_torch.launch_host
  IMAGES OUT`` (the process group from its environment);
- by hand, one command per rank: ``--coordinator host:port
  --num-processes W --process-id I [--nproc-per-node N]`` (ranks ``I`` with
  the same ``I // N`` share a machine);
- on this machine, for tests and checks: ``--local M [--nproc-per-node N]
  --backend gloo --device cpu`` spawns M x N ranks that play M machines
  (:func:`spawn_local`, which other callers use to run any function on
  several ranks).

``--config-json FILE`` holds ``{"sweep": {SweepConfig fields}, "train_overrides":
{TrainConfig fields}}``.  The first rank of each machine prints
``HOST_SWEEP_DONE node=k/n images=[...]``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional, Sequence


def _rank_main(rank: int, fn: Callable, args: tuple, world_size: int, nproc_per_node: int,
               init_file: str, backend: Optional[str], device: str, results) -> None:
    """One spawned rank: torchrun's environment, the process group, then
    ``fn(*args)``; its return value (pickled by value) or its traceback goes
    to ``results``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank % nproc_per_node),
                      LOCAL_WORLD_SIZE=str(nproc_per_node))
    import torch

    from tml_image_editing_defense_torch.parallel.mesh import (
        destroy_distributed,
        init_distributed,
    )

    if torch.device(device).type == "cpu":
        # N ranks on one machine's cores: one thread each
        torch.set_num_threads(1)
    try:
        init_distributed(backend, device, init_method=f"file://{init_file}")
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        destroy_distributed()


def spawn_local(fn: Callable, world_size: int, args: Sequence = (),
                backend: Optional[str] = None, device: str = "cpu",
                nproc_per_node: Optional[int] = None, workdir: Optional[Path] = None,
                timeout: float = 3600.0) -> List:
    """Run ``fn(*args)`` on ``world_size`` ranks spawned on this machine
    (``torch.multiprocessing``, the ``spawn`` start method, a ``file://``
    rendezvous in ``workdir`` or a temporary directory) and return each
    rank's return value, in rank order.  ``fn`` must be importable by name
    (a module-level function; the child imports its module).  Each rank has
    torchrun's environment with ``nproc_per_node`` ranks a machine (default:
    all on one) and the default process group of
    :func:`~tml_image_editing_defense_torch.parallel.mesh.init_distributed`
    with ``backend`` on ``device``.  Raises with every failed rank's
    traceback; every rank is ended before it returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    nproc = nproc_per_node or world_size
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init_file = str(Path(tmp) / "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(r, fn, tuple(args), world_size, nproc,
                                                      init_file, backend, device, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        try:
            while len(got) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                    got[rank] = (ok, payload)
                    if not ok:
                        # the others may wait on it in a collective: a grace, then an end
                        deadline = min(deadline, time.monotonic() + 10.0)
                except queue_mod.Empty:
                    dead = [p for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead or time.monotonic() > deadline:
                        break
        finally:
            for p in procs:
                p.join(timeout=5 if len(got) == world_size else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    failed = {r: v[1] for r, v in got.items() if not v[0]}
    missing = [r for r in range(world_size) if r not in got]
    if failed or missing:
        raise RuntimeError(f"ranks failed: {sorted(failed)}, ended without a result: {missing}\n"
                           + "\n".join(f"--- rank {r} ---\n{tb}"
                                       for r, tb in sorted(failed.items())))
    return [pickle.loads(got[r][1]) for r in range(world_size)]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tml_image_editing_defense_torch.launch_host",
                                description="Sweep this machine's share of an image list.")
    p.add_argument("images_dir", type=Path)
    p.add_argument("output_root", type=Path)
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's rendezvous, for ranks started by hand")
    p.add_argument("--num-processes", type=int, default=None, help="ranks in all")
    p.add_argument("--process-id", type=int, default=None, help="this rank")
    p.add_argument("--nproc-per-node", type=int, default=1,
                   help="ranks a machine, with --coordinator or --local")
    p.add_argument("--local", type=int, default=None, metavar="M",
                   help="spawn M machines' ranks on this one (tests and checks)")
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend (default: NCCL on cuda, gloo on cpu)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--config-json", type=Path, default=None,
                   help="JSON {'sweep': SweepConfig fields, 'train_overrides': {...}}")
    return p


def _sweep_share(args: argparse.Namespace) -> list:
    """This rank's part: its machine's images through ``api.sweep``."""
    from tml_image_editing_defense_torch import api
    from tml_image_editing_defense_torch.configs import SweepConfig
    from tml_image_editing_defense_torch.parallel.hosts import list_sweep_images, shard_for_host
    from tml_image_editing_defense_torch.parallel.mesh import is_writer, local_world_size, world

    sweep_fields, train_overrides = {}, None
    if args.config_json is not None:
        blob = json.loads(args.config_json.read_text())
        # JSON has no tuples; the grids arrive as lists
        sweep_fields = {k: tuple(v) if isinstance(v, list) else v
                        for k, v in blob.get("sweep", {}).items()}
        train_overrides = blob.get("train_overrides")
    cfg = SweepConfig(images_dir=args.images_dir, output_root=args.output_root, **sweep_fields)
    rank, size = world()
    per_node = local_world_size()
    node, nodes = rank // per_node, size // per_node
    mine = shard_for_host(list_sweep_images(cfg.images_dir), node, nodes)
    cells = api.sweep(cfg, device=args.device, image_paths=mine, data_parallel=True,
                      train_overrides=train_overrides)
    if is_writer():
        print(f"HOST_SWEEP_DONE node={node}/{nodes} images={[p.name for p in mine]}", flush=True)
    return cells


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.local is not None:
        spawn_local(_sweep_share, args.local * args.nproc_per_node, (args,),
                    backend=args.backend, device=args.device, nproc_per_node=args.nproc_per_node)
        return

    from tml_image_editing_defense_torch.parallel.mesh import (
        destroy_distributed,
        init_distributed,
    )

    if args.coordinator is not None:
        os.environ.update(RANK=str(args.process_id), WORLD_SIZE=str(args.num_processes),
                          LOCAL_RANK=str(args.process_id % args.nproc_per_node),
                          LOCAL_WORLD_SIZE=str(args.nproc_per_node))
        init_distributed(args.backend, args.device, init_method=f"tcp://{args.coordinator}")
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_distributed(args.backend, args.device)         # torchrun's environment
    try:
        _sweep_share(args)
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
