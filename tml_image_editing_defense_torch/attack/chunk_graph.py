"""One EOT chunk replayed from CUDA graphs.

A chunk of :func:`~tml_image_editing_defense_torch.attack.pgd.make_batched_eot_grad`
is the loss of its rows through the chain and its gradient with respect to
the VAE posterior (mean, logvar): on SD-1.5 at 512² about 6400 small eager
launches, whose dispatch on the host sets the pace of the step.
:class:`ChunkRunner` captures the chunk's forward and its backward once, as
two CUDA graphs (the forward first, then the backward, the order they
replay, as ``torch.cuda.make_graphed_callables`` pairs them), and replays
the pair for every later chunk of the same key.  A capture shares the
private memory pool of the graphs alive (:class:`_Graph`), so that two steps
alive at once (a sharded step beside ``api.immunize``'s) hold one chunk's
memory between them, not one each.

The rule, from what the code can observe (no option):

- a chunk may replay where its tensors are on the card, autograd records,
  and the step checkpoints nothing inside the chunk (``remat_policy``
  "none", no ``remat_vae``): a checkpoint saves and restores the RNG state,
  which cannot be read during a capture (:func:`engages`);
- the key (:func:`chunk_key`) is the inputs' shapes, dtypes and devices,
  the optional conditioning (SDXL's ``text_embeds``, ``time_ids``) present
  or not; one pair is kept, and a new key releases it;
- the first chunk of a key runs eager, as the warm-up: every first use
  (the kernel library's load, shared-memory attributes, cuDNN's plans)
  happens outside the capture; the next chunk captures and replays.

Under a recording (``utils/profiling.py``) a capture runs with the spans
paused, since a span's CUDA events would go into the graph, so a traced
step takes the same path as an untraced one.  The spans inside the chunk
(``tid.unet*``, ``tid.vae.decode*``, ``tid.attention*``) fire in an eager
chunk only; ``tid.eot.forward`` and ``tid.eot.backward`` hold the captures
and the replays, and the counts a capture takes (``launches.<symbol>``,
``attention.<route>``) land in them.

Counters, in the chunk's ``tid.eot.forward`` span and in :data:`COUNTS`:
``eot.chunks.graph`` (a chunk served by replay), ``eot.chunks.eager``
(a warm-up or a stand-down), ``eot.graph.captures``.  A replay launches
nothing through a ``CudaKernel``, whose ``launches`` count the eager calls
and, once, the calls a capture makes into its graph; :data:`COUNTS` keeps
those calls by kernel, and the launches the replays ran, so that
:func:`kernel_runs` can tell how often each kernel ran on the card.
"""

from __future__ import annotations

import weakref
from collections import Counter
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.ops import flash_attention
from tml_image_editing_defense_torch.utils import profiling

#: the device type whose chunks replay (a CPU test puts "cpu" here, with a
#: stand-in for :func:`capture`)
GRAPH_DEVICE = "cuda"

#: the hand-written kernels a chunk runs (the update, K4 / K5, runs outside)
KERNELS = flash_attention.KERNELS

#: this process's chunks, under the counters' names, and by kernel symbol
#: ``captured.<symbol>`` (calls a capture made into its graph) and
#: ``replayed.<symbol>`` (launches the replays ran)
COUNTS: Counter = Counter()



def capture(fn: Callable, pool=None):
    """``fn()`` captured into a new CUDA graph, on ``pool`` (a private pool
    of its own when None): ``(graph, fn's outputs)``.  Entering the capture
    synchronizes and empties the allocator's cache, so the pool takes the
    blocks an eager chunk handed back instead of doubling the reserve."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return graph, out


def chunk_key(inputs: Sequence[Optional[torch.Tensor]]) -> tuple:
    """What a captured pair is valid for: each input's shape, dtype and
    device, or None where an optional input is absent."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device) for t in inputs)


def engages(cfg: TrainConfig, inputs: Sequence[Optional[torch.Tensor]]) -> bool:
    """Whether a chunk of ``cfg``'s step over ``inputs`` may replay."""
    return (cfg.remat_policy == "none" and not cfg.remat_vae and torch.is_grad_enabled()
            and all(t.device.type == GRAPH_DEVICE for t in inputs if t is not None))


def kernel_runs(kernels) -> Dict[str, int]:
    """How often each of ``kernels`` ran on the card, by symbol: its
    ``launches`` less the calls captures made, plus the replays' launches."""
    return {k.symbol: k.launches - COUNTS[f"captured.{k.symbol}"]
            + COUNTS[f"replayed.{k.symbol}"] for k in kernels}


def _count(name: str) -> None:
    COUNTS[name] += 1
    profiling.count(name)


class _Graph:
    """One captured graph and the kernel calls its capture made.  It
    allocates from the pool of a graph alive on its device, where there is
    one: a pair replays its forward and then its backward, never between
    another pair's two, so what a pair frees during its capture (its
    temporaries, the activations its backward consumes) may serve the
    others, while what it keeps (its static tensors) stays its own.  (A pool
    is freed with its last graph, and a capture into it after that fails.)"""

    _alive: "weakref.WeakSet[_Graph]" = weakref.WeakSet()

    def __init__(self, fn: Callable):
        self.device = torch.cuda.current_device()
        pool = next((g.graph.pool() for g in _Graph._alive if g.device == self.device), None)
        before = {k.symbol: k.launches for k in KERNELS}
        with profiling.spans_paused():
            self.graph, self.outputs = capture(fn, pool)
        _Graph._alive.add(self)
        self.launches = {k.symbol: k.launches - before[k.symbol] for k in KERNELS
                         if k.launches != before[k.symbol]}
        for sym, n in self.launches.items():
            COUNTS[f"captured.{sym}"] += n

    def replay(self) -> None:
        self.graph.replay()
        for sym, n in self.launches.items():
            COUNTS[f"replayed.{sym}"] += n


class ChunkGraphs:
    """A chunk's forward and backward captured from ``forward(m, lv, *rest)
    -> (loss, *outputs)`` at ``inputs``, as two graphs, with the
    static tensors they read (copies of the inputs, the first two requiring
    a gradient) and write (``outputs``: the gradients of ``loss.sum()`` with
    respect to the first two inputs, then the forward's outputs).  The
    forward is captured at once, the backward at its first call, in the
    backward's span."""

    def __init__(self, forward: Callable, inputs: Sequence[Optional[torch.Tensor]]):
        self.inputs = [None if t is None else t.detach().clone() for t in inputs]
        wrt = [t.requires_grad_(True) for t in self.inputs[:2]]
        loss = []

        def fwd():
            outs = forward(*self.inputs)
            loss.append(outs[0].sum())
            return outs

        self.fwd = _Graph(fwd)
        self._grads = lambda: torch.autograd.grad(loss.pop(), wrt)     # noqa: E731
        self.bwd: Optional[_Graph] = None
        self.outputs: Tuple = ()

    def forward(self, inputs: Sequence[Optional[torch.Tensor]]) -> None:
        if self.bwd is not None:
            # (the capture's own chunk reads the copies the capture took: a
            # copy into them now would bump the versions its backward checks)
            with torch.no_grad():
                for static, t in zip(self.inputs, inputs):
                    if static is not None:
                        static.copy_(t)
        self.fwd.replay()

    def backward(self) -> None:
        if self.bwd is None:
            self.bwd = _Graph(self._grads)
            self.outputs = (*self.bwd.outputs, *(o.detach() for o in self.fwd.outputs))
        self.bwd.replay()


class ChunkRunner:
    """The chunks of one step: ``runner(inputs, **attrs) -> (g_m, g_lv,
    loss, *outputs)``, all detached, for ``inputs`` = (m, lv, *rest), from
    ``forward(m, lv, *rest) -> (loss, *outputs)``; the gradients are those
    of ``loss.sum()`` with respect to m and lv.  Eager or replayed by the
    module's rule; ``attrs`` go to the ``tid.eot.forward`` span.  What a
    replay returns is the pair's static tensors, which the next chunk
    overwrites."""

    def __init__(self, forward: Callable, cfg: TrainConfig):
        self.forward, self.cfg = forward, cfg
        self.key: Optional[tuple] = None
        self.graphs: Optional[ChunkGraphs] = None

    def __call__(self, inputs: Sequence[Optional[torch.Tensor]], **attrs) -> Tuple:
        if not engages(self.cfg, inputs):
            return self._eager(inputs, attrs)
        key = chunk_key(inputs)
        if key != self.key:
            if self.graphs is not None:
                self.graphs = None
                torch.cuda.empty_cache()    # the old pair's blocks, before the warm-up
            self.key = key
            return self._eager(inputs, attrs)
        with profiling.span("tid.eot.forward", **attrs):
            if self.graphs is None:
                self.graphs = ChunkGraphs(self.forward, inputs)
                _count("eot.graph.captures")
            _count("eot.chunks.graph")
            self.graphs.forward(inputs)
        with profiling.span("tid.eot.backward", waits=True):
            self.graphs.backward()
        return self.graphs.outputs

    def _eager(self, inputs, attrs) -> Tuple:
        m, lv = (t.detach().requires_grad_(True) for t in inputs[:2])
        with profiling.span("tid.eot.forward", **attrs):
            _count("eot.chunks.eager")
            outs = self.forward(m, lv, *inputs[2:])
        with profiling.span("tid.eot.backward", waits=True):
            grads = torch.autograd.grad(outs[0].sum(), [m, lv])
        return (*grads, *(o.detach() for o in outs))
