"""CUDA-graph capture and replay of a training step over static buffers.

The port's counterpart of the reference's per-key ``jax.jit`` program
cache behind its fused training paths (``fit_epochs``, ``fit_steps``,
the TBPTT window scan and the LM's multi-step program). XLA runs such a
path as one compiled program and one dispatch; here one step is captured
once as a CUDA graph and replayed, so the host pays one launch a step
instead of hundreds or thousands.

A graph records kernels with fixed pointers and fixed scalar arguments,
so every fused path follows the same rules:

- the step reads and writes **static buffers** (:class:`StaticTrainState`
  for params, updater state, net state, the iteration and the host LR
  scale; the path's own batch, cursor and history buffers), and the
  network's live tensors are copied in, and fresh tensors holding the
  result handed back, once per call with one multi-tensor copy per tree;
- everything a step varies lives on the device and is advanced by the
  step itself (``it.add_(1)``, a batch cursor), and nothing in a step
  reads a value back to the host;
- :class:`StepGraph` runs the first call eagerly on a side stream (the
  warm-up: kernels are built and their attributes set, autograd and the
  matmul libraries initialise; it is a real step of the schedule),
  captures the second call (capture records and runs nothing) and then
  replays it, so a run of S calls is exactly S steps. The dropout
  generator is registered with the graph, so each replay draws what the
  eager step would draw next.

On the CPU every call runs the same step function eagerly. On the card
a failed capture or replay raises: nothing falls back to the eager loop.

All the graphs of one network (or one LM) capture into one shared
memory pool (:class:`GraphPool`): they never run at the same time, and
everything a step hands to the next call or to the caller lies in
buffers allocated outside capture, so one graph's temporaries may reuse
another's. A network that keeps a program per key then holds one pool
of step temporaries, the size of its largest step, not one per key.

Kernel launches: a wrapper counts a launch when it is called, and during
a capture that call only records the launch. :func:`kernel_launches`
gives the launches the card really ran: the wrappers' counts, less what
captures recorded, plus what replays ran.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.dtypes import tree_map

# kernel launches that captures recorded (and did not run), and the
# launches replays ran, by kernel name
_RECORDED: collections.Counter = collections.Counter()
_REPLAYED: collections.Counter = collections.Counter()

# Test seam, not a user option: False runs every step eagerly on the card
# too, which the comparison of replayed against eager runs needs.
_capture = True


def _wrapper_counts() -> Dict[str, int]:
    from deeplearning4j_tpu_torch.kernels.flash_attention import launch_counts

    return launch_counts()


def kernel_launches() -> Dict[str, int]:
    """Launches of each hand-written kernel that ran on the card since the
    last :func:`reset_kernel_launches`, replays included."""
    return {k: n - _RECORDED[k] + _REPLAYED[k]
            for k, n in _wrapper_counts().items()}


def reset_kernel_launches() -> None:
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        reset_launch_counts)

    reset_launch_counts()
    _RECORDED.clear()
    _REPLAYED.clear()


class GraphPool:
    """The memory pool the graphs of one owner share, made at the first
    capture (so that nothing touches the card on the CPU)."""

    def __init__(self):
        self.handle = None

    def get(self):
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
        return self.handle


class StepGraph:
    """``fn()`` (no arguments: it reads and writes static buffers) run as
    warm-up, capture, replays on a CUDA device, and eagerly elsewhere.

    ``generators`` are the CUDA generators the step draws from; each is
    registered with the graph. ``pool`` is the owner's :class:`GraphPool`
    (None: a pool of the graph's own). Counts ``eager_calls``,
    ``captures`` and ``replays``; ``recorded`` holds the kernel launches
    of one replay."""

    def __init__(self, fn: Callable[[], None], device, *,
                 generators: Iterable[Optional[torch.Generator]] = (),
                 pool: Optional[GraphPool] = None):
        self.fn = fn
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        self.generators = tuple(g for g in generators
                                if g is not None and g.device.type == "cuda")
        self.pool = pool if pool is not None else GraphPool()
        self.graph = None
        self.warmed = False
        self.eager_calls = 0
        self.captures = 0
        self.replays = 0
        self.recorded: Dict[str, int] = {}

    def __call__(self) -> None:
        if not (self.graphed and _capture):
            self.fn()
            self.eager_calls += 1
        elif not self.warmed:
            self._warm_up()
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self.replays += 1
            _REPLAYED.update(self.recorded)

    def _warm_up(self) -> None:
        # on a side stream, as the CUDA-graphs notes ask: lazy
        # initialisation then happens off the stream that is captured
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.fn()
        current.wait_stream(side)
        self.warmed = True
        self.eager_calls += 1

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = _wrapper_counts()
        with torch.cuda.graph(graph, pool=self.pool.get()):
            self.fn()
        after = _wrapper_counts()
        self.recorded = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        _RECORDED.update(self.recorded)
        self.graph = graph
        self.captures += 1


# ---------------------------------------------------------------------------
# trees of static buffers
# ---------------------------------------------------------------------------


def paired_leaves(dst, src) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``(dst_leaf, src_leaf)`` pairs of two trees of one structure,
    matched by key (not by dict order); raises if the structures differ."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(dst) != set(src):
            raise ValueError("the trees' keys differ")
        return [p for k in dst for p in paired_leaves(dst[k], src[k])]
    if isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(dst) != len(src):
            raise ValueError("the trees' lengths differ")
        return [p for a, b in zip(dst, src) for p in paired_leaves(a, b)]
    if dst is None or src is None:
        if dst is not src:
            raise ValueError("a leaf is None in one tree only")
        return []
    return [(dst, src)]


def copy_tree_(dst, src) -> None:
    """Copy every leaf of ``src`` into ``dst`` (same structure) with one
    multi-tensor copy."""
    pairs = paired_leaves(dst, src)
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def tree_signature(tree) -> Any:
    """Hashable structure of a tree: keys (sorted), shapes, dtypes and
    devices of its leaves."""
    if isinstance(tree, dict):
        return tuple((k, tree_signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(tree_signature(v) for v in tree)
    if tree is None:
        return None
    return (tuple(tree.shape), tree.dtype, str(tree.device))


def static_clone(tree):
    """Static buffers shaped like ``tree`` (``None`` leaves stay None)."""
    return tree_map(lambda t: None if t is None else torch.empty_like(
        t, memory_format=torch.contiguous_format), tree)


class StaticTrainState:
    """A network's trainable state as static device buffers: ``params``,
    ``updater_state``, ``net_state``, the iteration ``it`` (int32) and the
    host LR scale ``lr`` (float32). ``load`` copies the network's live
    state in, ``store`` copies it back.

    ``key_order`` gives the top-level order of the trees an eager step
    returns (the updater's layer order for params and updater state, the
    forward's for net state); the static trees, and so the trees
    ``store`` gives back, keep that order, so that a network reads the
    same after a fused run as after eager steps."""

    def __init__(self, net, key_order: Tuple[List[str], List[str]]):
        self.param_keys, self.state_keys = key_order
        self.params = static_clone(_ordered(net.params, self.param_keys))
        self.updater_state = static_clone(
            _ordered(net.updater_state, self.param_keys))
        self.net_state = static_clone(_ordered(net.net_state,
                                               self.state_keys))
        self.it = torch.zeros((), dtype=torch.int32, device=net.device)
        self.lr = torch.ones((), dtype=torch.float32, device=net.device)

    def load(self, net) -> None:
        copy_tree_(self.params, net.params)
        copy_tree_(self.updater_state, net.updater_state)
        copy_tree_(self.net_state, net.net_state)
        self.it.fill_(net.iteration_count)
        self.lr.fill_(net._lr_scale_host)

    def store(self, net) -> None:
        """Give the network fresh tensors holding the static state: the
        live ones may share memory with arrays the caller holds (a
        ``set_flat_params`` vector), which an eager step never writes."""
        net.params = fresh_copy(self.params)
        net.updater_state = fresh_copy(self.updater_state)
        net.net_state = fresh_copy(self.net_state)

    def commit(self, params, updater_state, net_state) -> None:
        """Inside a step: write its results into the static buffers."""
        copy_tree_(self.params, params)
        copy_tree_(self.updater_state, updater_state)
        copy_tree_(self.net_state, net_state)
        self.it.add_(1)


def fresh_copy(tree):
    """New tensors holding ``tree``'s values (one multi-tensor copy)."""
    out = static_clone(tree)
    copy_tree_(out, tree)
    return out


def _ordered(tree, keys: List[str]):
    """A dict's top level in ``keys`` order (same entries)."""
    if not isinstance(tree, dict) or set(tree) != set(keys):
        return tree
    return {k: tree[k] for k in keys}
