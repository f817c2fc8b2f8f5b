"""Slot handoff: move one request's KV state between replicas.

Port of ``deeplearning4j_tpu/serving/fleet/handoff.py``. A ``prefill``
replica computes a prompt's K/V into a scratch slot and exports the slot
as a host-resident :class:`SlotHandoff` (``(kv_slab, cursor, key)`` and
the first sampled token); a ``decode`` replica installs it into a free
slot of its own pool and streams the rest. The export is one gather and
a copy to the host, the install one copy back and a scatter into the
pool (``_slot_export_impl``/``_slot_import_impl``); both run once per
request, never in the decode loop.

The key is the slot generator's state (``torch.Generator.get_state()``),
or None for a greedy server. A generator's state is only meaningful on
the device type it came from (a CUDA generator's state cannot be set on a
CPU one), so a handoff installs only on a replica of the same device
type. Handoffs move between replicas of the port; exchange with the JAX
package's replicas is not a goal (its keys are ``jax.random`` keys).

Numerics: the installed slab is bit-identical to what a local prefill of
the same prompt would have written (the round trip is a pure gather and
scatter), so a handed-off stream is token-identical to a locally served
one, greedy and sampled.

Tensor-parallel pools (``DecodeServer(mesh=)``): the wire format is the
whole slot on every layout, k/v ``[L, T, Hkv, Dh]`` and int8 scales
``[L, Hkv]``. A pool whose heads are split over ``model`` exports by
gathering the ranks' heads over the ``model`` group in rank order (a
concatenation, no sum), so the slab holds the bytes an unsharded prefill
writes; every rank of the group exports together and each gets the whole
slab. An install writes the rank's own heads, ``Hkv / model`` of them
from ``head_offset``. A pool the GQA fallback replicates holds every head
in every rank and moves whole. So slabs travel between one-device and
tensor-parallel replicas in either direction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["SlotHandoff", "export_slot", "export_live_slot",
           "install_slot", "make_install"]


def _pool_state(cache) -> Dict[str, torch.Tensor]:
    """The pool's tensors by the reference's names: ``k``/``v``
    ``[L, S, T, Hkv, Dh]`` and, for int8 pools, ``k_scale``/``v_scale``
    ``[L, S, Hkv]``."""
    state = {"k": cache.k, "v": cache.v}
    if cache.quantized:
        state.update(k_scale=cache.k_scale, v_scale=cache.v_scale)
    return state


@torch.no_grad()
def _slot_export_impl(state: Dict[str, torch.Tensor],
                      slot: int) -> Dict[str, torch.Tensor]:
    """Gather one slot's K/V (and int8 scale rows) out of the pool:
    ``[L, S, T, Hkv, Dh]`` pools yield ``[L, T, Hkv, Dh]`` slabs and
    ``[L, S, Hkv]`` scales ``[L, Hkv]`` rows."""
    return {name: pool[:, slot] for name, pool in state.items()}


def _head_axis(slab) -> int:
    """The head axis of a slab: ``[L, T, Hkv, Dh]`` k/v, ``[L, Hkv]``
    scales."""
    return 2 if slab.ndim == 4 else 1


@torch.no_grad()
def _gather_heads(cache, slabs: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Every rank's heads of one slot's slabs, in rank order along the
    head axis (a collective over the ``model`` group). Each slab travels
    as its raw bytes (gloo carries neither bf16 nor int16), its last
    axis widened by the element size, which leaves the head axis's
    order as it was."""
    from deeplearning4j_tpu_torch.parallel.collectives import all_gather
    from deeplearning4j_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group

    group = axis_group(cache.registry.mesh, MODEL_AXIS)
    return {name: all_gather(slab.contiguous().view(torch.uint8), group,
                             _head_axis(slab)).view(slab.dtype)
            for name, slab in slabs.items()}


@torch.no_grad()
def _slot_import_impl(state: Dict[str, torch.Tensor],
                      slabs: Dict[str, torch.Tensor], slot: int) -> None:
    """Scatter a handed-off slab into pool slot ``slot`` in place (the
    inverse of :func:`_slot_export_impl`); every other slot carries
    unchanged."""
    for name, pool in state.items():
        pool[:, slot] = slabs[name].to(pool.dtype)


@dataclass
class SlotHandoff:
    """One prefilled request's portable decode state: the host-side
    ``(kv_slab, cursor, key)`` package a prefill replica ships to a decode
    replica's free slot, the first token (sampled at prefill, so TTFT is
    stamped there) and the fields the install checks against the target
    pool."""

    # the whole slot, every head, whatever the pool's layout:
    # k/v [L, T, Hkv, Dh] (+ *_scale [L, Hkv])
    slabs: Dict[str, np.ndarray]
    # next write position: prompt_len for a prefill handoff,
    # prompt_len + emitted for a drain-time mid-stream migration
    cursor: int
    # the slot generator's state mid-stream (uint8), None when greedy
    key: Optional[np.ndarray]
    # the last token fed back into decode: the prefill's first sampled
    # token or, mid-stream, the newest token the source emitted
    first_token: int
    kv_dtype: str
    max_len: int
    # the device type of the pool and generator it left ("cuda", "cpu")
    device: str

    @property
    def nbytes(self) -> int:
        """Bytes of the slabs (the key's few bytes not counted): one
        slot of the whole pool, ``stats()["kv_per_slot_bytes"]``."""
        return int(sum(s.nbytes for s in self.slabs.values()))


def _host(t: torch.Tensor) -> np.ndarray:
    """A slab as host numpy of its own (never a view of the pool, which
    the next prefill overwrites); bf16, which numpy lacks, travels as its
    raw 16-bit patterns."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def export_slot(engine, slot: int) -> Dict[str, np.ndarray]:
    """Pull one slot's pool state to host numpy (the handoff's wire
    format): once per request at the prefill/decode boundary, never per
    token. On a pool split over ``model`` every rank calls it together
    (a gather) and each gets the whole slot."""
    engine._program(("handoff_export", engine.slots))
    slabs = _slot_export_impl(_pool_state(engine.cache), slot)
    if engine.cache.n_shard > 1:
        slabs = _gather_heads(engine.cache, slabs)
    return {name: _host(v) for name, v in slabs.items()}


def generator_key(gen: Optional[torch.Generator]) -> Optional[np.ndarray]:
    """A slot generator's state as the handoff's key (None: greedy)."""
    return None if gen is None else gen.get_state().numpy().copy()


def install_slot(engine, slot: int,
                 handoff: SlotHandoff) -> Optional[torch.Generator]:
    """Land a handoff in ``slot`` of ``engine``'s pool and start the
    cursor; returns the generator to continue the stream with (None for
    a greedy handoff). Checks pool compatibility first: a silent dtype,
    capacity, device or shape mismatch would decode garbage with no
    error (a slab of fewer heads would broadcast into every head of the
    slot). On a pool split over ``model`` the rank writes its own
    heads."""
    if handoff.kv_dtype != engine.kv_dtype:
        raise ValueError(
            f"handoff kv_dtype={handoff.kv_dtype!r} != target pool "
            f"{engine.kv_dtype!r}")
    if handoff.max_len != engine.max_len:
        raise ValueError(
            f"handoff max_len={handoff.max_len} != target pool "
            f"max_len={engine.max_len}")
    if handoff.device != engine.device.type:
        raise ValueError(
            f"handoff from a {handoff.device} replica cannot install on a "
            f"{engine.device.type} replica: its generator state belongs "
            "to the device type it came from")
    cache = engine.cache
    state = _pool_state(cache)
    if set(handoff.slabs) != set(state):
        raise ValueError(
            f"handoff slabs {sorted(handoff.slabs)} != the target pool's "
            f"{sorted(state)}")
    slabs = {}
    for name, slab in handoff.slabs.items():
        pool = state[name]
        local = pool.shape[:1] + pool.shape[2:]       # the slot axis out
        ax = 2 if len(local) == 4 else 1                # the heads
        want = tuple(local[:ax]) + (local[ax] * cache.n_shard,) \
            + tuple(local[ax + 1:])
        if tuple(slab.shape) != want:
            raise ValueError(
                f"handoff slab {name!r} has shape {tuple(slab.shape)}; the "
                f"target pool's slot is {want} (every head of the whole "
                "pool)")
        t = torch.from_numpy(np.ascontiguousarray(slab))
        if pool.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        if cache.n_shard > 1:
            t = t.narrow(ax, cache.head_offset, local[ax])
        slabs[name] = t.to(engine.device)
    engine._program(("handoff_import", engine.slots))
    _slot_import_impl(state, slabs, slot)
    engine.cache.set_cursor(slot, handoff.cursor)
    if handoff.key is None:
        return None
    gen = torch.Generator(device=engine.device)
    gen.set_state(torch.from_numpy(handoff.key.copy()))
    return gen


def export_live_slot(server, slot: int) -> SlotHandoff:
    """Package a RUNNING slot's whole decode state for migration (the
    graceful drain's counterpart of the prefill handoff): the slab covers
    every token decoded so far (cursor = prompt_len + emitted), the key is
    the slot generator's state mid-stream and ``first_token`` the newest
    emitted token, so installing it on a survivor continues the stream
    with no recompute and no lost token."""
    engine = server.engine
    return SlotHandoff(
        slabs=export_slot(engine, slot),
        cursor=engine.cursor_of(slot),
        key=generator_key(server._gens[slot]),
        first_token=int(server._last_tok[slot]),
        kv_dtype=engine.kv_dtype,
        max_len=engine.max_len,
        device=engine.device.type)


def make_install(handoff: SlotHandoff):
    """The ``install(engine, slot) -> (last_token, generator)`` callable
    ``DecodeServer.admit_external`` runs at the step boundary that claims
    a free slot."""

    def install(engine, slot):
        gen = install_slot(engine, slot, handoff)
        return handoff.first_token, gen

    return install
