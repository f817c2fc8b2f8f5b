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

    slabs: Dict[str, np.ndarray]   # k/v [L, T, Hkv, Dh] (+ *_scale [L, Hkv])
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
        """Bytes of the slabs (the key's few bytes not counted)."""
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
    token."""
    engine._program(("handoff_export", engine.slots))
    return {name: _host(v) for name, v in _slot_export_impl(
        _pool_state(engine.cache), slot).items()}


def generator_key(gen: Optional[torch.Generator]) -> Optional[np.ndarray]:
    """A slot generator's state as the handoff's key (None: greedy)."""
    return None if gen is None else gen.get_state().numpy().copy()


def install_slot(engine, slot: int,
                 handoff: SlotHandoff) -> Optional[torch.Generator]:
    """Land a handoff in ``slot`` of ``engine``'s pool and start the
    cursor; returns the generator to continue the stream with (None for
    a greedy handoff). Checks pool compatibility first: a silent dtype,
    capacity or device mismatch would decode garbage with no error."""
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
    state = _pool_state(engine.cache)
    slabs = {}
    for name, slab in handoff.slabs.items():
        t = torch.from_numpy(np.ascontiguousarray(slab))
        if state[name].dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
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
