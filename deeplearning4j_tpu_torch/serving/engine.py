"""Batched decode engine: the prefill and decode steps behind the server.

Port of ``deeplearning4j_tpu/serving/engine.py``:

- ``prefill`` — one bucket-padded prompt forward ([1, P]) through the
  same ``TransformerLM._block`` math as ``generate`` (so its attention is
  the flash kernel under ``attn_impl="flash"``), writing the per-layer K/V
  into one slot of the pool and sampling the request's first token from
  position ``prompt_len - 1``.
- ``decode`` — ONE step for ALL S slots at their own positions: write the
  consumed tokens' K/V at each slot's cursor, attend each row against its
  own masked cache history (plain grouped-query attention; the pool
  stores ``num_kv_heads``), sample one token per row.
- ``decode_fused`` — K decode steps per dispatch as a Python loop of the
  single-step body: cursors advance on the card, slots whose ``remaining``
  count runs out freeze (their token and cursor carry unchanged), and the
  host reads back one ``[K, S]`` token block.

PyTorch runs eagerly, so the reference's per-signature program cache is a
plain counter of the distinct shapes served (``program_builds``,
``compile_counts``): one decode shape per slot count (and K), one prefill
shape per prompt-ladder rung. Speculative decoding and ``mesh=`` are not
ported yet and raise ``NotImplementedError``.

Numerics contract: a slot's greedy stream equals ``TransformerLM.generate``
on the same prompt, and its sampled stream equals ``generate(seed=...)``
(each slot draws from its own ``torch.Generator`` seeded with the
request's seed, one draw per emitted token, as a batch-of-one generate
does).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.models.transformer import sample_logits
from deeplearning4j_tpu_torch.monitor import metrics
from deeplearning4j_tpu_torch.ops.attention import grouped_query_attention
from deeplearning4j_tpu_torch.perf.bucketing import (
    DEFAULT_PROMPT_BUCKETS, pad_prompt, prompt_bucket)
from deeplearning4j_tpu_torch.serving.kv_cache import (
    SlotKVCache, dequant_slab, requant_write_slab)

__all__ = ["DecodeEngine"]

Generators = Sequence[Optional[torch.Generator]]


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name the same card when one has no index."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _row_sampler(temperature: float, top_k: Optional[int]):
    """``(logits [S, V], gens) -> tokens [S]``. Greedy rows take the
    argmax in one batched op; sampled rows draw one at a time from their
    own generator (a row without one — a free or frozen slot — takes the
    argmax, and nobody reads it)."""

    def sample(logits: torch.Tensor, gens: Generators) -> torch.Tensor:
        toks = torch.argmax(logits, dim=-1)
        if temperature == 0.0:
            return toks
        for i, gen in enumerate(gens):
            if gen is not None:
                toks[i] = sample_logits(logits[i:i + 1], temperature,
                                        top_k, gen)[0]
        return toks

    return sample


@torch.no_grad()
def _serve_prefill_impl(model, sample_row, cache: SlotKVCache,
                        prompt: torch.Tensor, prompt_len: int, slot: int,
                        gen: Optional[torch.Generator]) -> torch.Tensor:
    """Prefill one bucket-padded prompt ([1, P]) into pool slot ``slot``.

    Causality makes the pad tail inert: position ``i < prompt_len``
    attends keys ``0..i``, all real tokens, so the K/V at real positions
    and the hidden state at ``prompt_len - 1`` are the unpadded prefill's.
    Quantized pools reset the slot's per-(layer, head) scales to the
    prompt K/V absmax (pad positions masked out of the max)."""
    params = model.params
    cdt = model.policy.compute_dtype
    p = prompt.shape[1]
    h = model._embed(params, prompt)
    ks, vs = [], []
    for blk in params["blocks"]:
        h, kk, vv = model._block(blk, h)
        ks.append(kk.to(cdt))
        vs.append(vv.to(cdt))
    kcat = torch.stack(ks)[:, 0]             # [L, P, Hkv, Dh]
    vcat = torch.stack(vs)[:, 0]
    if cache.quantized:
        real = (torch.arange(p, device=prompt.device)
                < prompt_len)[None, :, None, None]

        def quant(cat, pool, scale):
            catf = cat.float()
            m = torch.where(real, catf.abs(), 0.0).amax(dim=(1, 3))  # [L, Hkv]
            denom = torch.where(m > 0, m, 1.0)
            pool[:, slot, :p] = torch.clamp(
                torch.round(catf / denom[:, None, :, None] * 127.0),
                -127, 127).to(torch.int8)
            scale[:, slot] = m

        quant(kcat, cache.k, cache.k_scale)
        quant(vcat, cache.v, cache.v_scale)
    else:
        cache.k[:, slot, :p] = kcat.to(cache.k.dtype)
        cache.v[:, slot, :p] = vcat.to(cache.v.dtype)
    h_last = h[0, prompt_len - 1]                          # [D]
    return sample_row(model._unembed(params, h_last[None]), [gen])[0]


@torch.no_grad()
def _decode_step_body(model, cache: SlotKVCache, tok: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """ONE decode forward for all S slots: consume ``tok[s]`` at
    ``positions[s]``, write its (re)quantized K/V there, attend keys
    ``<= positions[s]`` (window-clipped). Returns logits [S, V].

    Free and frozen slots ride along computing rows no one reads. A
    retired slot's cursor may sit one past the pool's end; its position
    is clamped for the table lookup and the write (the reference's
    gather clamps and its scatter drops), which lands garbage only in
    that free slot, beyond anything a later prefill lets it attend."""
    params = model.params
    cdt = model.policy.compute_dtype
    s = tok.shape[0]
    t_max = cache.max_len
    h = params["embed"][tok]                               # [S, D]
    if model.pos_encoding == "learned":
        table = params["pos"]
        h = h + table[positions.clamp(max=table.shape[0] - 1)]
    h = model.policy.cast_compute(h)[:, None, :]           # [S, 1, D]
    ar = torch.arange(t_max, device=tok.device)[None, :]
    live = ar <= positions[:, None]
    if model.attn_window is not None:
        live &= ar > positions[:, None] - model.attn_window
    write_at = positions.clamp(max=t_max - 1)[:, None]
    rows = torch.arange(s, device=tok.device)

    def cached_attention(li):
        def attn(q, kk, vv):
            ck, cks = requant_write_slab(
                cache.k[li], cache.k_scale[li] if cache.quantized else None,
                kk, rows, write_at)
            cv, cvs = requant_write_slab(
                cache.v[li], cache.v_scale[li] if cache.quantized else None,
                vv, rows, write_at)
            return grouped_query_attention(
                q, dequant_slab(ck, cks, cdt), dequant_slab(cv, cvs, cdt),
                mask=live)
        return attn

    for li, blk in enumerate(params["blocks"]):
        h, _, _ = model._block(blk, h, attention=cached_attention(li),
                               positions=positions[:, None])
    return model._unembed(params, h[:, 0])                 # [S, V]


class DecodeEngine:
    """Owns the slot pool and the prefill/decode steps.

    ``device=None`` means the card (``"cuda"``); it must be where the
    model lives, so a CPU model is served only with ``device="cpu"``.
    ``temperature``/``top_k`` are server-level; per-request randomness
    rides in per-slot ``torch.Generator``s passed by the caller."""

    def __init__(self, model, slots: int, *,
                 max_len: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 kv_dtype: Optional[str] = None,
                 draft_model=None, draft_layers: int = 0,
                 spec_tokens: int = 3, mesh=None, device=None):
        if temperature < 0.0:
            raise ValueError(f"temperature={temperature} must be >= 0")
        if top_k is not None and not 1 <= top_k <= model.vocab_size:
            raise ValueError(
                f"top_k={top_k} must be in [1, vocab={model.vocab_size}]")
        if draft_model is not None or draft_layers:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP)")
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh=) is not ported yet (ROADMAP)")
        self.device = resolve_device(device)
        if not _same_device(self.device, model.device):
            raise ValueError(
                f"the engine runs on {self.device} but the model lives on "
                f"{model.device}; pass device={str(model.device)!r}")
        model._ensure_init()
        self.model = model
        self.cache = SlotKVCache(model, slots, max_len, kv_dtype)
        self.slots = self.cache.slots
        self.max_len = self.cache.max_len
        self.kv_dtype = self.cache.kv_dtype
        self.temperature = float(temperature)
        self.top_k = top_k
        self.buckets = tuple(b for b in (buckets or DEFAULT_PROMPT_BUCKETS)
                             if b <= self.max_len) or (self.max_len,)
        self._sample_row = _row_sampler(self.temperature, top_k)
        self._signatures: set = set()
        self.program_builds = 0

    # ------------------------------------------------------------------
    def _program(self, sig: tuple) -> None:
        """Count each distinct (kind, shape) signature once."""
        if sig not in self._signatures:
            self._signatures.add(sig)
            self.program_builds += 1
            metrics().counter("serve_program_builds_total").inc(kind=sig[0])

    def compile_counts(self) -> dict:
        """``{decode, prefill_buckets, total}``: the distinct decode and
        prefill shapes this engine has served."""
        pre = sorted(s[1] for s in self._signatures if s[0] == "prefill")
        return {"decode": sum(1 for s in self._signatures
                              if s[0].startswith("decode")),
                "prefill_buckets": pre,
                "total": self.program_builds}

    def cursor_of(self, slot: int) -> int:
        """Host readback of one slot's cursor (never in the decode loop)."""
        return int(self.cache.cursors[slot])

    def prompt_bucket(self, n: int) -> int:
        return prompt_bucket(n, self.buckets, max_len=self.max_len)

    # ------------------------------------------------------------------
    def prefill(self, prompt, slot: int,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Admit one prompt ([t] int) into ``slot``: bucket-pad, run the
        prefill, start the cursor at ``prompt_len``. Returns the first
        token (a device scalar)."""
        prompt = np.asarray(prompt, np.int64)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be [t] (got {prompt.shape})")
        bucket = self.prompt_bucket(int(prompt.shape[0]))
        padded, plen = pad_prompt(prompt, bucket)
        self._program(("prefill", bucket))
        tok = _serve_prefill_impl(
            self.model, self._sample_row, self.cache,
            torch.as_tensor(padded, device=self.device)[None], plen, slot,
            gen)
        self.cache.set_cursor(slot, plen)
        return tok

    def _tokens(self, tok) -> torch.Tensor:
        return torch.as_tensor(tok, device=self.device).long()

    def decode(self, tok, positions, gens: Generators) -> torch.Tensor:
        """One batched step: ``tok``/``positions`` [S], ``gens`` one
        generator (or None) per slot. Returns next tokens [S] (device);
        the pool advances in place and the CALLER advances the cursors."""
        self._program(("decode", self.slots))
        logits = _decode_step_body(self.model, self.cache, self._tokens(tok),
                                   self._tokens(positions))
        return self._sample_row(logits, gens)

    def decode_fused(self, tok, remaining, gens: Generators,
                     k_steps: int) -> torch.Tensor:
        """K decode steps per dispatch; returns the ``[K, S]`` token block
        (device). Slot ``s`` is active for its first ``remaining[s]`` steps
        and frozen after (token and cursor carry unchanged); once every
        slot is frozen the remaining rows repeat the last tokens. Pool and
        cursors advance in place."""
        self._program(("decode_fused", self.slots, k_steps))
        tok = self._tokens(tok)
        cursors = self.cache.cursors
        rem = np.asarray(remaining)
        out: List[torch.Tensor] = []
        for j in range(k_steps):
            act_host = rem > j
            if not act_host.any():
                out.extend([tok] * (k_steps - j))
                break
            act = torch.as_tensor(act_host, device=self.device)
            logits = _decode_step_body(self.model, self.cache, tok, cursors)
            ntok = self._sample_row(
                logits, [g if a else None for g, a in zip(gens, act_host)])
            tok = torch.where(act, ntok, tok)
            cursors = torch.where(act, cursors + 1, cursors)
            out.append(tok)
        self.cache.cursors = cursors
        return torch.stack(out)

    def decode_spec(self, *args, **kwargs):
        raise NotImplementedError(
            "speculative decoding is not ported yet (ROADMAP)")
