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
- ``decode_spec`` — speculative decoding: K rounds per dispatch, each
  drafting G tokens with the draft model (its own slot pool, positions
  derived from the shared cursors), verifying all G+1 candidates with ONE
  multi-token target forward (``_serve_verify_impl``), then accepting or
  resampling per the standard speculative-sampling rule. Each round emits
  ``accepted + 1`` tokens per slot; the host reads back one
  ``[K, S, G+2]`` block (``[count, tokens...]`` per round and slot).

PyTorch runs eagerly, so the reference's per-signature program cache is a
plain counter of the distinct shapes served (``program_builds``,
``compile_counts``): one decode shape per slot count (and K), one prefill
shape per prompt-ladder rung and pool. The port's only compiled artifacts
are the kernel libraries; ``DL4J_COMPILE_CACHE_DIR`` points their build
directory at a shared cache (``serving/compile_cache.py``).

``mesh=`` serves tensor-parallel: the model's params are placed over the
mesh's ``model`` axis (``TransformerLM.shard_params``, the split training
uses), the slot pool splits its heads to match (``SlotKVCache(registry=)``)
and every rank runs the same prefill and decode steps on its heads, in
step with the others: the caller drives every rank alike
(``DecodeServer(mesh=)`` does, rank 0 deciding).

Numerics contract: a slot's greedy stream equals ``TransformerLM.generate``
on the same prompt (speculative or not), and its sampled stream equals
``generate(seed=...)`` without a draft (each slot draws from its own
``torch.Generator`` seeded with the request's seed, one draw per emitted
token, as a batch-of-one generate does). Sampled speculative streams draw
from the target's filtered distribution; their draws per round and live
slot, in the reference's order, are one Gumbel vector per draft step
(from the slot's draft generator), then ``G`` uniforms and one Gumbel
vector for the correction (from the slot's generator). A categorical draw
is ``argmax(logits + gumbel)``, as ``jax.random.categorical`` computes it,
so the private ``_draws=`` seam of :meth:`DecodeEngine.decode_spec` takes
the same draws the reference's key chain gives.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.models.transformer import (
    filter_logits, sample_logits)
from deeplearning4j_tpu_torch.monitor import metrics
from deeplearning4j_tpu_torch.perf.bucketing import (
    DEFAULT_PROMPT_BUCKETS, pad_prompt, prompt_bucket)
from deeplearning4j_tpu_torch.serving.compile_cache import (
    ensure_compile_cache)
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


def _gumbel(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` standard Gumbel draws from ``gen``: ``-log(-log(u))`` with
    ``u`` uniform on ``[tiny, 1)``, as ``jax.random.gumbel`` draws them."""
    u = torch.rand(n, generator=gen, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def _serve_prefill_impl(model, cache: SlotKVCache, prompt: torch.Tensor,
                        prompt_len: int, slot: int) -> torch.Tensor:
    """Prefill one bucket-padded prompt ([1, P]) into pool slot ``slot``.

    Causality makes the pad tail inert: position ``i < prompt_len``
    attends keys ``0..i``, all real tokens, so the K/V at real positions
    and the hidden state at ``prompt_len - 1`` are the unpadded prefill's.
    Quantized pools reset the slot's per-(layer, head) scales to the
    prompt K/V absmax (pad positions masked out of the max). Returns the
    logits ``[1, V]`` at ``prompt_len - 1``; the caller samples."""
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
    return model._unembed(params, h_last[None])            # [1, V]


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
            return model._attend(
                q, dequant_slab(ck, cks, cdt), dequant_slab(cv, cvs, cdt),
                mask=live)
        return attn

    for li, blk in enumerate(params["blocks"]):
        h, _, _ = model._block(blk, h, attention=cached_attention(li),
                               positions=positions[:, None])
    return model._unembed(params, h[:, 0])                 # [S, V]


@torch.no_grad()
def _serve_verify_impl(model, cache: SlotKVCache, toks: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """Multi-token target forward for the speculative verify: consume
    ``toks [S, Q]`` at per-row ``positions [S, Q]`` against the slot pool,
    writing every candidate's K/V at its position (the accepted prefix
    becomes permanent; rejected tails sit beyond the rewound cursor,
    masked until overwritten). Query q attends pool keys
    ``<= positions[s, q]``. Returns logits ``[S, Q, V]``.

    A frozen or free slot's positions may run past the pool's end; they
    are clamped for the table lookup and the write, as in
    :func:`_decode_step_body`, landing garbage only in slots nobody
    reads."""
    params = model.params
    cdt = model.policy.compute_dtype
    s = toks.shape[0]
    t_max = cache.max_len
    h = params["embed"][toks]                              # [S, Q, D]
    if model.pos_encoding == "learned":
        table = params["pos"]
        h = h + table[positions.clamp(max=table.shape[0] - 1)]
    h = model.policy.cast_compute(h)
    ar = torch.arange(t_max, device=toks.device)[None, None, :]
    live = ar <= positions[:, :, None]                     # [S, Q, T]
    if model.attn_window is not None:
        live &= ar > positions[:, :, None] - model.attn_window
    write_at = positions.clamp(max=t_max - 1)
    rows = torch.arange(s, device=toks.device)

    def cached_attention(li):
        def attn(q, kk, vv):
            ck, cks = requant_write_slab(
                cache.k[li], cache.k_scale[li] if cache.quantized else None,
                kk, rows, write_at)
            cv, cvs = requant_write_slab(
                cache.v[li], cache.v_scale[li] if cache.quantized else None,
                vv, rows, write_at)
            return model._attend(
                q, dequant_slab(ck, cks, cdt), dequant_slab(cv, cvs, cdt),
                mask=live)
        return attn

    for li, blk in enumerate(params["blocks"]):
        h, _, _ = model._block(blk, h, attention=cached_attention(li),
                               positions=positions)
    return model._unembed(params, h)                       # [S, Q, V]


def _row_noise(rows: Dict[int, torch.Tensor], s: int, v: int,
               device) -> torch.Tensor:
    """``[S, V]`` noise with the given slots' rows filled, zeros
    elsewhere (slots that draw nothing)."""
    out = torch.zeros(s, v, device=device)
    for slot, row in rows.items():
        out[slot] = row
    return out


@torch.no_grad()
def _serve_spec_impl(engine, k_rounds: int, tok: torch.Tensor,
                     remaining: np.ndarray, gens: Generators,
                     draft_gens: Generators, draws) -> torch.Tensor:
    """K speculative rounds. Per round and slot:

    1. **draft** — ``G + 1`` draft-model steps from the shared cursors
       (step j consumes candidate j - 1), proposing ``d_1..d_G`` and
       writing every candidate's draft K/V, so the draft pool covers the
       accepted prefix whatever it turns out to be (the last step writes
       ``d_G``'s K/V; its proposal is discarded).
    2. **verify** — ONE target forward over ``[tok, d_1..d_G]`` at
       positions ``c..c+G`` (:func:`_serve_verify_impl`).
    3. **accept/resample** — greedy: accept the longest prefix where the
       target's argmax equals the proposal, then emit the target's own
       next token. Sampled: accept ``d_i`` when ``u·q(d_i) < p(d_i)``; on
       the first rejection resample from ``norm(max(p − q, 0))``; after
       full acceptance draw the bonus token from ``p``.

    Cursors advance by ``accepted + 1``; the draft pool needs no cursor of
    its own. Slots live at the dispatch's start (``remaining > 0`` on the
    host) draw their random numbers; a slot whose ``remaining`` runs out
    mid-dispatch freezes (count 0, token and cursor carried) and keeps
    drawing into a generator nobody reads again. ``draws`` (the private
    seam) replaces the generators with explicit draws: ``draft``
    ``[K, G+1, S, V]`` and ``correction`` ``[K, S, V]`` Gumbel noise and
    ``uniform`` ``[K, S, G]``. Returns the ``[K, S, G + 2]`` block."""
    model, draft = engine.model, engine.draft_model
    cache, dcache = engine.cache, engine.draft_cache
    gamma = engine.spec_tokens
    greedy = engine.temperature == 0.0

    def filt(logits):
        # the distribution the sampled paths draw from, shared by the
        # draft's proposal and the accept ratio, so that q(d) is exactly
        # the probability the draft sampled d with
        return filter_logits(logits, engine.temperature, engine.top_k)
    dev = tok.device
    s = tok.shape[0]
    vocab = model.vocab_size
    live = [i for i in range(s) if remaining[i] > 0]
    rem = torch.as_tensor(remaining, device=dev)
    cursors = cache.cursors
    steps = torch.arange(gamma + 1, device=dev)
    blocks = []
    for r in range(k_rounds):
        act = rem > 0
        # ---- draft: propose gamma candidates, write gamma + 1 K/V
        dtok, props, qs = tok, [], []
        for i in range(gamma + 1):
            logits = _decode_step_body(draft, dcache, dtok, cursors + i)
            if greedy:
                dtok = torch.argmax(logits, dim=-1)
            else:
                scaled = filt(logits)
                qs.append(torch.softmax(scaled, dim=-1))
                noise = (draws["draft"][r, i] if draws is not None
                         else _row_noise(
                             {j: _gumbel(vocab, draft_gens[j], dev)
                              for j in live}, s, vocab, dev))
                dtok = torch.argmax(scaled + noise, dim=-1)
            props.append(dtok)
        d = torch.stack(props[:gamma], dim=1)              # [S, G]

        # ---- verify: one multi-token target forward over tok + d
        vtoks = torch.cat([tok[:, None], d], dim=1)        # [S, G+1]
        logits = _serve_verify_impl(model, cache, vtoks,
                                    cursors[:, None] + steps[None, :])

        # ---- accept / resample
        if greedy:
            t = torch.argmax(logits, dim=-1)               # [S, G+1]
            accept = t[:, :gamma] == d
            a = torch.cumprod(accept.long(), dim=1).sum(dim=1)
            corr = t.gather(1, a[:, None])[:, 0]
        else:
            p = torch.softmax(filt(logits), dim=-1)        # [S, G+1, V]
            q = torch.stack(qs[:gamma], dim=1)             # [S, G, V]
            p_d = p[:, :gamma].gather(-1, d[..., None])[..., 0]
            q_d = q.gather(-1, d[..., None])[..., 0]
            if draws is not None:
                us, cnoise = draws["uniform"][r], draws["correction"][r]
            else:
                us = torch.zeros(s, gamma, device=dev)
                for j in live:
                    us[j] = torch.rand(gamma, generator=gens[j], device=dev)
                cnoise = _row_noise({j: _gumbel(vocab, gens[j], dev)
                                     for j in live}, s, vocab, dev)
            # u < min(1, p/q)  <=>  u*q < p  (q = 0 proposals never drawn)
            accept = us * q_d < p_d
            a = torch.cumprod(accept.long(), dim=1).sum(dim=1)
            idx = a[:, None, None].expand(s, 1, vocab)
            p_a = p.gather(1, idx)[:, 0]                    # [S, V]
            q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
            q_a = q_pad.gather(1, idx)[:, 0]
            res = torch.clamp(p_a - q_a, min=0.0)
            has_res = res.sum(dim=-1, keepdim=True) > 0
            res = torch.where(has_res, res, p_a)
            corr = torch.argmax(torch.log(torch.clamp(res, min=1e-38))
                                + cnoise, dim=-1)

        count = torch.where(act, a + 1, 0)
        col = steps[None, :]
        d_pad = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
        emit = torch.where(col < a[:, None], d_pad,
                           torch.where(col == a[:, None], corr[:, None], 0))
        blocks.append(torch.cat([count[:, None], emit], dim=1))
        tok = torch.where(act, corr, tok)
        cursors = torch.where(act, cursors + count, cursors)
        rem = torch.where(act, torch.clamp(rem - count, min=0), rem)
    cache.cursors = cursors
    return torch.stack(blocks)                             # [K, S, G+2]


def _placed(model, mesh):
    """The registry of ``model``'s params on ``mesh``, placing them
    (``shard_params``) unless they already are."""
    if model._registry is None:
        model.shard_params(mesh)
    elif model._registry.mesh is not mesh:
        raise ValueError("the model's params are placed on another mesh")
    return model._registry


class DecodeEngine:
    """Owns the slot pool(s) and the prefill/decode steps.

    ``device=None`` means the card (``"cuda"``); it must be where the
    model lives, so a CPU model is served only with ``device="cpu"``.
    ``temperature``/``top_k`` are server-level; per-request randomness
    rides in per-slot ``torch.Generator``s passed by the caller.

    Speculative decoding: ``draft_layers=n`` drafts with the target's
    first n blocks and its embedding, final norm and unembedding (no extra
    parameters: the draft's tensors ARE the target's), ``draft_model=``
    with an independently trained ``TransformerLM`` of the same vocab.
    Either gets a second slot pool for the draft's K/V."""

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
        self.device = resolve_device(device)
        if not _same_device(self.device, model.device):
            raise ValueError(
                f"the engine runs on {self.device} but the model lives on "
                f"{model.device}; pass device={str(model.device)!r}")
        model._ensure_init()
        self.model = model
        self.mesh = mesh
        self.registry = None if mesh is None else _placed(model, mesh)
        self.cache = SlotKVCache(model, slots, max_len, kv_dtype,
                                 registry=self.registry)
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

        # ---- speculative-decoding configuration
        if draft_model is not None and draft_layers:
            raise ValueError(
                "pass draft_model= OR draft_layers=, not both")
        self.spec_tokens = int(spec_tokens)
        if self.spec_tokens < 1:
            raise ValueError(f"spec_tokens={spec_tokens} must be >= 1")
        self.draft_model = None
        if draft_layers:
            if not 1 <= draft_layers <= model.num_layers:
                raise ValueError(
                    f"draft_layers={draft_layers} must be in "
                    f"[1, num_layers={model.num_layers}]")
            self.draft_model = self._shallow_draft(model, draft_layers)
        elif draft_model is not None:
            draft_model._ensure_init()
            if draft_model.vocab_size != model.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_model.vocab_size} != target "
                    f"vocab {model.vocab_size}")
            if not _same_device(self.device, draft_model.device):
                raise ValueError(
                    f"the draft model lives on {draft_model.device}, the "
                    f"engine on {self.device}")
            self.draft_model = draft_model
        self.draft_cache = None
        if self.draft_model is not None:
            # an independent draft gets its own placement (its own layer
            # count and head split); the shallow draft's tensors are the
            # target's shards, so the target's registry prices its pool
            draft_reg = self.registry
            if mesh is not None and draft_model is not None:
                draft_reg = _placed(draft_model, mesh)
            # same slot count and positions as the target pool (the
            # constructor re-checks the draft's own position table)
            self.draft_cache = SlotKVCache(self.draft_model, self.slots,
                                           self.max_len, kv_dtype,
                                           registry=draft_reg)
        # a cold replica loads the kernel libraries from the shared cache
        # directory (DL4J_COMPILE_CACHE_DIR) instead of running nvcc
        ensure_compile_cache()

    @property
    def spec(self) -> bool:
        return self.draft_model is not None

    @staticmethod
    def _shallow_draft(model, n: int):
        """Self-draft by layer truncation: the target's first ``n`` blocks
        and its embedding, positions, final norm and unembedding. The
        draft's parameter tensors are the target's own (no copy)."""
        from deeplearning4j_tpu_torch.models.transformer import (
            TransformerLM)

        cfg = dict(model.get_config())
        cfg["num_layers"] = n
        draft = TransformerLM(**cfg, device=model.device)
        draft.params = {k: v for k, v in model.params.items()
                        if k != "blocks"}
        draft.params["blocks"] = model.params["blocks"][:n]
        draft._tp, draft._registry = model._tp, model._registry
        return draft

    # ------------------------------------------------------------------
    def _program(self, sig: tuple) -> None:
        """Count each distinct (kind, shape) signature once."""
        if sig not in self._signatures:
            self._signatures.add(sig)
            self.program_builds += 1
            metrics().counter("serve_program_builds_total").inc(kind=sig[0])

    def compile_counts(self) -> dict:
        """``{decode, prefill_buckets, total}``: the distinct decode
        (plain, fused, speculative) and prefill (target and draft) shapes
        this engine has served."""
        pre = sorted(s[1] for s in self._signatures
                     if s[0].startswith("prefill"))
        return {"decode": sum(1 for s in self._signatures
                              if s[0].startswith("decode")),
                "prefill_buckets": pre,
                "total": self.program_builds}

    def cursor_of(self, slot: int) -> int:
        """Host readback of one slot's cursor: only at migration
        boundaries, never in the decode loop."""
        return int(self.cache.cursors[slot])

    def prompt_bucket(self, n: int) -> int:
        return prompt_bucket(n, self.buckets, max_len=self.max_len)

    # ------------------------------------------------------------------
    def prefill(self, prompt, slot: int,
                gen: Optional[torch.Generator] = None, *,
                replay: int = 0) -> torch.Tensor:
        """Admit one prompt ([t] int) into ``slot``: bucket-pad, run the
        prefill (and the draft pool's, when speculative), start the cursor
        at ``prompt_len``. Returns the first token (a device scalar),
        sampled from the target's logits with ``gen``.

        ``replay`` > 0 (a greedy failover continuation): the last
        ``replay`` prompt tokens were emitted by the stream before its
        replica died. Only the prompt before them is prefilled; they are
        then consumed one at a time by the decode step at the positions
        the stream consumed them at, so the slot's K/V and the next token
        are the unfailed stream's bit for bit (a prefill over them would
        round differently under bf16 and could flip a later token)."""
        prompt = np.asarray(prompt, np.int64)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be [t] (got {prompt.shape})")
        if not 0 <= replay < prompt.shape[0]:
            raise ValueError(f"replay={replay} must be in [0, prompt "
                             f"length {prompt.shape[0]})")
        head = prompt[:prompt.shape[0] - replay]
        bucket = self.prompt_bucket(int(head.shape[0]))
        padded, plen = pad_prompt(head, bucket)
        padded = torch.as_tensor(padded, device=self.device)[None]
        self._program(("prefill", bucket))
        logits = _serve_prefill_impl(self.model, self.cache, padded, plen,
                                     slot)
        if self.spec:
            # the draft pool needs the prompt's K/V too; the served first
            # token is the target's
            self._program(("prefill_draft", bucket))
            _serve_prefill_impl(self.draft_model, self.draft_cache, padded,
                                plen, slot)
        self.cache.set_cursor(slot, plen)
        for pos, tok in enumerate(prompt[head.shape[0]:], start=plen):
            tok = torch.tensor([tok], device=self.device)
            at = torch.tensor([pos], device=self.device)
            logits = _decode_step_body(self.model,
                                       self.cache.slot_view(slot), tok, at)
            if self.spec:
                _decode_step_body(self.draft_model,
                                  self.draft_cache.slot_view(slot), tok, at)
            self.cache.set_cursor(slot, pos + 1)
        return self._sample_row(logits, [gen])[0]

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

    def decode_spec(self, tok, remaining, gens: Generators,
                    draft_gens: Generators, k_rounds: int, *,
                    _draws: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
        """K speculative rounds per dispatch: returns the
        ``[K, S, spec_tokens + 2]`` block (device; per round and slot
        ``[count, tokens...]``). Both pools and the cursors advance in
        place; the generators advance as they draw. ``_draws`` replaces
        the generators with explicit draws (see
        :func:`_serve_spec_impl`)."""
        if not self.spec:
            raise ValueError("decode_spec needs a draft (draft_layers= or "
                             "draft_model=)")
        self._program(("decode_spec", self.slots, k_rounds,
                       self.spec_tokens))
        return _serve_spec_impl(self, k_rounds, self._tokens(tok),
                                np.asarray(remaining), gens, draft_gens,
                                _draws)
