"""Decoder-only transformer LM on PyTorch: port of
``deeplearning4j_tpu/models/transformer.py``.

Parameters are a nested dict of tensors with the reference's leaf names
(``embed``, ``pos``, ``ln_f``, ``blocks[i].{ln1, attn.{wq, wk, wv, wo},
ln2, mlp.{w1, b1, w2, b2}}``); weights are ``[in, out]`` and used as
``x @ W``. ``models/convert.params_from_jax`` loads the reference's
params, so the parity tests run both packages on the same weights.

Numerics follow the reference: layernorm statistics in f32 with the
result in the input dtype, tanh-approximated GELU, RoPE angles in f32,
and an unembedding whose compute-dtype operands multiply into an f32
result that is never rounded to bf16. Training sums it in f32, as the
reference does (``_unembed_train``); every other caller sums it in f64
and rounds once (``_unembed``), so that decode rows are batch-invariant.

Serving: ``forward``, ``generate`` (greedy and sampled) and its builder
``make_generate``, beam search (``generate_beam``, ``make_generate_beam``;
beams ride the batch dimension and ties rank as ``lax.top_k`` ranks them),
the per-signature decoder cache (``GEN_CACHE_MAX``, LRU) and the
``_prefill``/``_decode_token``/``_block`` pieces ``serving/`` builds on.
Training: ``loss``, the hand-written Adam step (``_step_body``,
``make_train_step``, ``make_multi_train_step``, ``fit_batch``,
``fit_batch_multi``) and ``evaluate_perplexity``; under ``train=True``
attention goes through the differentiable flash kernels (forward B1,
backward B2 and B3) whenever head_dim tiles. The step functions that
``make_train_step`` and ``make_multi_train_step`` return run K steps as
replays of one captured CUDA graph of the step (``perf/step_graph.py``),
B1–B3 launched inside it; the step counter and Adam's bias corrections
are device tensors, so the captured step is the eager one; the LM's
graphs share one memory pool. On the CPU the same step runs eagerly.

Over a device mesh (``mesh=``, ``parallel/mesh.py``), every rank is
given the same global ``[b, t]`` tokens and computes its part: rows
split over the ``data`` axis and, with ``sequence_parallel=True``,
positions over the ``sequence`` axis, each block's attention then being
ring attention (``sp_impl="ring"``; the flash ring runs B1 per hop
forward and B2 + B3 per hop backward) or Ulysses. The loss is each
rank's share of the global mean, the gradients are summed over the
mesh, and every rank applies the same Adam update. A mesh of one device
runs the meshless step itself (captured on the card); a mesh step with
collectives runs eagerly (gloo collectives cannot be captured; capturing
NCCL collectives is later speed work, ROADMAP B).

Tensor parallelism (``shard_params(mesh)``): each rank keeps its
Megatron shards (wq/wk/wv/w1 column-split, wo/w2 row-split over
``model``; the tied embedding, the norms and ``b2`` replicated) and its
part of the Adam moments. Training runs its blocks split: f
(``collectives.CopyToShardsFn``) before the q/k/v and w1 GEMMs, g after
wo and w2 (an all-reduce of f32 partials). ``forward``, ``generate``,
beam search and serving run attention and the KV cache on the rank's
heads and every projection whole, on weights gathered once, so that
their tokens are the unsharded model's (:class:`_TensorShards`).
With GQA heads that do not tile the axis, wk/wv stay replicated (their
gradients summed over ``model`` by f) and each rank attends with the
K/V heads its q heads use.
"""

from __future__ import annotations

import functools
import logging
import math
import os
import types
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch import dtypes as dtypes_mod
from deeplearning4j_tpu_torch.analysis.annotations import traced
from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.kernels.flash_attention import flash_attention
from deeplearning4j_tpu_torch.ops.attention import grouped_query_attention
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQUENCE_AXIS,
    axis_group,
    axis_rank,
    axis_size,
)
from deeplearning4j_tpu_torch.perf.step_graph import (
    GraphPool,
    StepGraph,
    copy_tree_,
    static_clone,
)

logger = logging.getLogger(__name__)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding on [b, t, h, d] at absolute
    ``positions``: [t] shared across the batch, or [b, t] per row. Angles
    in f32, result in x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions.to(torch.float32)[..., None] * freqs
    if positions.ndim == 1:       # [t, half] -> broadcast over batch
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5, exact: bool = False) -> torch.Tensor:
    """Statistics in >= f32 (population variance), result in x's dtype.

    ``exact``: statistics and normalisation in float64, rounded once to
    x's dtype, so that a row's result does not depend on how many rows
    the reduction kernels are given: PyTorch picks their f32 summation
    order from the shape, and on an H100 a d512 row normalised alone
    (``generate``'s decode) and beside seven others (the server's)
    rounded one bf16 element apart, which flipped a greedy token 21 steps
    later (``scripts/torch_serve_invariance.py``). Every path but
    training takes it."""
    st = (torch.float64 if exact
          else torch.promote_types(x.dtype, torch.float32))
    xs = x.to(st)
    mean = xs.mean(dim=-1, keepdim=True)
    var = xs.var(dim=-1, keepdim=True, unbiased=False)
    y = (xs - mean) * torch.rsqrt(var + eps)
    return (y * g.to(st) + b.to(st)).to(x.dtype)


def sample_logits(logits: torch.Tensor, temperature: float,
                  top_k: Optional[int],
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Next tokens ``[B]`` from ``logits [B, V]``: argmax when
    ``temperature == 0`` (first maximum on ties, as the reference),
    otherwise a draw from ``softmax(logits / temperature)`` filtered to
    ``top_k``. One ``torch.multinomial`` call per invocation, so a
    batch-of-one ``generate(seed=s)`` and a server slot seeded with ``s``
    consume the same random numbers."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature, top_k), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def filter_logits(logits: torch.Tensor, temperature: float,
                  top_k: Optional[int]) -> torch.Tensor:
    """``logits [..., V] / temperature`` in f32 with every entry below the
    ``top_k``-th largest set to -inf: the distribution every sampled path
    draws from (``sample_logits``, the speculative draft and its accept
    ratio)."""
    scaled = logits.float() / temperature
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled, -math.inf)
    return scaled


def top_k_first_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of the last
    axis, largest first, and among equal values the lower index first, as
    ``lax.top_k`` ranks them (``torch.topk`` promises no order for ties):
    a stable descending sort, cut to ``k``."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 matrices as f32: exact products, f32 sums. On
    the card one cuBLAS call on the tensor cores (``aten::mm.dtype``); on
    the CPU, which has no such kernel, the f32 product of the operands
    widened to f32 (the same function, summed in another order)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _UnembedBF16(torch.autograd.Function):
    """``h @ eᵀ`` for bf16 ``h [N, D]`` and ``e [V, D]``, with f32
    logits: the reference's ``dot_general(...,
    preferred_element_type=f32)``. ``mm.dtype`` has no derivative, so
    the backward is written here: the f32 upstream gradient is rounded to
    bf16, and both products are bf16 GEMMs with f32 output, rounded once
    to the operands' dtype."""

    @staticmethod
    def forward(ctx, h, e):
        ctx.save_for_backward(h, e)
        return _mm_bf16(h, e.t())

    @staticmethod
    def backward(ctx, g):
        h, e = ctx.saved_tensors
        g = g.to(h.dtype)
        dh = _mm_bf16(g, e).to(h.dtype) if ctx.needs_input_grad[0] else None
        de = _mm_bf16(g.t(), h).to(e.dtype) if ctx.needs_input_grad[1] \
            else None
        return dh, de


def _state_leaves(params, state) -> List[Dict[str, torch.Tensor]]:
    """The ``{"m", "v"}`` entries of ``state`` in
    ``tree_leaves(params)`` order."""
    if isinstance(params, dict):
        return [x for key in params
                for x in _state_leaves(params[key], state[key])]
    if isinstance(params, (list, tuple)):
        return [x for p, s in zip(params, state)
                for x in _state_leaves(p, s)]
    return [state]


class TransformerLM:
    def __init__(self, vocab_size: int, d_model: int = 256,
                 num_heads: int = 8, num_layers: int = 4,
                 d_ff: Optional[int] = None, max_len: int = 512,
                 lr: float = 3e-4, seed: int = 0,
                 dtype_policy: str = "float32", attn_impl: str = "auto",
                 remat: bool = False, pos_encoding: str = "learned",
                 num_kv_heads: Optional[int] = None,
                 attn_window: Optional[int] = None,
                 sp_impl: str = "ring", scan_layers: bool = False,
                 device=None):
        assert d_model % num_heads == 0
        assert attn_impl in ("auto", "xla", "flash")
        assert pos_encoding in ("learned", "rope")
        if pos_encoding == "rope" and (d_model // num_heads) % 2:
            raise ValueError(
                f"RoPE needs an even head_dim (got "
                f"{d_model // num_heads}: d_model={d_model} / "
                f"num_heads={num_heads}); the rotation pairs dimensions")
        self.num_kv_heads = num_heads if num_kv_heads is None else num_kv_heads
        if self.num_kv_heads < 1 or num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_kv_heads={self.num_kv_heads} must be >= 1 and divide "
                f"num_heads={num_heads}")
        if attn_window is not None and attn_window < 1:
            raise ValueError(f"attn_window={attn_window} must be >= 1")
        if sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl={sp_impl!r} must be 'ring' or "
                             "'ulysses'")
        self.device = resolve_device(device)
        self.attn_impl = attn_impl
        self.pos_encoding = pos_encoding
        self.attn_window = attn_window
        # the sequence-parallel strategy under sequence_parallel=True
        self.sp_impl = sp_impl
        self.scan_layers = bool(scan_layers)
        self.remat = remat
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.d_ff = d_ff or 4 * d_model
        self.max_len = max_len
        self.lr = lr
        self.seed = seed
        self.dtype_policy_name = dtype_policy
        self.policy = dtypes_mod.policy_from_name(dtype_policy)
        self.params: Optional[Dict[str, Any]] = None
        self.opt_state: Optional[Dict[str, Any]] = None
        self.step_count = 0
        # one memory pool for the graphs of every captured step function
        self._graph_pool = GraphPool()
        # the tensor-parallel shards this rank holds (shard_params)
        self._tp: Optional[_TensorShards] = None
        self._registry = None

    # ------------------------------------------------------------------
    def init(self) -> "TransformerLM":
        """Random parameters from ``seed`` (a CPU ``torch.Generator``, so
        the same seed gives the same weights on every device). They do
        not equal the reference's ``jax.random`` draws; load those with
        ``models/convert.params_from_jax``."""
        gen = torch.Generator().manual_seed(self.seed)
        D, F_, V, L = self.d_model, self.d_ff, self.vocab_size, self.max_len
        Dh = D // self.num_heads
        dt = self.policy.param_dtype

        def normal(*shape):
            return torch.randn(shape, generator=gen, dtype=dt)

        def dense(fan_in, fan_out):
            return normal(fan_in, fan_out) * math.sqrt(2.0 / (fan_in + fan_out))

        def norm():
            return {"g": torch.ones(D, dtype=dt), "b": torch.zeros(D, dtype=dt)}

        params: Dict[str, Any] = {"embed": normal(V, D) * 0.02,
                                  "ln_f": norm(), "blocks": []}
        if self.pos_encoding == "learned":
            params["pos"] = normal(L, D) * 0.02
        for _ in range(self.num_layers):
            params["blocks"].append({
                "ln1": norm(),
                "attn": {
                    "wq": dense(D, D),
                    "wk": dense(D, self.num_kv_heads * Dh),
                    "wv": dense(D, self.num_kv_heads * Dh),
                    "wo": dense(D, D),
                },
                "ln2": norm(),
                "mlp": {"w1": dense(D, F_), "b1": torch.zeros(F_, dtype=dt),
                        "w2": dense(F_, D), "b2": torch.zeros(D, dtype=dt)},
            })
        self.params = dtypes_mod.tree_map(lambda p: p.to(self.device), params)
        self.opt_state = dtypes_mod.tree_map(
            lambda p: {"m": torch.zeros_like(p), "v": torch.zeros_like(p)},
            self.params)
        return self

    def _ensure_init(self):
        if self.params is None:
            self.init()

    def get_config(self) -> Dict[str, Any]:
        """Constructor kwargs sufficient to rebuild this model (the
        reference's keys; ``device`` is where it runs, not part of it)."""
        return {
            "vocab_size": self.vocab_size, "d_model": self.d_model,
            "num_heads": self.num_heads, "num_layers": self.num_layers,
            "num_kv_heads": self.num_kv_heads,
            "attn_window": self.attn_window,
            "d_ff": self.d_ff, "max_len": self.max_len, "lr": self.lr,
            "seed": self.seed, "dtype_policy": self.dtype_policy_name,
            "attn_impl": self.attn_impl, "remat": self.remat,
            "pos_encoding": self.pos_encoding,
            "scan_layers": self.scan_layers,
        }

    # ------------------------------------------------------------------
    def _head_dim_tiles(self) -> bool:
        head_dim = self.d_model // self.num_heads
        return head_dim >= 64 and head_dim % 8 == 0

    def _attn_impl(self, t: Optional[int] = None, *,
                   train: bool = False) -> str:
        """Resolve the attention path. ``DL4J_ATTN_IMPL`` (``flash`` /
        ``xla`` / ``auto``) overrides the constructor. "auto" keeps the
        reference's rule: the plain path on a CPU device (where the
        reference's kernel would run interpreted), else flash for training
        whenever head_dim tiles, and for inference from t >= 4096 with
        head_dim >= 64 (a crossover measured on the TPU, not yet on the
        H100)."""
        env = os.environ.get("DL4J_ATTN_IMPL", "").strip().lower()
        impl = self.attn_impl
        if env:
            if env not in ("auto", "xla", "flash"):
                raise ValueError(
                    f"DL4J_ATTN_IMPL={env!r} must be one of "
                    "auto/xla/flash")
            impl = env
        if impl != "auto":
            return impl
        if self.device.type != "cuda":
            return "xla"
        if train:
            return "flash" if self._head_dim_tiles() else "xla"
        seq = t if t is not None else self.max_len
        if seq >= 4096 and self.d_model // self.num_heads >= 64:
            return "flash"
        return "xla"

    def _block(self, blk, h: torch.Tensor, *, mesh=None,
               sequence_parallel: bool = False, attention=None,
               positions: Optional[torch.Tensor] = None,
               train: bool = False):
        """One pre-norm block on ``h`` [b, t, D]. Returns ``(h, k, v)``
        with k/v [b, t, Hkv, Dh] (post-RoPE). ``attention(q, k, v) -> o``
        overrides the causal self-attention core (the KV-cache decode
        attends against the cache). Under ``sequence_parallel`` with a
        mesh, ``h`` is this rank's sequence shard and attention runs
        over the ``sequence`` axis (ring or Ulysses, by ``sp_impl``)."""
        policy = self.policy
        tp = self._tp
        # a tensor-parallel rank outside training (no autograd graph):
        # the unsharded projections on the whole weights, attention on
        # this rank's heads (see _TensorShards)
        whole = (tp is not None and not train
                 and not torch.is_grad_enabled())
        split = tp is not None and not whole      # Megatron's f and g
        if whole:
            blk = tp.whole_block(blk)
        b, t = h.shape[0], h.shape[1]
        heads, kv_heads = self._local_heads()
        wk = policy.cast_compute(blk["attn"]["wk"])
        wv = policy.cast_compute(blk["attn"]["wv"])
        x = _layernorm(h, blk["ln1"]["g"], blk["ln1"]["b"], exact=not train)
        if split:
            x = tp.enter(x)
            if tp.kv_index is not None:   # replicated, each rank's heads
                wk, wv = tp.enter(wk), tp.enter(wv)
        q = x @ policy.cast_compute(blk["attn"]["wq"])
        k, v = x @ wk, x @ wv
        if whole:
            q, k, v = tp.own_heads(q, k, v)
        q = q.reshape(b, t, heads, -1)
        k = k.reshape(b, t, kv_heads, -1)
        v = v.reshape(b, t, kv_heads, -1)
        if self.pos_encoding == "rope":
            if positions is None:
                positions = torch.arange(t, device=h.device)
            q = _rope(q, positions)
            k = _rope(k, positions)
        if attention is not None:
            o = attention(q, k, v)
        elif sequence_parallel and mesh is not None:
            o = self._sp_attention(q, k, v, mesh, train=train)
        elif self._attn_impl(t, train=train) == "flash":
            o = flash_attention(q, self._kv_for_q(k), self._kv_for_q(v),
                                causal=True, window=self.attn_window)
        else:
            o = self._attend(q, k, v, causal=True, window=self.attn_window)
        o = o.reshape(b, t, -1)
        wo = policy.cast_compute(blk["attn"]["wo"])
        if whole:
            o = tp.gather_heads(o)
        h = h + (tp.row(o, wo) if split else o @ wo)
        x = _layernorm(h, blk["ln2"]["g"], blk["ln2"]["b"], exact=not train)
        if split:
            x = tp.enter(x)
        x = F.gelu(x @ policy.cast_compute(blk["mlp"]["w1"])
                   + policy.cast_compute(blk["mlp"]["b1"]),
                   approximate="tanh")
        w2 = policy.cast_compute(blk["mlp"]["w2"])
        h = (h + (tp.row(x, w2) if split else x @ w2)
             + policy.cast_compute(blk["mlp"]["b2"]))
        return h, k, v

    def _local_heads(self) -> Tuple[int, int]:
        """(query heads, K/V heads) this rank computes: all of them
        without tensor parallelism."""
        if self._tp is None:
            return self.num_heads, self.num_kv_heads
        return self._tp.heads, self._tp.kv_heads

    def _kv_for_q(self, x: torch.Tensor) -> torch.Tensor:
        """K or V ``[b, t, Hkv_local, d]`` → one head per local query
        head, contiguous (the flash kernels' layout): repeated groups, or
        under the GQA fallback the heads this rank's q heads use."""
        tp = self._tp
        if tp is not None and tp.kv_index is not None:
            return x.index_select(2, tp.kv_index.to(x.device))
        return self._repeat_kv(x)

    def _attend(self, q, k, v, **kw) -> torch.Tensor:
        """Plain grouped-query attention of this rank's q heads against
        its K/V (a cache's included)."""
        tp = self._tp
        if tp is not None and tp.kv_index is not None:
            k, v = self._kv_for_q(k), self._kv_for_q(v)
        return grouped_query_attention(q, k, v, **kw)

    def _sp_attention(self, q, k, v, mesh, *, train: bool):
        """Causal attention over the ``sequence`` axis on this rank's
        shards, after ``_repeat_kv``."""
        kr, vr = self._kv_for_q(k), self._kv_for_q(v)
        if self.sp_impl == "ulysses":
            from deeplearning4j_tpu_torch.parallel.ulysses import (
                ulysses_attention)

            return ulysses_attention(q, kr, vr, mesh, causal=True,
                                     window=self.attn_window)
        from deeplearning4j_tpu_torch.parallel.ring_attention import (
            ring_attention)

        t = q.shape[1] * axis_size(mesh, SEQUENCE_AXIS)
        return ring_attention(q, kr, vr, mesh, causal=True,
                              impl=self._attn_impl(t, train=train),
                              window=self.attn_window)

    def _repeat_kv(self, x: torch.Tensor) -> torch.Tensor:
        """[b, t, Hkv, d] → [b, t, H, d] (no-op when H == Hkv)."""
        rep = self.num_heads // self.num_kv_heads
        return x if rep == 1 else torch.repeat_interleave(x, rep, dim=2)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, params, tokens: torch.Tensor,
               offset: int = 0) -> torch.Tensor:
        """Token (+ learned position) embedding of [b, t] tokens at
        positions offset..offset+t-1, in the compute dtype."""
        h = params["embed"][tokens]
        if self.pos_encoding == "learned":
            h = h + params["pos"][offset:offset + tokens.shape[1]][None]
        return self.policy.cast_compute(h)

    @torch.no_grad()
    def forward(self, params, tokens, *, mesh=None,
                sequence_parallel: bool = False, train: bool = False):
        """tokens: [b, t] int → logits [b, t, V] in the output dtype. Builds
        no autograd graph (the serve path); ``loss`` differentiates. Over
        a mesh every rank computes its part of the global tokens and
        gets the whole logits back (gathered over the mesh)."""
        axes = self._mesh_axes(mesh, sequence_parallel)
        if not axes:
            return self._logits(params, tokens, train=train)
        from deeplearning4j_tpu_torch.parallel.collectives import all_gather

        tokens = self._tokens(tokens)
        rows, p0, tl = self._local_part(tokens, mesh, sequence_parallel)
        out = self._logits(params, tokens[rows, p0:p0 + tl], mesh=mesh,
                           sequence_parallel=sequence_parallel, train=train,
                           offset=p0)
        for axis, dim in ((SEQUENCE_AXIS, 1), (DATA_AXIS, 0)):
            if axis in axes:
                out = all_gather(out, axis_group(mesh, axis), dim)
        return out

    def _mesh_axes(self, mesh, sequence_parallel: bool):
        """The mesh axes a step over ``mesh`` splits and reduces over:
        ``data`` (rows) and, under ``sequence_parallel``, ``sequence``
        (positions); only axes of size > 1."""
        axes = [DATA_AXIS] + ([SEQUENCE_AXIS] if sequence_parallel else [])
        return [a for a in axes if axis_size(mesh, a) > 1]

    def _local_part(self, tokens: torch.Tensor, mesh,
                    sequence_parallel: bool):
        """This rank's ``(rows, first position, positions)`` of the
        global tokens."""
        b, t = tokens.shape
        nd, ns = axis_size(mesh, DATA_AXIS), (
            axis_size(mesh, SEQUENCE_AXIS) if sequence_parallel else 1)
        if b % nd or t % ns:
            raise ValueError(
                f"tokens {tuple(tokens.shape)} do not split over the mesh "
                f"(data {nd}, sequence {ns})")
        bl, tl = b // nd, t // ns
        r0 = axis_rank(mesh, DATA_AXIS) * bl
        p0 = (axis_rank(mesh, SEQUENCE_AXIS) * tl) if ns > 1 else 0
        return slice(r0, r0 + bl), p0, tl

    def _logits(self, params, tokens, *, mesh=None,
                sequence_parallel: bool = False, train: bool = False,
                offset: int = 0):
        """``forward`` without ``no_grad``, on the tokens it is given
        (under a mesh, this rank's part, its first position at
        ``offset``). ``remat`` recomputes each block's activations in the
        backward pass (``torch.utils.checkpoint``); ``scan_layers`` runs
        the same loop, since a scan over stacked layers has nothing to
        save in eager PyTorch."""
        tokens = self._tokens(tokens)
        sp = sequence_parallel and mesh is not None
        h = self._embed(params, tokens, offset)
        positions = None
        if sp:
            positions = torch.arange(offset, offset + tokens.shape[1],
                                     device=h.device)

        def block_fn(blk, h):
            return self._block(blk, h, mesh=mesh, sequence_parallel=sp,
                               positions=positions, train=train)[0]

        for blk in params["blocks"]:
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(block_fn, blk, h, use_reentrant=False)
            else:
                h = block_fn(blk, h)
        unembed = self._unembed_train if train else self._unembed
        return self.policy.cast_output(unembed(params, h))

    def loss(self, params, tokens, *, mesh=None,
             sequence_parallel: bool = False, train: bool = False):
        """Next-token cross entropy (mean over positions), log-softmax in
        f32. Over a mesh: the global tokens' loss in every rank, each
        rank computing its share; a rank's gradients are those of its
        share, and their sum over the mesh is the loss's gradient."""
        tokens = self._tokens(tokens)
        axes = self._mesh_axes(mesh, sequence_parallel)
        if not axes:
            logits = self._logits(params, tokens, train=train)[:, :-1]
            logp = F.log_softmax(logits.float(), dim=-1)
            nll = -torch.gather(logp, -1, tokens[:, 1:, None])
            return nll.mean()
        from deeplearning4j_tpu_torch.parallel.collectives import SumSharesFn

        share = self._loss_share(params, tokens, mesh, sequence_parallel,
                                 train)
        for axis in axes:
            share = SumSharesFn.apply(share, axis_group(mesh, axis))
        return share

    def _loss_share(self, params, tokens, mesh, sequence_parallel: bool,
                    train: bool):
        """This rank's share of the global mean NLL: its positions'
        summed NLL (each predicting the next token of the global
        sequence; the last position has none) over ``b·(t − 1)``."""
        b, t = tokens.shape
        rows, p0, tl = self._local_part(tokens, mesh, sequence_parallel)
        logits = self._logits(params, tokens[rows, p0:p0 + tl], mesh=mesh,
                              sequence_parallel=sequence_parallel,
                              train=train, offset=p0)
        targets = tokens[rows, p0 + 1:p0 + tl + 1]
        logp = F.log_softmax(logits[:, :targets.shape[1]].float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])
        return nll.sum() / (b * (t - 1))

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _step_body(self, *, mesh=None, sequence_parallel: bool = False):
        """One optimizer step ``step(params, opt_state, tokens,
        step_count) -> (params, opt_state, loss)``. Under the
        ``mixed_bf16`` master-weights policy it derives ONE bf16
        parameter copy per step, takes the grads with respect to that
        copy, upcasts them once and applies Adam to the f32 masters and
        f32 moments. Unlike the reference's pure function, the step
        updates the masters and moments IN PLACE (under ``no_grad``) and
        returns the same objects; the masters never require grad, so the
        serve path builds no graph. ``step_count`` is an int32 device
        tensor (an int is filled into one): ``t``, ``1 − b1**t`` and
        ``1 − b2**t`` are float32 device scalars, as in the reference, so
        a captured step reads the counter it is given at every replay.

        Over a mesh with axes of size > 1 each rank differentiates its
        share of the loss (``_loss_share``); the gradients and the loss
        are summed over those axes (one flat all-reduce per dtype and
        axis), so every rank applies the same update."""
        axes = self._mesh_axes(mesh, sequence_parallel)

        def step(params, opt_state, tokens, step_count):
            if not isinstance(step_count, torch.Tensor):
                step_count = torch.full((), step_count, dtype=torch.int32,
                                        device=self.device)
            fwd = dtypes_mod.tree_map(lambda p: p.detach().requires_grad_(),
                                      self.policy.compute_copy(params))
            leaves = dtypes_mod.tree_leaves(fwd)
            if axes:
                from deeplearning4j_tpu_torch.parallel.collectives import (
                    all_reduce_, all_reduce_tree_)

                loss = self._loss_share(fwd, self._tokens(tokens), mesh,
                                        sequence_parallel, True)
            else:
                loss = self.loss(fwd, tokens, train=True)
            grads = torch.autograd.grad(loss, leaves)
            grads = [self.policy.master_grads(g) for g in grads]
            if axes:
                loss = loss.detach().clone()
                for axis in axes:
                    group = axis_group(mesh, axis)
                    all_reduce_tree_(grads, group)
                    all_reduce_(loss, group)
            self._adam_(params, opt_state, grads, step_count)
            return params, opt_state, loss.detach()

        return step

    def _adam_(self, params, opt_state, grads, step_count) -> None:
        """The reference's per-leaf Adam, operation for operation, on all
        leaves at once, in place (multi-tensor ops: a few launches per
        operation instead of one per leaf)."""
        lr = self.lr
        b1, b2, eps = 0.9, 0.999, 1e-8
        t = step_count.to(torch.float32) + 1.0
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        states = _state_leaves(params, opt_state)
        ms, vs = [s["m"] for s in states], [s["v"] for s in states]
        with torch.no_grad():
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, torch._foreach_mul(
                torch._foreach_mul(grads, 1 - b2), grads))
            mhat = torch._foreach_div(ms, bc1)
            denom = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(vs, bc2)), eps)
            torch._foreach_sub_(
                dtypes_mod.tree_leaves(params),
                torch._foreach_div(torch._foreach_mul(mhat, lr), denom))

    def _steps(self, k: int, mesh, sequence_parallel: bool):
        self._check_tp_mesh(mesh)
        step = self._step_body(mesh=mesh,
                               sequence_parallel=sequence_parallel)
        if self._mesh_axes(mesh, sequence_parallel) or self._tp is not None:
            return _EagerSteps(self, step, k)
        return _CapturedSteps(self, step, k)

    def _check_tp_mesh(self, mesh) -> None:
        """A mesh with a ``model`` axis steps the shards ``shard_params``
        placed on it."""
        if mesh is None or axis_size(mesh, MODEL_AXIS) == 1:
            return
        if self._tp is None or self._tp.mesh is not mesh:
            raise ValueError(
                "a mesh with a model axis needs the params sharded over it "
                "first: call shard_params(mesh)")

    def make_train_step(self, *, mesh=None, sequence_parallel: bool = False):
        """The step function (one step per call; see
        :class:`_CapturedSteps`, or :class:`_EagerSteps` for a step with
        collectives). Over a mesh every rank calls it with the same
        global tokens."""
        return self._steps(1, mesh, sequence_parallel)

    def make_multi_train_step(self, k: int, *, mesh=None,
                              sequence_parallel: bool = False):
        """K optimizer steps in one call, replays of one captured step on
        the card (the reference's ``lax.scan`` program); returns the last
        step's loss."""
        return self._steps(k, mesh, sequence_parallel)

    def fit_batch(self, tokens, train_step=None, block: bool = True):
        """One optimizer step on [b, t] tokens. ``block=False`` returns the
        loss as a device tensor without a host round-trip."""
        self._ensure_init()
        train_step = train_step or self._default_step
        self.params, self.opt_state, loss = train_step(
            self.params, self.opt_state, self._tokens(tokens),
            self.step_count)
        self.step_count += 1
        return float(loss) if block else loss

    def fit_batch_multi(self, tokens, *, multi_step, k: int,
                        block: bool = True):
        """Run a K-step function (see ``make_multi_train_step``)."""
        self._ensure_init()
        self.params, self.opt_state, loss = multi_step(
            self.params, self.opt_state, self._tokens(tokens),
            self.step_count)
        self.step_count += k
        return float(loss) if block else loss

    @functools.cached_property
    def _default_step(self):
        return self.make_train_step()

    @torch.no_grad()
    def evaluate_perplexity(self, tokens) -> float:
        """Corpus perplexity ``exp(mean next-token NLL)`` over [b, t]
        token batches."""
        self._ensure_init()
        return float(torch.exp(self.loss(self.params, tokens)))

    def flops_per_token(self, t: int) -> int:
        """Model FLOPs per trained token at sequence length ``t``: 6 per
        matmul parameter (the tied unembedding included) plus the
        attention term over the average visible keys (exact for a
        window). The reference's ``bench._transformer_flops_per_token``."""
        self._ensure_init()
        n_params_matmul = sum(
            p.numel() for blk in self.params["blocks"]
            for grp in blk.values() for p in grp.values())
        n_params_matmul += self.d_model * self.vocab_size
        if self.attn_window is None or self.attn_window >= t:
            avg_keys = t / 2
        else:
            w = self.attn_window
            avg_keys = w * (t - (w - 1) / 2) / t
        return int(6 * n_params_matmul
                   + 12 * self.num_layers * self.d_model * avg_keys)

    def _unembed(self, params, h: torch.Tensor) -> torch.Tensor:
        """Final layernorm + tied unembedding on [..., D] → [..., V] f32
        logits from compute-dtype operands, summed in float64 and rounded
        once, so that a row's logits (and its greedy token) do not depend
        on how many rows the matrix library is given (see
        ``ops.attention._mm_f32``). Every caller but training uses it:
        ``forward``, ``evaluate_perplexity``, ``generate`` and the
        serving engine."""
        policy = self.policy
        hf = _layernorm(h, params["ln_f"]["g"], params["ln_f"]["b"],
                        exact=True)
        return (policy.cast_compute(hf).double()
                @ policy.cast_compute(params["embed"]).double().T).float()

    def _unembed_train(self, params, h: torch.Tensor) -> torch.Tensor:
        """The training unembedding, as the reference computes it: the
        same layernorm and compute-dtype operands, products summed in f32
        and f32 logits. Under a bf16 compute dtype the product is
        :class:`_UnembedBF16` (bf16 tensor cores on the card); otherwise a
        plain matmul in the compute dtype. Training needs no batch
        invariance, so it pays for no f64 sums."""
        policy = self.policy
        hf = policy.cast_compute(
            _layernorm(h, params["ln_f"]["g"], params["ln_f"]["b"]))
        e = policy.cast_compute(params["embed"])
        if hf.dtype != torch.bfloat16:
            return hf @ e.T
        logits = _UnembedBF16.apply(hf.reshape(-1, hf.shape[-1]), e)
        return logits.reshape(*hf.shape[:-1], e.shape[0])

    # ------------------------------------------------------------------
    # autoregressive decoding (KV cache)
    # ------------------------------------------------------------------
    def _prefill(self, params, prompt: torch.Tensor, max_new_tokens: int):
        """One parallel forward over the prompt capturing per-layer K/V.
        Returns ``(h_last [b, D], cache)`` with cache entries of
        ``prompt_len + max_new_tokens`` positions."""
        cdt = self.policy.compute_dtype
        b, prompt_len = prompt.shape
        h = self._embed(params, prompt)
        cache: List[Dict[str, torch.Tensor]] = []
        for blk in params["blocks"]:
            h, kk, vv = self._block(blk, h)
            ck = kk.new_zeros((b, prompt_len + max_new_tokens)
                              + tuple(kk.shape[2:]), dtype=cdt)
            cv = torch.zeros_like(ck)
            ck[:, :prompt_len] = kk
            cv[:, :prompt_len] = vv
            cache.append({"k": ck, "v": cv})
        return h[:, -1], cache

    def _decode_token(self, params, cache, tok: torch.Tensor, t: int,
                      total: int):
        """Consume one token per row at position ``t`` against the cache
        (updated in place), through the same ``_block`` math as the
        prefill — only the attention core differs. Returns ``h_last``."""
        cdt = self.policy.compute_dtype
        B = tok.shape[0]
        h = params["embed"][tok]
        if self.pos_encoding == "learned":
            h = h + params["pos"][t]
        h = self.policy.cast_compute(h)[:, None, :]          # [B, 1, D]
        ar = torch.arange(total, device=tok.device)
        live = ar <= t
        if self.attn_window is not None:
            live &= ar > t - self.attn_window
        live = live[None, :].expand(B, total)

        def cached_attention(c):
            def attn(q, kk, vv):
                c["k"][:, t] = kk[:, 0].to(cdt)
                c["v"][:, t] = vv[:, 0].to(cdt)
                return self._attend(q, c["k"], c["v"], mask=live)
            return attn

        positions = torch.tensor([t], device=tok.device)
        for blk, c in zip(params["blocks"], cache):
            h, _, _ = self._block(blk, h, attention=cached_attention(c),
                                  positions=positions)
        return h[:, 0]

    def _validate_decode_args(self, prompt_len: int,
                              max_new_tokens: int) -> int:
        total = prompt_len + max_new_tokens
        if prompt_len < 1:
            raise ValueError("prompt_len must be >= 1")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if total > self.max_len and self.pos_encoding == "learned":
            raise ValueError(
                f"prompt_len + max_new_tokens = {total} exceeds "
                f"max_len={self.max_len} (learned position table; use "
                f"pos_encoding='rope' to decode past it)")
        return total

    def _check_sampling(self, temperature: float,
                        top_k: Optional[int]) -> None:
        if top_k is not None and not 1 <= top_k <= self.vocab_size:
            raise ValueError(
                f"top_k={top_k} must be in [1, vocab_size={self.vocab_size}]")
        if temperature < 0.0:
            raise ValueError(f"temperature={temperature} must be >= 0")

    def make_generate(self, prompt_len: int, max_new_tokens: int, *,
                      temperature: float = 0.0, top_k: Optional[int] = None):
        """Build ``gen(params, prompt, generator=None) -> [b, total]``: one
        parallel prefill of the ``[b, prompt_len]`` prompt into a KV cache,
        then one token per step against it. ``temperature=0`` decodes
        greedily; otherwise each step draws from ``softmax(logits /
        temperature)`` filtered to ``top_k`` with ``generator`` (one
        ``torch.multinomial`` call a step). Arguments are validated here,
        as the reference validates them when it builds its program."""
        total = self._validate_decode_args(prompt_len, max_new_tokens)
        self._check_sampling(temperature, top_k)

        @torch.no_grad()
        def gen(params, prompt, generator: Optional[torch.Generator] = None):
            prompt = self._tokens(prompt)
            if prompt.ndim != 2 or prompt.shape[1] != prompt_len:
                raise ValueError(
                    f"prompt must be [b, {prompt_len}] (got "
                    f"{tuple(prompt.shape)})")
            h_last, cache = self._prefill(params, prompt, max_new_tokens)
            tok = sample_logits(self._unembed(params, h_last), temperature,
                                top_k, generator)
            out = [tok]
            # steps consume generated tokens at positions p .. total-2,
            # each emitting the NEXT token; the first is position p itself
            for t in range(prompt_len, total - 1):
                h_last = self._decode_token(params, cache, tok, t, total)
                tok = sample_logits(self._unembed(params, h_last),
                                    temperature, top_k, generator)
                out.append(tok)
            return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)

        return gen

    def make_generate_beam(self, prompt_len: int, max_new_tokens: int,
                           beam_size: int):
        """Build ``gen(params, prompt) -> (seqs, scores)``: beam search
        with ``seqs`` ``[b, beam, prompt_len + max_new]`` (best beam first)
        and ``scores`` ``[b, beam]``, summed token log-probs.

        Beams ride the batch dimension, batch-major (row = batch·K +
        beam): each step extends every beam, takes the top K of the
        ``b × (K·V)`` candidates (ties to the lower index, as the
        reference's ``lax.top_k``) and reorders the cache rows by parent
        beam with one gather."""
        total = self._validate_decode_args(prompt_len, max_new_tokens)
        K, V = beam_size, self.vocab_size
        if not 1 <= K <= V:
            raise ValueError(f"beam_size={K} must be in [1, vocab={V}]")

        @torch.no_grad()
        def gen(params, prompt):
            prompt = self._tokens(prompt)
            if prompt.ndim != 2 or prompt.shape[1] != prompt_len:
                raise ValueError(
                    f"prompt must be [b, {prompt_len}] (got "
                    f"{tuple(prompt.shape)})")
            b = prompt.shape[0]
            h_last, cache = self._prefill(params, prompt, max_new_tokens)
            logp0 = torch.log_softmax(self._unembed(params, h_last), dim=-1)
            scores, tok = top_k_first_index(logp0, K)          # [b, K]
            cache = [{"k": c["k"].repeat_interleave(K, dim=0),
                      "v": c["v"].repeat_interleave(K, dim=0)}
                     for c in cache]
            seqs = tok.new_zeros((b, K, max_new_tokens))
            seqs[:, :, 0] = tok
            base = torch.arange(b, device=prompt.device)[:, None] * K
            for i, t in enumerate(range(prompt_len, total - 1), start=1):
                h_last = self._decode_token(params, cache, tok.reshape(-1),
                                            t, total)
                logp = torch.log_softmax(self._unembed(params, h_last),
                                         dim=-1)
                cand = scores[:, :, None] + logp.reshape(b, K, V)
                scores, idx = top_k_first_index(cand.reshape(b, K * V), K)
                parent = idx // V                              # [b, K]
                tok = idx % V
                rows = (base + parent).reshape(-1)
                cache = [{"k": c["k"][rows], "v": c["v"][rows]}
                         for c in cache]
                seqs = seqs.gather(1, parent[..., None].expand_as(seqs))
                seqs[:, :, i] = tok
            out = torch.cat([prompt[:, None].expand(b, K, prompt_len),
                             seqs], dim=2)
            return out, scores

        return gen

    #: a serving loop with varying prompt lengths builds one decoder per
    #: (shape, sampling) signature; the cache of them is LRU-bounded
    GEN_CACHE_MAX = 16

    def _cached_decoder(self, sig, factory):
        """The decoder of signature ``sig``, built by ``factory()`` on
        first use; shared by the decode APIs and LRU-bounded at
        ``GEN_CACHE_MAX`` signatures."""
        self._ensure_init()
        cache = getattr(self, "_gen_cache", None)
        if cache is None:
            cache = self._gen_cache = OrderedDict()
        fn = cache.get(sig)
        if fn is None:
            fn = cache[sig] = factory()
            while len(cache) > self.GEN_CACHE_MAX:
                cache.popitem(last=False)
        else:
            cache.move_to_end(sig)
        return fn

    def generate_beam(self, prompt, max_new_tokens: int,
                      beam_size: int = 4):
        """Beam-search ``max_new_tokens`` past ``prompt`` ([b, t]).
        Returns ``(seqs [b, beam, t + max_new], scores [b, beam])``, best
        beam first."""
        prompt = self._tokens(prompt)
        fn = self._cached_decoder(
            ("beam", tuple(prompt.shape), max_new_tokens, beam_size),
            lambda: self.make_generate_beam(
                prompt.shape[1], max_new_tokens, beam_size))
        return fn(self.params, prompt)

    def generate(self, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 seed: int = 0) -> torch.Tensor:
        """Decode ``max_new_tokens`` past ``prompt`` ([b, t] int) with the
        decoder :meth:`make_generate` builds for this signature.
        ``temperature=0`` decodes greedily; otherwise samples with a
        ``torch.Generator`` seeded from ``seed`` (greedy streams equal the
        reference's; sampled streams cannot, as ``jax.random`` bits are
        not reproducible here). Returns ``[b, t + max_new_tokens]``."""
        prompt = self._tokens(prompt)
        fn = self._cached_decoder(
            (tuple(prompt.shape), max_new_tokens, temperature, top_k),
            lambda: self.make_generate(
                prompt.shape[1], max_new_tokens, temperature=temperature,
                top_k=top_k))
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        return fn(self.params, prompt, gen)

    # ------------------------------------------------------------------
    # tensor-parallel sharding specs (Megatron split)
    # ------------------------------------------------------------------
    def param_specs(self, *, shard_data_embed: bool = False,
                    model_axis_size: Optional[int] = None,
                    mesh=None) -> Dict[str, Any]:
        """The Megatron spec tree of the params (pure specs): wq/wk/wv/w1
        column-sharded over ``model``, wo/w2 row-sharded. With GQA the kv
        heads must tile the model axis or wk/wv replicate, so GQA/MQA
        specs need ``model_axis_size`` (or ``mesh``)."""
        from deeplearning4j_tpu_torch.parallel.sharding_registry import P

        if mesh is not None and model_axis_size is None:
            model_axis_size = axis_size(mesh, MODEL_AXIS)
        col = P(None, MODEL_AXIS)
        row = P(MODEL_AXIS, None)
        kv_col = col
        if self.num_kv_heads != self.num_heads and model_axis_size is None:
            raise ValueError(
                "param_specs with GQA/MQA needs model_axis_size= (or "
                f"mesh=): whether the {self.num_kv_heads} kv heads can be "
                "column-sharded depends on the model-axis size")
        if model_axis_size and self.num_kv_heads % model_axis_size:
            logger.warning(
                "GQA TP fallback: num_kv_heads=%d does not tile the "
                "model axis (size %d) — wk/wv stay REPLICATED",
                self.num_kv_heads, model_axis_size)
            kv_col = P()
        blocks = []
        for _ in range(self.num_layers):
            blocks.append({
                "ln1": {"g": P(), "b": P()},
                "attn": {"wq": col, "wk": kv_col, "wv": kv_col, "wo": row},
                "ln2": {"g": P(), "b": P()},
                "mlp": {"w1": col, "b1": P(MODEL_AXIS), "w2": row,
                        "b2": P()},
            })
        specs = {
            "embed": row if shard_data_embed else P(),
            "ln_f": {"g": P(), "b": P()},
            "blocks": blocks,
        }
        if self.pos_encoding == "learned":
            specs["pos"] = P()
        return specs

    def shard_params(self, mesh):
        """Keep this rank's Megatron shards of the params and the Adam
        moments (every rank holds the whole tree before the call, as
        after ``init`` from one seed), split as :meth:`param_specs`
        splits them for the mesh's ``model`` axis, and run every later
        path tensor-parallel over it. A ``model`` axis of 1 (dropped from
        the mesh) places nothing: the model stays the meshless one."""
        from deeplearning4j_tpu_torch.parallel.sharding_registry import (
            ShardingRegistry, _expand)

        self._ensure_init()
        if self._tp is not None:
            raise ValueError("the params are already sharded")
        n = axis_size(mesh, MODEL_AXIS)
        want = self.param_specs(model_axis_size=n)
        if n > 1 and (self.num_heads % n or self.d_ff % n):
            raise ValueError(
                f"num_heads={self.num_heads} and d_ff={self.d_ff} must "
                f"split over the model axis (size {n})")
        reg = ShardingRegistry.for_transformer(self, mesh)
        if n > 1 and reg.spec_tree != _expand(self.params, want, (),
                                              "TransformerLM"):
            raise ValueError(
                "a leaf does not split over the model axis: "
                f"{reg.spec_tree}")
        self.params = reg.place(self.params)
        self.opt_state = reg.place_state(self.opt_state)
        self._registry = reg
        if n > 1:
            self._tp = _TensorShards(self, mesh)
        # a step function built before is the unsharded one
        self.__dict__.pop("_default_step", None)
        return self

    def gather_params(self):
        """``(params, opt_state)`` whole, from every rank's shards (a
        collective over ``model``); the trees themselves when unsharded."""
        if self._registry is None:
            return self.params, self.opt_state
        return (self._registry.gather(self.params),
                self._registry.gather_state(self.opt_state))


class _TensorShards:
    """What a rank of a tensor-parallel LM needs: the ``model`` axis's
    group, this rank's head counts, and under the GQA fallback the
    replicated K/V heads its query heads use (``kv_index``).

    Two ways through a block. Training, and any path that builds an
    autograd graph, runs Megatron's split: f (:meth:`enter`) before the
    column GEMMs, g (:meth:`row`) after the row GEMMs. Every other path
    (``forward``, ``generate``, beam search, serving) runs the unsharded
    projections on the whole weights (:meth:`whole_block`, gathered once
    and kept until a shard changes), attention and the KV cache on this
    rank's heads, and gathers the heads' outputs before ``wo``
    (:meth:`gather_heads`). Each of its GEMMs is then the unsharded
    model's, on the same operands and shapes, so a decode row holds the
    unsharded row's bytes and greedy and beam tokens are the unsharded
    ones, near-ties included; a split GEMM sums in another order, and on
    an H100 that flipped 2 of 8 greedy streams at top-2 margins under
    1e-3. Splitting those GEMMs at inference is later work (ROADMAP)."""

    def __init__(self, lm: "TransformerLM", mesh):
        self.mesh = mesh
        self.group = axis_group(mesh, MODEL_AXIS)
        self.n = axis_size(mesh, MODEL_AXIS)
        self.rank = axis_rank(mesh, MODEL_AXIS)
        self.heads = lm.num_heads // self.n
        self.head_dim = lm.d_model // lm.num_heads
        self.kv_index = None
        if lm.num_kv_heads % self.n == 0:
            self.kv_heads = lm.num_kv_heads // self.n
        else:
            rep = lm.num_heads // lm.num_kv_heads
            first = self.rank * self.heads
            self.kv_heads = lm.num_kv_heads
            self.kv_index = torch.arange(first, first + self.heads) // rep
        # the split dimension of each block leaf (param_specs)
        self._dims = {("attn", "wq"): 1, ("attn", "wo"): 0,
                      ("mlp", "w1"): 1, ("mlp", "b1"): 0, ("mlp", "w2"): 0}
        if self.kv_index is None:
            self._dims.update({("attn", "wk"): 1, ("attn", "wv"): 1})
        self._whole: Dict[int, Tuple[torch.Tensor, int, torch.Tensor]] = {}
        self._limit = 2 * len(self._dims) * lm.num_layers

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """f: identity forward, gradient summed over ``model``."""
        from deeplearning4j_tpu_torch.parallel.collectives import (
            CopyToShardsFn)

        return CopyToShardsFn.apply(x, self.group)

    def row(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """g after a row-split GEMM: ``x @ w`` of this rank's slice of
        ``x`` and rows of ``w``, the partials summed over ``model`` in
        f32 (a plain all-reduce; each rank's gradient its own)."""
        from deeplearning4j_tpu_torch.parallel.collectives import SumSharesFn

        out = x @ w
        return SumSharesFn.apply(out.float(), self.group).to(out.dtype)

    def _gathered(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole of the shard ``w`` (split along ``dim``), gathered
        over ``model`` once and again only after ``w`` changes: every
        rank runs the same updates, so every rank gathers together."""
        from deeplearning4j_tpu_torch.parallel.collectives import all_gather

        hit = self._whole.get(id(w))
        if hit is not None and hit[0] is w and hit[1] == w._version:
            return hit[2]
        if len(self._whole) >= self._limit:
            self._whole.clear()      # the shards were replaced
        out = all_gather(w.detach(), self.group, dim)
        self._whole[id(w)] = (w, w._version, out)
        return out

    def whole_block(self, blk):
        """``blk`` with each split leaf replaced by the whole weight."""
        return {part: {name: (self._gathered(leaf, self._dims[part, name])
                              if (part, name) in self._dims else leaf)
                       for name, leaf in leaves.items()}
                for part, leaves in blk.items()}

    def own_heads(self, q, k, v):
        """This rank's heads of whole-width q/k/v ``[b, t, H·dh]``,
        contiguous (the flash kernels' layout); under the GQA fallback
        every K/V head (``kv_index`` picks them)."""
        dq = self.heads * self.head_dim
        q = q.narrow(-1, self.rank * dq, dq).contiguous()
        if self.kv_index is None:
            dk = self.kv_heads * self.head_dim
            k = k.narrow(-1, self.rank * dk, dk).contiguous()
            v = v.narrow(-1, self.rank * dk, dk).contiguous()
        return q, k, v

    def gather_heads(self, o: torch.Tensor) -> torch.Tensor:
        """``[b, t, heads·dh]`` of this rank's heads → every head's, in
        head order (a concatenation: no sum to order)."""
        from deeplearning4j_tpu_torch.parallel.collectives import all_gather

        return all_gather(o, self.group, o.dim() - 1)


class _EagerSteps:
    """``k`` steps of a step with collectives per call, run eagerly:
    ``(params, opt_state, tokens, step_count) -> (params, opt_state,
    loss)``, the trees updated in place. ``captured`` says which kind of
    step function this is."""

    captured = False

    def __init__(self, lm: "TransformerLM", step, k: int):
        self.lm = lm
        self.step = step
        self.k = int(k)

    def __call__(self, params, opt_state, tokens, step_count):
        tokens = self.lm._tokens(tokens)
        count = torch.full((), int(step_count), dtype=torch.int32,
                           device=self.lm.device)
        for _ in range(self.k):
            params, opt_state, loss = self.step(params, opt_state, tokens,
                                                count)
            count.add_(1)
        return params, opt_state, loss


class _CapturedSteps:
    """``k`` steps of ``step`` (a ``_step_body``) per call:
    ``(params, opt_state, tokens, step_count) -> (params, opt_state,
    loss)``.

    One program per token shape holds
    static params, moments, tokens and an int32 step counter, and a
    :class:`StepGraph` of the step, which updates them in place and
    advances the counter. A call copies what it
    is given into the program (the params and moments only when they are
    not the program's own, which is what the last call returned), runs
    ``k`` steps (on the card: replays), and returns the program's trees
    and a copy of the last loss, still on the device."""

    captured = True

    def __init__(self, lm: "TransformerLM", step, k: int):
        self.lm = lm
        self.step = step
        self.k = int(k)
        self.programs: Dict[Any, Any] = {}

    def __call__(self, params, opt_state, tokens, step_count):
        tokens = self.lm._tokens(tokens)
        key = (tuple(tokens.shape), tokens.dtype)
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = self._build(params, opt_state,
                                                    tokens)
        if not _same_leaves(params, prog.params):
            copy_tree_(prog.params, params)
        if not _same_leaves(opt_state, prog.opt_state):
            copy_tree_(prog.opt_state, opt_state)
        prog.tokens.copy_(tokens)
        prog.step.fill_(step_count)
        for _ in range(self.k):
            prog.graph()
        return prog.params, prog.opt_state, prog.loss.clone()

    def _build(self, params, opt_state, tokens):
        lm = self.lm
        prog = types.SimpleNamespace(
            params=static_clone(params), opt_state=static_clone(opt_state),
            tokens=torch.empty_like(tokens),
            step=torch.zeros((), dtype=torch.int32, device=lm.device),
            loss=None)

        @traced
        def body():
            _, _, loss = self.step(prog.params, prog.opt_state, prog.tokens,
                                   prog.step)
            if prog.loss is None:  # shaped by the first (eager) step
                prog.loss = torch.empty_like(loss)
            prog.loss.copy_(loss)
            prog.step.add_(1)

        prog.graph = StepGraph(body, lm.device, pool=lm._graph_pool)
        return prog


def _same_leaves(a, b) -> bool:
    la, lb = dtypes_mod.tree_leaves(a), dtypes_mod.tree_leaves(b)
    return len(la) == len(lb) and all(x is y for x, y in zip(la, lb))
