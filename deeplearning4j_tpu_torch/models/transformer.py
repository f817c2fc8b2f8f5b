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

Serving: ``forward``, ``generate`` (greedy and sampled) and the
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
Not ported yet: ``generate_beam`` and sequence parallelism (``mesh=``).
"""

from __future__ import annotations

import functools
import math
import os
import types
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch import dtypes as dtypes_mod
from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.kernels.flash_attention import flash_attention
from deeplearning4j_tpu_torch.ops.attention import grouped_query_attention
from deeplearning4j_tpu_torch.perf.step_graph import (
    GraphPool,
    StepGraph,
    copy_tree_,
    static_clone,
)


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
               eps: float = 1e-5) -> torch.Tensor:
    """Statistics in >= f32 (population variance), result in x's dtype."""
    st = torch.promote_types(x.dtype, torch.float32)
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
    scaled = logits.float() / temperature
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled, -math.inf)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


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
        # sp_impl only matters with sequence parallelism (not ported)
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

    def _block(self, blk, h: torch.Tensor, *, attention=None,
               positions: Optional[torch.Tensor] = None,
               train: bool = False):
        """One pre-norm block on ``h`` [b, t, D]. Returns ``(h, k, v)``
        with k/v [b, t, Hkv, Dh] (post-RoPE). ``attention(q, k, v) -> o``
        overrides the causal self-attention core (the KV-cache decode
        attends against the cache)."""
        policy = self.policy
        b, t = h.shape[0], h.shape[1]
        x = _layernorm(h, blk["ln1"]["g"], blk["ln1"]["b"])
        q = (x @ policy.cast_compute(blk["attn"]["wq"])).reshape(
            b, t, self.num_heads, -1)
        k = (x @ policy.cast_compute(blk["attn"]["wk"])).reshape(
            b, t, self.num_kv_heads, -1)
        v = (x @ policy.cast_compute(blk["attn"]["wv"])).reshape(
            b, t, self.num_kv_heads, -1)
        if self.pos_encoding == "rope":
            if positions is None:
                positions = torch.arange(t, device=h.device)
            q = _rope(q, positions)
            k = _rope(k, positions)
        if attention is not None:
            o = attention(q, k, v)
        elif self._attn_impl(t, train=train) == "flash":
            o = flash_attention(q, self._repeat_kv(k), self._repeat_kv(v),
                                causal=True, window=self.attn_window)
        else:
            o = grouped_query_attention(q, k, v, causal=True,
                                        window=self.attn_window)
        h = h + o.reshape(b, t, -1) @ policy.cast_compute(blk["attn"]["wo"])
        x = _layernorm(h, blk["ln2"]["g"], blk["ln2"]["b"])
        x = F.gelu(x @ policy.cast_compute(blk["mlp"]["w1"])
                   + policy.cast_compute(blk["mlp"]["b1"]),
                   approximate="tanh")
        h = (h + x @ policy.cast_compute(blk["mlp"]["w2"])
             + policy.cast_compute(blk["mlp"]["b2"]))
        return h, k, v

    def _repeat_kv(self, x: torch.Tensor) -> torch.Tensor:
        """[b, t, Hkv, d] → [b, t, H, d] (no-op when H == Hkv)."""
        rep = self.num_heads // self.num_kv_heads
        return x if rep == 1 else torch.repeat_interleave(x, rep, dim=2)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Token (+ learned position) embedding of [b, t] tokens at
        positions 0..t-1, in the compute dtype."""
        h = params["embed"][tokens]
        if self.pos_encoding == "learned":
            h = h + params["pos"][:tokens.shape[1]][None]
        return self.policy.cast_compute(h)

    @torch.no_grad()
    def forward(self, params, tokens, *, mesh=None,
                sequence_parallel: bool = False, train: bool = False):
        """tokens: [b, t] int → logits [b, t, V] in the output dtype. Builds
        no autograd graph (the serve path); ``loss`` differentiates."""
        return self._logits(params, tokens, mesh=mesh,
                            sequence_parallel=sequence_parallel,
                            train=train)

    def _logits(self, params, tokens, *, mesh=None,
                sequence_parallel: bool = False, train: bool = False):
        """``forward`` without ``no_grad``. ``remat`` recomputes each
        block's activations in the backward pass
        (``torch.utils.checkpoint``); ``scan_layers`` runs the same loop,
        since a scan over stacked layers has nothing to save in eager
        PyTorch."""
        if mesh is not None or sequence_parallel:
            raise NotImplementedError(
                "sequence parallelism (mesh=, sequence_parallel=True) is "
                "not ported yet")
        tokens = self._tokens(tokens)
        h = self._embed(params, tokens)

        def block_fn(blk, h):
            return self._block(blk, h, train=train)[0]

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
        f32."""
        tokens = self._tokens(tokens)
        logits = self._logits(params, tokens, mesh=mesh,
                              sequence_parallel=sequence_parallel,
                              train=train)[:, :-1]
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, tokens[:, 1:, None])
        return nll.mean()

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
        a captured step reads the counter it is given at every replay."""
        if mesh is not None or sequence_parallel:
            raise NotImplementedError(
                "sequence parallelism (mesh=, sequence_parallel=True) is "
                "not ported yet")
        lr = self.lr
        b1, b2, eps = 0.9, 0.999, 1e-8

        def step(params, opt_state, tokens, step_count):
            if not isinstance(step_count, torch.Tensor):
                step_count = torch.full((), step_count, dtype=torch.int32,
                                        device=self.device)
            fwd = dtypes_mod.tree_map(lambda p: p.detach().requires_grad_(),
                                      self.policy.compute_copy(params))
            leaves = dtypes_mod.tree_leaves(fwd)
            loss = self.loss(fwd, tokens, train=True)
            grads = torch.autograd.grad(loss, leaves)
            grads = [self.policy.master_grads(g) for g in grads]
            t = step_count.to(torch.float32) + 1.0
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            states = _state_leaves(params, opt_state)
            ms, vs = [s["m"] for s in states], [s["v"] for s in states]
            # the reference's per-leaf Adam, operation for operation, on
            # all leaves at once (multi-tensor ops: a few launches per
            # operation instead of one per leaf)
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
            return params, opt_state, loss.detach()

        return step

    def make_train_step(self, *, mesh=None, sequence_parallel: bool = False):
        """The step function (one step per call; see
        :class:`_CapturedSteps`)."""
        return _CapturedSteps(self, self._step_body(
            mesh=mesh, sequence_parallel=sequence_parallel), 1)

    def make_multi_train_step(self, k: int, *, mesh=None,
                              sequence_parallel: bool = False):
        """K optimizer steps in one call, replays of one captured step on
        the card (the reference's ``lax.scan`` program); returns the last
        step's loss."""
        return _CapturedSteps(self, self._step_body(
            mesh=mesh, sequence_parallel=sequence_parallel), k)

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
        hf = _layernorm(h, params["ln_f"]["g"], params["ln_f"]["b"])
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
                return grouped_query_attention(q, c["k"], c["v"], mask=live)
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

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 seed: int = 0) -> torch.Tensor:
        """Decode ``max_new_tokens`` past ``prompt`` ([b, t] int): one
        parallel prefill, then one token per step against the cache.
        ``temperature=0`` decodes greedily; otherwise samples with a
        ``torch.Generator`` seeded from ``seed`` (greedy streams equal the
        reference's; sampled streams cannot, as ``jax.random`` bits are
        not reproducible here). Returns ``[b, t + max_new_tokens]``."""
        self._ensure_init()
        prompt = self._tokens(prompt)
        prompt_len = prompt.shape[1]
        total = self._validate_decode_args(prompt_len, max_new_tokens)
        if top_k is not None and not 1 <= top_k <= self.vocab_size:
            raise ValueError(
                f"top_k={top_k} must be in [1, vocab_size={self.vocab_size}]")
        if temperature < 0.0:
            raise ValueError(f"temperature={temperature} must be >= 0")
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.params
        h_last, cache = self._prefill(params, prompt, max_new_tokens)
        tok = sample_logits(self._unembed(params, h_last), temperature,
                            top_k, gen)
        out = [tok]
        for t in range(prompt_len, total - 1):
            h_last = self._decode_token(params, cache, tok, t, total)
            tok = sample_logits(self._unembed(params, h_last), temperature,
                                top_k, gen)
            out.append(tok)
        return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


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
