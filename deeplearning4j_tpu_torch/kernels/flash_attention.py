"""Flash attention: the hand-written CUDA kernels and their plain PyTorch
versions.

Replaces the three TPU kernels of ``deeplearning4j_tpu/pallas/
flash_attention.py`` (B1–B3 in PERF.md):

- B1, the forward ``_fwd_kernel`` behind ``flash_attention_fwd`` →
  ``csrc/flash_fwd.cu``;
- B2, ``_bwd_dkdv_kernel``, and B3, ``_bwd_dq_kernel``, both behind
  ``flash_backward_pallas`` → ``csrc/flash_bwd.cu``.

Each C entry point picks its kernel by dtype. Every kernel has two
variants: bf16 inputs run a tensor-core kernel ("mma.sync bf16": warp
``mma.sync`` with f32 accumulators, ``ldmatrix`` and a two-stage
``cp.async`` ring, from the shared header ``csrc/mma_bf16.cuh``); f32
inputs run the first, CUDA-core kernel ("fma f32"), since TF32 tensor
cores could not meet the f32 tolerances. Each source's note states the
design and what it leaves on the table.

Bounds on an H100 (SXM, 700 W data sheet), against 989 TFLOP/s for bf16
operands, 67 TFLOP/s for f32 and 3.35 TB/s, counting
``Σ(visible keys)`` (:func:`visible_keys`) for the FLOPs and each input
read once and each output written once for the bytes:

- B1 (:func:`flash_bound`): ``4·b·h·d·Σvisible`` FLOPs (QKᵀ and PV);
  q, k, v and out in the input dtype plus lse in f32.
- B2 (:func:`flash_bwd_bound`): ``8·b·h·d·Σvisible`` (s, dp, dv, dk);
  q, k, v and do in the input dtype, lse and delta in f32, dk and dv
  written in f32.
- B3: ``6·b·h·d·Σvisible`` (s, dp, dq); the same reads, dq written in
  f32.

Entry points:

- :func:`flash_attention_fwd` (B1), :func:`flash_attention_bwd_dkdv`
  (B2) and :func:`flash_attention_bwd_dq` (B3) — the wrappers. CPU
  tensors take the plain versions; CUDA tensors launch the kernels or
  raise. Each counts its launches in its ``launches`` attribute
  (:func:`launch_counts`). A launch made while a CUDA graph is captured
  is counted there too but only recorded; ``perf.step_graph
  .kernel_launches`` gives the launches that ran, replays included.
  Launches are capture-safe: each goes to the current stream, and the
  kernels' shared-memory attribute is set on their first (eager) launch
  on each device only (``csrc/smem_attr.cuh``).
  :func:`flash_attention_bwd` computes ``delta`` and runs B2 then B3;
  :func:`flash_attention_fwd_reference` and
  :func:`flash_attention_bwd_reference` are the plain versions of the
  forward and of the whole backward.
- :func:`flash_attention` — differentiable attention for
  ``TransformerLM._block``: a ``torch.autograd.Function`` whose forward
  is B1 and whose backward is B2 then B3 (the reference's ``custom_vjp``).
- :func:`flash_backward` — the chunked plain backward with position
  offsets (the reference's XLA-scan ``flash_backward``), the oracle the
  parity tests and a later ring attention use.

Layout is BTHD (``[batch, time, heads, head_dim]``) as in the reference.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

MASK_VALUE = -1e30
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# H100 SXM data-sheet peaks (dense): memory rate and per-type FLOP rates
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def _check(q, k, v, causal, window):
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal=True and window >= 1")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be [b, t, h, d]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"flash_attention(causal=True) requires tq == tkv (got "
            f"tq={q.shape[1]}, tkv={k.shape[1]}); self-attention "
            "positions must align")


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    """The softmax scale: ``scale`` or 1/sqrt(head_dim)."""
    return scale if scale is not None else float(1.0 / math.sqrt(q.shape[-1]))


def _keep(tq, tkv, causal, window, q_offset=0, k_offset=0, device=None):
    """``[tq, tkv]`` bool keep-mask: causal q >= k and window q - k <
    window at absolute positions offset by ``q_offset``/``k_offset``."""
    qi = q_offset + torch.arange(tq, device=device)[:, None]
    ki = k_offset + torch.arange(tkv, device=device)[None, :]
    keep = torch.ones(tq, tkv, dtype=torch.bool, device=device)
    if causal:
        keep &= qi >= ki
    if window is not None:
        keep &= qi - ki < window
    return keep


def flash_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False, scale: Optional[float] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same ``(out [b, tq, h, d]``
    in the input dtype, ``lse [b, h, tq]`` f32) and the same rules —
    unnormalised probabilities rounded to ``v.dtype`` before the PV
    product, a fully-masked row gives out = 0 and lse = -1e30."""
    _check(q, k, v, causal, window)
    tq, tkv = q.shape[1], k.shape[1]
    scale = _scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = _keep(tq, tkv, causal, window, device=q.device)
    s = torch.where(keep, s, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (acc / safe_l.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(safe_l))[..., 0]
    return out, lse


def _lib():
    from deeplearning4j_tpu_torch.kernels import _build

    fn = _build.load("flash_fwd").dl4j_flash_fwd
    if fn.argtypes is None:
        # c_void_p for every pointer and the stream: a bare Python int
        # would be passed as a 32-bit int and cut the address
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False, scale: Optional[float] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward. q: [b, tq, h, d]; k/v: [b, tkv, h, d].
    Returns ``(out [b, tq, h, d], lse [b, h, tq])``. On CUDA tensors this
    launches the kernel (f32 or bf16, head_dim 64 or 128, contiguous) on
    the current stream: the tensor-core kernel for bf16, the FMA kernel
    for f32. Anything else raises. CPU tensors take the plain version."""
    _check(q, k, v, causal, window)
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return flash_attention_fwd_reference(q, k, v, causal=causal,
                                             scale=scale, window=window)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"q, k, v must lie on one CUDA device "
                         f"(got {sorted(map(str, devices))})")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 inputs of "
                        f"one dtype (got {q.dtype}, {k.dtype}, {v.dtype})")
    b, tq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS} "
                         f"(got {d})")
    if not (q.is_contiguous() and k.is_contiguous()
            and v.is_contiguous()):
        raise ValueError("flash kernel needs contiguous BTHD inputs")
    scale = _scale(q, scale)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, tq, k.shape[1], d,
                 _DTYPE_CODE[q.dtype], int(causal),
                 0 if window is None else int(window), float(scale),
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _p_ds(q, k, v, do, lse, delta, keep, scale):
    """The tile math both backward kernels share (the reference's
    ``_bwd_tile``), in plain PyTorch: ``s = q·kᵀ·scale``,
    ``p = exp(s − lse)``, ``dp = do·vᵀ``, ``ds = p·(dp − delta)·scale``,
    with products of operands widened to f32 (exact) summed in f32.
    Masked entries give ``p = 0`` explicitly, so a row whose lse is
    -1e30 adds nothing. Returns ``p`` rounded to ``do.dtype`` and ``ds``
    to ``q.dtype`` (where the Pallas tiles round), widened back to f32.
    q/do ``[b, tq, h, d]``, k/v ``[b, tk, h, d]``, lse/delta
    ``[b, h, tq]`` f32, keep ``[tq, tk]`` bool."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    return p.to(do.dtype).float(), ds.to(q.dtype).float()


def _dkdv(q, k, v, do, lse, delta, keep, scale):
    """Plain B2 on whole spans: f32 ``(dk, dv)``."""
    p, ds = _p_ds(q, k, v, do, lse, delta, keep, scale)
    return (torch.einsum("bhqk,bqhd->bkhd", ds, q.float()),
            torch.einsum("bhqk,bqhd->bkhd", p, do.float()))


def _dq(q, k, v, do, lse, delta, keep, scale):
    """Plain B3 on whole spans: f32 ``dq``."""
    _, ds = _p_ds(q, k, v, do, lse, delta, keep, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float())


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``Σ_d out·do`` in f32, ``[b, h, tq]`` (the reference computes it
    beforehand, outside its kernels)."""
    return (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_backward(q, k, v, out, lse, do, *, causal: bool = False,
                   scale: Optional[float] = None, block_k: int = 1024,
                   q_offset: int = 0, k_offset: int = 0,
                   window: Optional[int] = None, precise: bool = False):
    """Chunked flash backward in plain PyTorch: the reference's XLA-scan
    ``flash_backward``. It loops over key blocks of ``block_k`` with
    O(t·block) live memory and supports arbitrary position offsets:
    ``q_offset``/``k_offset`` are the absolute positions of q[0]/k[0],
    and ``lse`` must then come from the full merged attention.

    q/out/do ``[b, tq, h, d]``; k/v ``[b, tkv, h, d]``; lse ``[b, h, tq]``.
    Returns f32 ``(dq, dk, dv)`` in the input layouts. Operands stay in
    the input dtype (rounded there, products summed in f32);
    ``precise=True`` makes every operand f32, so the oracle is more
    precise than the bf16 kernels it checks."""
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal=True and window >= 1")
    scale = _scale(q, scale)
    op = torch.float32 if precise else q.dtype
    q, k, v, do = (x.to(op) for x in (q, k, v, do))
    delta = _delta(out, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j in range(0, k.shape[1], block_k):
        kj, vj = k[:, j:j + block_k], v[:, j:j + block_k]
        keep = _keep(q.shape[1], kj.shape[1], causal, window, q_offset,
                     k_offset + j, device=q.device)
        dq += _dq(q, kj, vj, do, lse, delta, keep, scale)
        dk_j, dv_j = _dkdv(q, kj, vj, do, lse, delta, keep, scale)
        dks.append(dk_j)
        dvs.append(dv_j)
    return dq, torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, causal: bool = False,
    scale: Optional[float] = None, window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B2 and B3: f32 ``(dq, dk, dv)`` in BTHD,
    rounding where the kernels round (``do`` to ``q.dtype``, ``p`` to
    ``do.dtype``, ``ds`` to ``q.dtype``; ``delta`` in f32)."""
    _check(q, k, v, causal, window)
    scale = _scale(q, scale)
    do = do.to(q.dtype)
    delta = _delta(out, do)
    keep = _keep(q.shape[1], k.shape[1], causal, window, device=q.device)
    return (_dq(q, k, v, do, lse, delta, keep, scale),
            *_dkdv(q, k, v, do, lse, delta, keep, scale))


def _bwd_lib():
    from deeplearning4j_tpu_torch.kernels import _build

    lib = _build.load("flash_bwd")
    for name, n_ptr in (("dl4j_flash_bwd_dkdv", 8), ("dl4j_flash_bwd_dq", 7)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _bwd_launch(name, q, k, v, do, lse, delta, outs, causal, scale,
                window):
    """Check what a backward kernel takes and launch it on the current
    stream; raises on anything else and on a refused launch."""
    _check(q, k, v, causal, window)
    tensors = (q, k, v, do, lse, delta)
    devices = {x.device for x in tensors}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash backward inputs must lie on one CUDA "
                         f"device (got {sorted(map(str, devices))})")
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype
                                         for x in (k, v, do)):
        raise TypeError(f"flash kernel takes float32 or bfloat16 q, k, v, "
                        f"do of one dtype (got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {do.dtype})")
    b, tq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS} "
                         f"(got {d})")
    if do.shape != q.shape or lse.shape != (b, h, tq) \
            or delta.shape != (b, h, tq) or lse.dtype != torch.float32 \
            or delta.dtype != torch.float32:
        raise ValueError(f"do must be {tuple(q.shape)} and lse/delta "
                         f"[b, h, tq] float32 (got {tuple(do.shape)}, "
                         f"{tuple(lse.shape)} {lse.dtype}, "
                         f"{tuple(delta.shape)} {delta.dtype})")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash kernel needs contiguous BTHD inputs")
    fn = getattr(_bwd_lib(), name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(x.data_ptr() for x in tensors + outs),
                 b, h, tq, k.shape[1], d, _DTYPE_CODE[q.dtype], int(causal),
                 0 if window is None else int(window),
                 float(_scale(q, scale)), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _all_cpu(*tensors) -> bool:
    return {x.device for x in tensors} == {torch.device("cpu")}


def flash_attention_bwd_dkdv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool = False,
    scale: Optional[float] = None, window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: f32 ``(dk, dv)`` in BTHD. ``do`` is in ``q.dtype``; ``lse``
    and ``delta`` are ``[b, h, tq]`` f32. CUDA tensors launch the kernel
    (the tensor-core kernel for bf16, the FMA kernel for f32; counted in
    ``flash_attention_bwd_dkdv.launches``) or raise; CPU tensors take the
    plain version."""
    if _all_cpu(q, k, v, do, lse, delta):
        keep = _keep(q.shape[1], k.shape[1], causal, window, device=q.device)
        return _dkdv(q, k, v, do, lse, delta, keep, _scale(q, scale))
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty_like(dk)
    _bwd_launch("dl4j_flash_bwd_dkdv", q, k, v, do, lse, delta, (dk, dv),
                causal, scale, window)
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


flash_attention_bwd_dkdv.launches = 0


def flash_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool = False,
    scale: Optional[float] = None, window: Optional[int] = None,
) -> torch.Tensor:
    """B3: f32 ``dq`` in BTHD, from the same inputs as
    :func:`flash_attention_bwd_dkdv`. CUDA tensors launch the kernel (the
    tensor-core kernel for bf16, the FMA kernel for f32; counted in
    ``flash_attention_bwd_dq.launches``) or raise; CPU tensors take the
    plain version."""
    if _all_cpu(q, k, v, do, lse, delta):
        keep = _keep(q.shape[1], k.shape[1], causal, window, device=q.device)
        return _dq(q, k, v, do, lse, delta, keep, _scale(q, scale))
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _bwd_launch("dl4j_flash_bwd_dq", q, k, v, do, lse, delta, (dq,),
                causal, scale, window)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, causal: bool = False,
    scale: Optional[float] = None, window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward: f32 ``(dq, dk, dv)`` in BTHD from the
    forward's inputs, ``out``, ``lse [b, h, tq]`` and the output gradient
    ``do``. Computes ``delta`` in f32, then runs B2 (dk, dv) and B3 (dq):
    on CUDA tensors the two kernels, on CPU tensors their plain versions.
    The two-kernel split needs no atomics, so the gradients are the same
    from run to run."""
    _check(q, k, v, causal, window)
    do = do.to(q.dtype).contiguous()
    delta = _delta(out, do)
    kw = dict(causal=causal, scale=scale, window=window)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    return flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw), dk, dv


class _Flash(torch.autograd.Function):
    """Forward B1, backward B2 + B3: the reference's ``_flash`` with
    ``_flash_fwd_rule``/``_flash_bwd_rule``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                       window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = dict(causal=causal, scale=scale, window=window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         do.contiguous(), **ctx.cfg)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False, scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Differentiable flash attention, [b, tq, h, d] → [b, tq, h, d]."""
    return _Flash.apply(q, k, v, causal, scale, window)


def launch_counts() -> dict:
    """Each wrapper's launch count, by wrapper name."""
    return {"flash_attention_fwd": flash_attention_fwd.launches,
            "flash_attention_bwd_dkdv": flash_attention_bwd_dkdv.launches,
            "flash_attention_bwd_dq": flash_attention_bwd_dq.launches}


def reset_launch_counts() -> None:
    flash_attention_fwd.launches = 0
    flash_attention_bwd_dkdv.launches = 0
    flash_attention_bwd_dq.launches = 0


def visible_keys(tq: int, tkv: int, *, causal: bool,
                 window: Optional[int] = None) -> int:
    """Σ over query rows of the keys each row attends (this input's
    work, not the padded maximum)."""
    if not causal:
        return tq * tkv
    w = tq if window is None else min(window, tq)
    # row i sees min(i + 1, w) keys
    return w * (w + 1) // 2 + (tq - w) * w


def flash_bound(b: int, tq: int, tkv: int, h: int, d: int,
                dtype: torch.dtype, *, causal: bool,
                window: Optional[int] = None) -> dict:
    """Least time an H100 could take for this call: the larger of its
    bytes over the memory rate and its FLOPs over the peak rate for the
    operand type."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * (2 * b * tq * h * d + 2 * b * tkv * h * d) \
        + 4 * b * h * tq
    flops = 4 * b * h * d * visible_keys(tq, tkv, causal=causal,
                                         window=window)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FLOPS[dtype] * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def flash_bwd_bound(b: int, tq: int, tkv: int, h: int, d: int,
                    dtype: torch.dtype, *, causal: bool,
                    window: Optional[int] = None) -> dict:
    """Least H100 time of each backward kernel, ``{"dkdv": ..., "dq":
    ...}`` in the shape of :func:`flash_bound`. Both read q, k, v and do
    in the input dtype and lse and delta in f32; B2 writes dk and dv in
    f32 and does four products per visible (q, k) pair (s, dp, dv, dk),
    B3 writes dq in f32 and does three (s, dp, dq)."""
    elem = torch.finfo(dtype).bits // 8
    reads = elem * (2 * b * tq * h * d + 2 * b * tkv * h * d) \
        + 2 * 4 * b * h * tq
    pairs = b * h * d * visible_keys(tq, tkv, causal=causal, window=window)
    out = {}
    for name, nbytes, flops in (
            ("dkdv", reads + 2 * 4 * b * tkv * h * d, 8 * pairs),
            ("dq", reads + 4 * b * tq * h * d, 6 * pairs)):
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_FLOPS[dtype] * 1e3
        out[name] = {"bytes": nbytes, "flops": flops,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
    return out
