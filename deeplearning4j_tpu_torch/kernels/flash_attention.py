"""Flash-attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the TPU kernel ``_fwd_kernel`` behind ``flash_attention_fwd`` in
``deeplearning4j_tpu/pallas/flash_attention.py`` (B1 in PERF.md). The
kernel source is ``csrc/flash_fwd.cu``; its note states the design and
what it leaves on the table.

Bound on an H100 (SXM, 700 W data sheet): the work is
``4·b·h·d·Σ(visible keys)`` FLOPs (QKᵀ and PV, two each per multiply-add)
against 989 TFLOP/s for bf16 operands and 67 TFLOP/s for f32, and the
bytes are q, k, v and out once each in the input dtype plus lse in f32,
against 3.35 TB/s; :func:`flash_bound` computes both.

- :func:`flash_attention_fwd` — the wrapper. CPU tensors take the plain
  version (:func:`flash_attention_fwd_reference`); CUDA tensors launch the
  kernel or raise. It counts its launches in
  ``flash_attention_fwd.launches``.
- :func:`flash_attention` — the forward-only attention call of
  ``TransformerLM._block``. It raises on inputs that require grad: the
  backward kernels (B2, B3) come with the training slice.

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
    tq, tkv, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = scale if scale is not None else float(1.0 / math.sqrt(d))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(tq, device=q.device)[:, None]
    ki = torch.arange(tkv, device=q.device)[None, :]
    keep = torch.ones(tq, tkv, dtype=torch.bool, device=q.device)
    if causal:
        keep &= qi >= ki
    if window is not None:
        keep &= qi - ki < window
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
    the current stream; anything else raises. CPU tensors take the plain
    version."""
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
    scale = scale if scale is not None else float(1.0 / math.sqrt(d))
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


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False, scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Forward-only flash attention, [b, tq, h, d] → [b, tq, h, d]."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention has no backward yet (the dk/dv and dq "
            "kernels come with the training slice); use attn_impl='xla' "
            "to differentiate")
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                               window=window)[0]


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
