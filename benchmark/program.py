"""The system under test: the port's ``TransformerLM`` built from a
configuration file, holding the benchmark's seeded weights. The one module
of the harness that imports the port."""

from __future__ import annotations

import torch


def build_lm(cfg: dict, params: dict, device, *, lr: float = 3e-4,
             adam: bool = False):
    """A ``TransformerLM`` of ``cfg``'s sizes holding ``params`` (the
    benchmark's weights, in the port's layout), with zero Adam moments
    when ``adam``."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_layers=cfg["num_hidden_layers"], d_ff=cfg["ffn_dim"],
        max_len=cfg["max_position_embeddings"], lr=lr,
        dtype_policy=cfg["assumed"]["dtype_policy"],
        attn_impl=cfg["assumed"]["attn_impl"], pos_encoding="learned",
        device=device)
    lm.params = params
    lm.opt_state = None
    if adam:
        from deeplearning4j_tpu_torch.dtypes import tree_map

        lm.opt_state = tree_map(lambda p: {"m": torch.zeros_like(p),
                                           "v": torch.zeros_like(p)}, params)
    return lm


def spans_tracer(capacity: int):
    """Install a fresh span tracer of the port that keeps ``capacity``
    spans; returns it."""
    from deeplearning4j_tpu_torch.monitor.trace import SpanTracer, set_tracer

    t = SpanTracer(capacity=capacity)
    set_tracer(t)
    return t


def build_server(lm, mix: dict, device):
    """A greedy ``DecodeServer`` of the mix's slots and slot length, one
    decode step a dispatch, no draft."""
    from deeplearning4j_tpu_torch.serving.server import DecodeServer

    return DecodeServer(lm, slots=mix["slots"], max_len=mix["max_len"],
                        max_queue=mix["max_queue"], temperature=0.0,
                        fuse_steps=1, draft_layers=0, device=device)


def point_kernel_cache(directory: str) -> None:
    """Build and load the port's kernel libraries in ``directory``."""
    import os

    os.environ["DL4J_COMPILE_CACHE_DIR"] = directory
    from deeplearning4j_tpu_torch.serving.compile_cache import (
        ensure_compile_cache)

    ensure_compile_cache()
