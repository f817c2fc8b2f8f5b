"""Load the reference package's parameters and training state into the port.

``TransformerLM.params`` from the JAX package, turned into numpy leaf by
leaf (``np.asarray``), becomes the port's nested dict of tensors with the
same leaf names; a JAX ``MultiLayerNetwork``'s or ``ComputationGraph``'s
params, updater state, net state (keyed ``"0"``, ``"1"``, … or by layer
name, as in JAX; BatchNorm's running ``mean``/``var`` are net state) and
iteration count load into a port network of the same class, which then
carries on the JAX run step for step. The embedding models (Word2Vec,
SequenceVectors, ParagraphVectors, GloVe, DeepWalk) take the JAX model's
vocab order and tables (:func:`load_embeddings_from_jax`): the reference
initialises them with ``jax.random``, which torch cannot replay. So does
the RNTN, whose vocab, params and AdaGrad state :func:`load_rntn_from_jax`
carries. :func:`params_from_jax` also carries the parallel modules'
trees: a MoE FFN's router and stacked expert weights
(``parallel/expert_parallel.init_moe_params``) and stacked pipeline
stage params (``parallel/pipeline_parallel.stack_stage_params``), any
nesting of dicts and lists (a tuple comes back as a list). This module
imports neither jax nor the JAX package: it takes plain numpy (or
objects whose attributes ``np.asarray`` turns into numpy).
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":        # ml_dtypes.bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, device="cpu"):
    """Nested dict/list of numpy arrays → nested dict/list of tensors on
    ``device`` (same leaf names, dtypes and ``[in, out]`` layouts)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _leaf(tree, device)


def load_network_from_jax(net, params, updater_state=None, net_state=None,
                          iteration_count=None):
    """Put a JAX ``MultiLayerNetwork``'s or ``ComputationGraph``'s state,
    as numpy trees, into the port network ``net`` of the same class
    (initialised first, so what is not given keeps its fresh value) on
    ``net.device``. Returns ``net``."""
    net.init()
    net.params = params_from_jax(params, net.device)
    if updater_state is not None:
        net.updater_state = params_from_jax(updater_state, net.device)
    if net_state is not None:
        net.net_state = params_from_jax(net_state, net.device)
    if iteration_count is not None:
        net.iteration_count = int(iteration_count)
    return net


GLOVE_TABLES = ("w", "wc", "b", "bc", "hw", "hwc", "hb", "hbc")


def load_embeddings_from_jax(model, jax_model=None, **tables):
    """Put a JAX embedding model's vocab order and tables into the port's
    ``model`` on ``model.device``, so both start from the same weights.
    Returns ``model``.

    From ``jax_model`` (any object with the reference's attributes; its
    arrays are read with ``np.asarray``): the vocab (copied word by word
    with its counts, Huffman codes and points, in the JAX index order) and
    whichever of ``syn0``, ``syn1neg`` and ``syn1`` it holds. ``tables``
    (numpy) override them or give what the JAX model does not keep:

    - ``Word2Vec``/``SequenceVectors``: ``syn0``, ``syn1neg`` or ``syn1``;
    - ``ParagraphVectors``: ``syn0`` (word rows then label rows) and
      ``syn1neg``, which its next ``fit`` starts from;
    - ``Glove``: the eight tables ``w, wc, b, bc, hw, hwc, hb, hbc``
      (the JAX ``fit`` makes them inside the call), which its next
      ``fit`` starts from;
    - ``DeepWalk``: ``syn0`` and ``syn1``."""
    from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk
    from deeplearning4j_tpu_torch.nlp.glove import Glove
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        ParagraphVectors)
    from deeplearning4j_tpu_torch.nlp.vocab import VocabCache

    dev = model.device
    src = dict(tables)
    if jax_model is not None:
        for name in ("syn0", "syn1neg", "syn1"):
            value = getattr(jax_model, name, None)
            if value is not None and name not in src:
                src[name] = value
        vocab = getattr(jax_model, "vocab", None)
        if vocab is not None and not isinstance(model, DeepWalk):
            copy = VocabCache()
            for vw in vocab.vocab_words():
                copy.add_token(vw.word, vw.count)
                mine = copy.word_for(vw.word)
                mine.codes = (None if vw.codes is None
                              else np.asarray(vw.codes, np.int32))
                mine.points = (None if vw.points is None
                               else np.asarray(vw.points, np.int32))
            copy.total_word_count = vocab.total_word_count
            model.vocab = copy
            table = getattr(jax_model, "_table", None)
            if table is not None:
                model._table = np.asarray(table, np.int32)

    def put(name):
        return _leaf(np.asarray(src[name], np.float32), dev)

    if isinstance(model, Glove):
        missing = [k for k in GLOVE_TABLES if k not in src]
        if missing:
            raise ValueError(f"GloVe needs its eight tables; missing "
                             f"{missing}")
        model._start_tables = tuple(put(k) for k in GLOVE_TABLES)
    elif isinstance(model, ParagraphVectors):
        model._start_tables = (put("syn0"), put("syn1neg"))
    else:
        for name in ("syn0", "syn1neg", "syn1"):
            if name in src:
                setattr(model, name, put(name))
        if hasattr(model, "_norm_cache"):
            model._norm_cache = None
    return model


def load_rntn_from_jax(model, jax_model=None, **params):
    """Put a JAX ``RNTN``'s vocab, params, AdaGrad state and iteration
    count into the port's ``RNTN`` ``model`` on ``model.device``, so both
    carry on from the same state (the reference initialises with
    ``jax.random``, which torch cannot replay). Returns ``model``.

    From ``jax_model`` (any object with the reference's attributes; its
    arrays are read with ``np.asarray``): ``vocab``, ``params``,
    ``updater_state`` and ``iteration_count``. ``params`` (numpy, by the
    reference's names ``L, W, b, T, Ws, bs``) override its params; where no
    updater state is given, the state starts at zero."""
    from deeplearning4j_tpu_torch.nn.updater import init_updater_state

    src = {}
    state = None
    if jax_model is not None:
        if getattr(jax_model, "vocab", None) is not None:
            model.vocab = dict(jax_model.vocab)
        src.update(getattr(jax_model, "params", None) or {})
        state = getattr(jax_model, "updater_state", None)
        model.iteration_count = int(getattr(jax_model, "iteration_count", 0))
    src.update(params)
    model.params = {k: _leaf(np.asarray(v, np.float32), model.device)
                    for k, v in src.items()}
    model.updater_state = (
        init_updater_state(model._spec, model.params) if state is None
        else {k: _leaf(np.asarray(v, np.float32), model.device)
              for k, v in state.items()})
    return model
