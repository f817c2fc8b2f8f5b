"""Fused whole-epoch skip-gram: the sparse sibling of ``perf/epoch_cache``.

Port of ``deeplearning4j_tpu/nlp/epoch_kernels.py``. The host pair loop
of ``nlp/word2vec.py`` emits pairs with numpy at Python speed and
launches every batch's step from the host. Here:

- :class:`SkipGramCorpusCache` stacks the corpus as bucket-padded
  ``[S, L]`` token/mask tensors on the device, under the
  ``DL4J_DEVICE_CACHE_MB`` budget the dataset cache obeys, priced as the
  reference prices it (the residents plus ``total·4·(4+negative)`` bytes
  of plan workspace). Over budget it is ``None`` and the caller runs the
  host loop; it never raises.
- :func:`skipgram_epoch_plan` draws one epoch's pairs on the device:
  reduced-window masks, frequent-word subsampling, the epoch shuffle and
  the unigram-table negatives, all from one ``torch.Generator`` seeded for
  that epoch, written into the ``[N, B]`` plan. The plan is the host
  emitter's distribution, not its bitstream (numpy's PCG64 is not
  replayed on the card), as in the reference.
- :class:`SkipGramChunk` is the chunk program. One batch step reads batch
  n of the plan through a device cursor, computes the learning rate on
  the device from a device iteration count, applies the masked update
  (:func:`_neg_epoch_math`) to static copies of the tables, writes its
  loss into the epoch's row of the history, and advances the iteration
  and the cursor itself. The step is captured once as a CUDA graph
  (``perf/step_graph.StepGraph``) and replayed N times an epoch; the
  plan is made between epochs, outside the graph. On the CPU the same
  step runs eagerly.
- :func:`drive_skipgram_chunks` runs the chunks from the host: tracer
  spans, ledger windows, the watchdog deadline, the ``epoch.chunk`` fault
  point, listener and preemption hooks, and ``_train_dispatches``
  counting chunks.

Each epoch's generator is seeded from ``(seed, absolute epoch)``
(:func:`epoch_keys_for`), so ``fit_epochs(2)`` twice equals
``fit_epochs(4)`` once.

Over a mesh (``SkipGramCorpusCache.build(mesh=)``) every rank draws the
same plan from the same seeds and :class:`SkipGramMeshChunk` runs the
steps eagerly (their collectives cannot be captured), in one of two
modes (``Word2Vec._fused_mode``):

- ``dp``: each rank computes the per-pair terms of its ``B/n`` of every
  batch (its chunk over ``data``), and one ``all_gather`` brings every
  rank the whole batch's terms in rank order (the rows a batch touches,
  not the tables: ``(2 + K + 2D)·B`` floats a step against ``2·V·D``).
  The row counts come from the replicated plan, and every rank applies
  the whole batch's scatter-adds in the one-device order
  (``word2vec._row_sums``), so the tables stay the same bytes in every
  rank and sum their repeats as the one-device step does.
- ``rows`` (``DL4J_W2V_ROW_SHARD``, a ``model`` axis the vocab tiles):
  each rank holds ``V/model`` rows of ``syn0`` and ``syn1neg``. A step
  fetches the rows its batch touches (each owner contributes its rows, a
  sum over ``model`` with one non-zero term a row, so exact), runs the
  one-device step on them, and adds to its own rows their slice of the
  one-device deltas (a ``V``-row transient, so the repeats sum in the
  one-device order).

The plan functions and the chunk's step carry ``@traced``: the port's
dl4j-lint (``analysis/``) holds everything they reach free of host
readbacks.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis.annotations import traced
from deeplearning4j_tpu_torch.nlp.word2vec import (
    _joint_scales,
    _neg_loss_terms,
    _output_updates,
    _row_scale,
    _row_sums,
    _sigmoid_scores,
)
from deeplearning4j_tpu_torch.perf.bucketing import bucket_size
from deeplearning4j_tpu_torch.perf.epoch_cache import (
    cache_budget_mb,
    chunk_deadline_s,
)

logger = logging.getLogger(__name__)

__all__ = [
    "SkipGramCorpusCache",
    "SkipGramChunk",
    "SkipGramMeshChunk",
    "skipgram_pair_plan",
    "skipgram_negatives",
    "skipgram_epoch_plan",
    "drive_skipgram_chunks",
    "epoch_keys_for",
    "w2v_fused_enabled",
    "w2v_row_shard_mode",
]

# negatives are drawn in slices of this many pairs, which bounds the
# int64 draw temporaries (a text8-sized plan has 259 M pair slots)
NEGATIVE_CHUNK = 1 << 22


# ---------------------------------------------------------------------------
# env knobs
# ---------------------------------------------------------------------------
def w2v_fused_enabled() -> bool:
    """``DL4J_W2V_FUSED=0`` disables the fused path: ``fit_epochs`` runs
    the host pair loop instead."""
    return os.environ.get("DL4J_W2V_FUSED", "1") != "0"


def w2v_row_shard_mode() -> str:
    """``DL4J_W2V_ROW_SHARD``: ``auto`` (default: row-shard the tables
    over ``model`` whenever the mesh carries that axis and the vocab tiles
    it), ``1`` (the same, but warn when it cannot apply), ``0`` (never:
    tables stay replicated, data parallelism only)."""
    return os.environ.get("DL4J_W2V_ROW_SHARD", "auto").strip() or "auto"


# ---------------------------------------------------------------------------
# the epoch plan, drawn on the device
# ---------------------------------------------------------------------------
def pair_capacity(n_sentences: int, length: int, window: int) -> int:
    """Pair slots of ``[S, L]`` stacks: ``S · Σ_d 2(L-d)`` for d < L."""
    return n_sentences * sum(2 * (length - d) for d in range(1, window + 1)
                             if d < length)


def epoch_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def epoch_keys_for(seed: int, start: int, count: int) -> List[int]:
    """``count`` per-epoch generator seeds for the absolute epochs
    ``start .. start+count-1``. Keyed by the absolute epoch (not a chain),
    so chunk boundaries and resume points never change the stream."""
    return [int(np.random.SeedSequence([int(seed) & 0xFFFFFFFF, 0x57A9, e])
                .generate_state(1, np.uint64)[0] >> 1)
            for e in range(start, start + count)]


@traced
def skipgram_pair_plan(gen: torch.Generator, tokens, mask, keep_prob,
                       window: int, out=None):
    """One epoch's pair candidates from the ``[S, L]`` corpus stacks.

    A pair (i, i±d) exists iff both positions survive subsampling, share a
    sentence (``mask``), and the CENTER's reduced window ``b >= d``
    (word2vec's per-position ``b ~ U{1..window}``). Draws, in order: the
    subsampling uniforms, then the reduced windows.

    Returns ``(centers, contexts, valid)``, each flat ``[P]`` with
    ``P = pair_capacity(S, L, window)``, int32, int32 and float32, in the
    reference's slot order; invalid slots carry ``valid=0``. ``out``
    (three flat tensors of at least P) receives them in place."""
    dev = tokens.device
    s_count, length = (int(n) for n in tokens.shape)
    keep = (mask > 0) & (torch.rand(tokens.shape, generator=gen, device=dev)
                         < keep_prob[tokens.long()])
    b = torch.randint(1, window + 1, tokens.shape, generator=gen,
                      device=dev)
    n = pair_capacity(s_count, length, window)
    if out is None:
        centers = torch.empty((n,), dtype=torch.int32, device=dev)
        contexts = torch.empty((n,), dtype=torch.int32, device=dev)
        valid = torch.empty((n,), dtype=torch.float32, device=dev)
    else:
        centers, contexts, valid = (o[:n] for o in out)
    off = 0
    for d in range(1, window + 1):
        if d >= length:
            break
        m = s_count * (length - d)
        pair_ok = keep[:, :-d] & keep[:, d:]
        for c, x, ok in ((tokens[:, :-d], tokens[:, d:], b[:, :-d] >= d),
                         (tokens[:, d:], tokens[:, :-d], b[:, d:] >= d)):
            shape = (s_count, length - d)
            centers[off:off + m].view(shape).copy_(c)
            contexts[off:off + m].view(shape).copy_(x)
            valid[off:off + m].view(shape).copy_(pair_ok & ok)
            off += m
    return centers, contexts, valid


@traced
def skipgram_negatives(gen: torch.Generator, contexts, table, k: int,
                       out=None):
    """``[P, k]`` int32 unigram-table draws with ONE collision redraw
    against the positive (the host ``_sample_negatives``'s approximation
    of the reference's redraw loop). Drawn in slices of
    :data:`NEGATIVE_CHUNK` pairs: each slice's draws, then its redraws."""
    dev = contexts.device
    p = int(contexts.shape[0])
    size = int(table.shape[0])
    if out is None:
        out = torch.empty((p, k), dtype=torch.int32, device=dev)
    for s in range(0, p, NEGATIVE_CHUNK):
        e = min(p, s + NEGATIVE_CHUNK)
        draws = table[torch.randint(0, size, (e - s, k), generator=gen,
                                    device=dev)]
        redraws = table[torch.randint(0, size, (e - s, k), generator=gen,
                                      device=dev)]
        out[s:e] = torch.where(draws == contexts[s:e, None], redraws, draws)
    return out


def _permute_(a: torch.Tensor, order: torch.Tensor,
              scratch: torch.Tensor) -> None:
    """``a = a[order]`` in place for a flat 4-byte ``a``, through an int32
    ``scratch`` of the same length."""
    bits = a.view(torch.int32)
    torch.index_select(bits, 0, order, out=scratch)
    bits.copy_(scratch)


@traced
def skipgram_epoch_plan(gen: torch.Generator, tokens, mask, keep_prob,
                        table, window: int, negative: int, n_batches: int,
                        batch: int, out=None):
    """One epoch's full batch plan: pair candidates, padded to ``N·B``
    (pad slots ``valid=0``), the epoch shuffle (``torch.randperm``), then
    the negative draws, in the ``[N, B]`` layout the batch step reads.
    ``out`` (the four plan tensors) receives it in place."""
    dev = tokens.device
    total = n_batches * batch
    if out is None:
        out = (torch.empty((n_batches, batch), dtype=torch.int32,
                           device=dev),
               torch.empty((n_batches, batch), dtype=torch.int32,
                           device=dev),
               torch.empty((n_batches, batch), dtype=torch.float32,
                           device=dev),
               torch.empty((n_batches, batch, negative), dtype=torch.int32,
                           device=dev))
    centers, contexts, valid = (o.view(total) for o in out[:3])
    c, _, _ = skipgram_pair_plan(gen, tokens, mask, keep_prob, window,
                                 out=(centers, contexts, valid))
    n = int(c.shape[0])
    for a in (centers, contexts, valid):
        a[n:].zero_()
    order = torch.randperm(total, generator=gen, device=dev)
    scratch = torch.empty((total,), dtype=torch.int32, device=dev)
    for a in (centers, contexts, valid):
        _permute_(a, order, scratch)
    del order, scratch
    skipgram_negatives(gen, contexts, table, negative,
                       out=out[3].view(total, negative))
    return out


# ---------------------------------------------------------------------------
# the masked NEG updater
# ---------------------------------------------------------------------------
def _neg_epoch_math(syn0, syn1neg, centers, contexts, valid, negatives, lr):
    """Masked skip-gram NEG update, in place: per-pair gradients are
    scatter-summed (mean-normalized per row, the counts weighted by
    ``valid`` so pad slots neither update nor dilute) into table DELTAS,
    then added, as the reference's single-device path does. Returns
    ``(syn0, syn1neg, loss)``, the loss the mean over valid pairs."""
    centers, contexts, negatives = (centers.long(), contexts.long(),
                                    negatives.long())
    h = syn0[centers]                                        # [B, D]
    v_pos = syn1neg[contexts]                                # [B, D]
    v_neg = syn1neg[negatives]                               # [B, K, D]
    s_pos, s_neg = _sigmoid_scores(h, v_pos, v_neg)
    per_pair = -_neg_loss_terms(s_pos, s_neg) * valid
    loss_sum = torch.sum(per_pair)
    n_valid = torch.sum(valid)

    g_pos = (s_pos - 1.0) * lr * valid                       # [B]
    g_neg = s_neg * lr * valid[:, None]                      # [B, K]
    grad_h = (g_pos[:, None] * v_pos
              + torch.einsum("bk,bkd->bd", g_neg, v_neg))    # [B, D]

    loss = loss_sum / torch.clamp_min(n_valid, 1.0)

    # g_* already carry valid; the scale only mean-normalizes per row
    sc_c = _row_scale(syn0.shape[0], centers, valid)
    sc_pos, sc_neg = _joint_scales(syn1neg.shape[0], contexts, negatives,
                                   valid)
    syn0.add_(_row_sums(syn0.shape[0], centers, -grad_h * sc_c[:, None]))
    syn1neg.add_(_row_sums(syn1neg.shape[0], *_output_updates(
        h, contexts, negatives, g_pos * sc_pos, g_neg * sc_neg)))
    return syn0, syn1neg, loss


def _neg_epoch_tail(syn0_rows: int, syn1_rows: int, h, centers, contexts,
                    valid, negatives, per_pair, g_pos, g_neg, grad_h):
    """The whole batch's loss and table deltas from its per-pair terms,
    as :func:`_neg_epoch_math` computes them: ``(d0, d1, loss)``."""
    loss = torch.sum(per_pair) / torch.clamp_min(torch.sum(valid), 1.0)
    sc_c = _row_scale(syn0_rows, centers, valid)
    sc_pos, sc_neg = _joint_scales(syn1_rows, contexts, negatives, valid)
    d0 = _row_sums(syn0_rows, centers, -grad_h * sc_c[:, None])
    d1 = _row_sums(syn1_rows, *_output_updates(
        h, contexts, negatives, g_pos * sc_pos, g_neg * sc_neg))
    return d0, d1, loss


def _pair_terms(h, v_pos, v_neg, valid, lr):
    """Per-pair ``(per_pair loss, g_pos, g_neg, grad_h)`` of a NEG step."""
    s_pos, s_neg = _sigmoid_scores(h, v_pos, v_neg)
    per_pair = -_neg_loss_terms(s_pos, s_neg) * valid
    g_pos = (s_pos - 1.0) * lr * valid
    g_neg = s_neg * lr * valid[:, None]
    grad_h = (g_pos[:, None] * v_pos
              + torch.einsum("bk,bkd->bd", g_neg, v_neg))
    return per_pair, g_pos, g_neg, grad_h


def _neg_epoch_math_dp(syn0, syn1neg, centers, contexts, valid, negatives,
                       lr, group, n_shard: int, shard: int):
    """:func:`_neg_epoch_math` with the batch split over ``group`` (the
    ``dp`` mode of the module notes): in place, returns the loss."""
    centers, contexts, negatives = (centers.long(), contexts.long(),
                                    negatives.long())
    b = centers.shape[0] // n_shard
    mine = slice(shard * b, (shard + 1) * b)
    h = syn0[centers[mine]]
    per_pair, g_pos, g_neg, grad_h = _pair_terms(
        h, syn1neg[contexts[mine]], syn1neg[negatives[mine]], valid[mine],
        lr)
    k, d = g_neg.shape[1], h.shape[1]
    from deeplearning4j_tpu_torch.parallel.collectives import all_gather

    whole = all_gather(torch.cat([per_pair[:, None], g_pos[:, None], g_neg,
                                  grad_h, h], dim=1), group, 0)
    per_pair, g_pos, g_neg, grad_h, h = torch.split(
        whole, [1, 1, k, d, d], dim=1)
    d0, d1, loss = _neg_epoch_tail(
        syn0.shape[0], syn1neg.shape[0], h, centers, contexts, valid,
        negatives, per_pair[:, 0].contiguous(), g_pos[:, 0], g_neg, grad_h)
    syn0.add_(d0)
    syn1neg.add_(d1)
    return loss


def _fetch_rows(local, lo: int, idx, group):
    """``whole_table[idx]`` from every rank's rows ``[lo, lo + len)``."""
    from deeplearning4j_tpu_torch.parallel.collectives import all_reduce_

    uniq, inverse = torch.unique(idx, return_inverse=True)
    rows = torch.zeros((uniq.shape[0], local.shape[1]), dtype=local.dtype,
                       device=local.device)
    own = (uniq >= lo) & (uniq < lo + local.shape[0])
    rows[own] = local[uniq[own] - lo]
    all_reduce_(rows, group)
    return rows[inverse]


def _neg_epoch_math_rows(syn0, syn1neg, centers, contexts, valid,
                         negatives, lr, group, vocab: int, lo: int):
    """:func:`_neg_epoch_math` on row-sharded tables (the ``rows`` mode of
    the module notes): this rank's rows updated in place; returns the
    loss."""
    centers, contexts, negatives = (centers.long(), contexts.long(),
                                    negatives.long())
    h = _fetch_rows(syn0, lo, centers, group)
    v = _fetch_rows(syn1neg, lo,
                    torch.cat([contexts, negatives.reshape(-1)]), group)
    bsz = centers.shape[0]
    v_pos, v_neg = v[:bsz], v[bsz:].reshape(negatives.shape + (-1,))
    per_pair, g_pos, g_neg, grad_h = _pair_terms(h, v_pos, v_neg, valid, lr)
    d0, d1, loss = _neg_epoch_tail(vocab, vocab, h, centers, contexts, valid,
                                   negatives, per_pair, g_pos, g_neg, grad_h)
    syn0.add_(d0[lo:lo + syn0.shape[0]])
    syn1neg.add_(d1[lo:lo + syn1neg.shape[0]])
    return loss


# ---------------------------------------------------------------------------
# the device-resident corpus cache
# ---------------------------------------------------------------------------
class SkipGramCorpusCache:
    """The corpus as device-resident ``[S, L]`` token/mask stacks plus the
    vocab-derived tables the plan draws from (``keep_prob[V]``, the
    unigram ``table[T]``), on the model's device.

    ``build`` drains the iterator once (no host subsampling: it is drawn
    per epoch on the device), bucket-pads sentence length up the shared
    power-of-two ladder, prices the residents plus the per-epoch plan
    workspace against ``DL4J_DEVICE_CACHE_MB``, and returns ``None`` over
    budget (the caller runs the host loop instead)."""

    def __init__(self, *, tokens, mask, keep_prob, table, n_batches: int,
                 batch: int, n_pairs: int, n_words: int, window: int,
                 negative: int, nbytes: int, mesh=None, n_shard: int = 1):
        self.tokens = tokens
        self.mask = mask
        self.keep_prob = keep_prob
        self.table = table
        self.n_batches = n_batches
        self.batch = batch
        self.n_pairs = n_pairs
        self.n_words = n_words
        self.n_sentences = int(tokens.shape[0])
        self.window = window
        self.negative = negative
        self.mesh = mesh  # every rank holds the whole corpus and plan
        self.n_shard = n_shard  # the data axis's shards of every batch
        self.nbytes = nbytes

    @property
    def device(self) -> torch.device:
        return self.tokens.device

    @classmethod
    def build(cls, w2v, *, budget_mb: Optional[float] = None,
              mesh=None, buckets: Optional[Sequence[int]] = None,
              batch: Optional[int] = None
              ) -> Optional["SkipGramCorpusCache"]:
        """Build under budget on ``w2v.device``, inside a ``cache.build``
        tracer span with its counter; ``None`` on fallback. ``mesh=``
        records the mesh and its ``data`` shards (the batch is rounded up
        to a multiple of them); every rank holds the whole corpus."""
        from deeplearning4j_tpu_torch.monitor import record_counter, tracer

        with tracer().span("cache.build", kind=cls.__name__) as sp:
            out = cls._build(w2v, budget_mb=budget_mb, buckets=buckets,
                             batch=batch, mesh=mesh)
            sp.attrs["cached"] = out is not None
            if out is not None:
                sp.attrs.update(n_batches=out.n_batches, batch=out.batch,
                                mb=round(out.nbytes / 1024 ** 2, 3),
                                n_shard=out.n_shard)
        record_counter("cache_builds_total", kind=cls.__name__,
                       outcome="cached" if out is not None else "fallback")
        return out

    @classmethod
    def _build(cls, w2v, *, budget_mb=None, buckets=None,
               batch: Optional[int] = None, mesh=None
               ) -> Optional["SkipGramCorpusCache"]:
        from deeplearning4j_tpu_torch.nlp.vocab import subsample_keep_prob

        sentences = w2v._corpus_indices(subsample=False)
        if not sentences:
            logger.info("w2v corpus cache: empty corpus — host fallback")
            return None
        window = int(w2v.window_size)
        negative = max(1, int(w2v.negative))
        lens = np.fromiter((len(s) for s in sentences), np.int64,
                           count=len(sentences))
        length = bucket_size(int(lens.max()), buckets=buckets)
        s_count = len(sentences)
        # one scatter of the concatenated corpus instead of a row loop
        rows = np.repeat(np.arange(s_count), lens)
        cols = np.arange(int(lens.sum())) - np.repeat(
            np.cumsum(lens) - lens, lens)
        tokens = np.zeros((s_count, length), np.int32)
        mask = np.zeros((s_count, length), np.float32)
        tokens[rows, cols] = np.concatenate(sentences)
        mask[rows, cols] = 1.0
        n_words = int(lens.sum())
        keep = subsample_keep_prob(w2v.vocab, w2v.sampling)
        table = np.asarray(w2v._table, np.int32)

        n_pairs = pair_capacity(s_count, length, window)
        if n_pairs <= 0:
            logger.info("w2v corpus cache: no pair capacity (sentences "
                        "of length 1) — host fallback")
            return None
        if batch is None:
            # tiny corpora shrink the batch so each epoch still takes
            # several mean-normalized steps (mirrors the host loop)
            batch = min(int(w2v.batch_size), max(32, n_pairs // 8))
        # round up to a multiple of 8 (and of the data axis), as the
        # reference does: every power-of-two axis up to 8 gives the same
        # batch, so a mesh run and its one-device reference share a plan
        from deeplearning4j_tpu_torch.parallel.mesh import data_axis_size

        n_shard = data_axis_size(mesh)
        mult = 8 if n_shard in (1, 2, 4, 8) else 8 * n_shard
        batch = max(mult, int(batch))
        batch += (-batch) % mult
        n_batches = -(-n_pairs // batch)
        total = n_batches * batch

        resident = (tokens.nbytes + mask.nbytes + keep.nbytes
                    + table.nbytes)
        # the per-epoch plan (pairs + shuffle + negatives) lives on the
        # device while the chunk runs: price it, not just the residents
        workspace = total * 4 * (4 + negative)
        budget = (cache_budget_mb() if budget_mb is None
                  else float(budget_mb))
        if (resident + workspace) / 1024 ** 2 > budget:
            logger.info(
                "w2v corpus cache over budget: %.1f MB resident + %.1f "
                "MB plan workspace > %.1f MB — host-loop fallback",
                resident / 1024 ** 2, workspace / 1024 ** 2, budget)
            return None

        dev = w2v.device

        def put(a):
            return torch.from_numpy(a).to(dev)

        return cls(tokens=put(tokens), mask=put(mask),
                   keep_prob=put(keep), table=put(table),
                   n_batches=int(n_batches), batch=int(batch),
                   n_pairs=int(n_pairs), n_words=n_words, window=window,
                   negative=negative, nbytes=resident + workspace,
                   mesh=mesh, n_shard=n_shard)

    def plan(self, gen: torch.Generator, out=None):
        """One epoch's plan drawn from ``gen`` (see
        :func:`skipgram_epoch_plan`)."""
        return skipgram_epoch_plan(gen, self.tokens, self.mask,
                                   self.keep_prob, self.table, self.window,
                                   self.negative, self.n_batches,
                                   self.batch, out=out)

    def describe(self) -> dict:
        return {
            "sentences": self.n_sentences,
            "bucket_len": int(self.tokens.shape[1]),
            "words": self.n_words,
            "pair_capacity": self.n_pairs,
            "n_batches": self.n_batches,
            "batch": self.batch,
            "mb": round(self.nbytes / 1024 ** 2, 3),
            "n_shard": self.n_shard,
        }


# ---------------------------------------------------------------------------
# the chunk program
# ---------------------------------------------------------------------------
class SkipGramChunk:
    """The fused chunk for one corpus geometry: static tables, the epoch's
    plan buffers, the device cursor, iteration and learning-rate scalars,
    the epoch's loss row, and the :class:`StepGraph` of one batch step.
    ``launch(k, seeds, plans)`` runs k epochs and returns their ``[k, N]``
    loss history; ``ProfiledProgram`` wraps it (``DL4J_PROFILE``)."""

    def __init__(self, w2v, cache: SkipGramCorpusCache, key):
        from deeplearning4j_tpu_torch.monitor.profile import ProfiledProgram
        from deeplearning4j_tpu_torch.perf.step_graph import StepGraph

        dev = w2v.device
        n, b, k = cache.n_batches, cache.batch, cache.negative
        self.n_batches = n
        self.syn0 = torch.empty_like(w2v.syn0)
        self.syn1neg = torch.empty_like(w2v.syn1neg)
        self.plan = (torch.zeros((n, b), dtype=torch.int32, device=dev),
                     torch.zeros((n, b), dtype=torch.int32, device=dev),
                     torch.zeros((n, b), dtype=torch.float32, device=dev),
                     torch.zeros((n, b, k), dtype=torch.int32, device=dev))
        f32 = dict(dtype=torch.float32, device=dev)
        self.it = torch.zeros((), **f32)
        self.lr0 = torch.zeros((), **f32)
        self.min_lr = torch.zeros((), **f32)
        self.planned = torch.ones((), **f32)
        self.cursor = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.row = torch.zeros((n,), **f32)
        self.graph = StepGraph(self._step, dev)
        self.launch = ProfiledProgram(self._launch, name="w2v_epoch_chunk",
                                      key=key)

    @traced
    def _step(self) -> None:
        i = self.cursor
        cen, ctx, val, neg = (p.index_select(0, i).squeeze(0)
                              for p in self.plan)
        lr = torch.maximum(self.min_lr,
                           self.lr0 * (1.0 - self.it / self.planned))
        _, _, loss = _neg_epoch_math(self.syn0, self.syn1neg, cen, ctx, val,
                                     neg, lr)
        self.row.index_copy_(0, i, loss.reshape(1))
        self.it.add_(1.0)
        self.cursor.copy_(torch.remainder(i + 1, self.n_batches))

    def _launch(self, w2v, cache: SkipGramCorpusCache, seeds, plans):
        """``len(seeds)`` epochs on ``w2v``'s tables; ``plans`` (or None)
        holds one explicit plan per epoch in place of the drawn one."""
        k = len(seeds)
        self.syn0.copy_(w2v.syn0)
        self.syn1neg.copy_(w2v.syn1neg)
        self.it.fill_(float(w2v.iteration_count))
        self.lr0.fill_(float(w2v.learning_rate))
        self.min_lr.fill_(float(w2v.min_learning_rate))
        # the decay horizon is the CONFIGURED epochs, independent of this
        # call's count: a resumed run continues the same schedule
        self.planned.fill_(float(max(1, w2v.epochs) * self.n_batches))
        self.cursor.zero_()
        out = torch.empty((k, self.n_batches), dtype=torch.float32,
                          device=self.row.device)
        for e in range(k):
            if plans is None:
                cache.plan(epoch_generator(seeds[e], cache.device),
                           out=self.plan)
            else:
                for dst, src in zip(self.plan, plans[e]):
                    dst.copy_(src if isinstance(src, torch.Tensor)
                              else torch.from_numpy(np.array(src)))
            for _ in range(self.n_batches):
                self.graph()
            out[e].copy_(self.row)
        w2v.syn0 = self.syn0.clone()
        w2v.syn1neg = self.syn1neg.clone()
        return out


class SkipGramMeshChunk:
    """The chunk over a mesh (``mode`` ``dp`` or ``rows``, see the module):
    the same ``launch(w2v, cache, seeds, plans)`` as :class:`SkipGramChunk`
    and the same learning-rate arithmetic, each step run eagerly with its
    collectives on the tables ``w2v`` holds (in ``rows`` mode this rank's
    rows)."""

    def __init__(self, w2v, cache: SkipGramCorpusCache, key, mode: str):
        from deeplearning4j_tpu_torch.monitor.profile import ProfiledProgram
        from deeplearning4j_tpu_torch.parallel.mesh import (
            DATA_AXIS, MODEL_AXIS, axis_group, axis_rank, axis_size)

        self.mode = mode
        self.n_batches = cache.n_batches
        mesh = cache.mesh
        if mode == "dp":
            self.group = axis_group(mesh, DATA_AXIS)
            self.shard = axis_rank(mesh, DATA_AXIS)
        else:
            self.group = axis_group(mesh, MODEL_AXIS)
            self.shard = axis_rank(mesh, MODEL_AXIS)
            self.vocab = w2v.vocab.num_words()
            self.lo = self.shard * (self.vocab // axis_size(mesh, MODEL_AXIS))
        self.n_shard = cache.n_shard
        self.launch = ProfiledProgram(self._launch, name="w2v_epoch_chunk",
                                      key=key)

    def _step(self, syn0, syn1neg, plan, lr):
        if self.mode == "dp":
            return _neg_epoch_math_dp(syn0, syn1neg, *plan, lr, self.group,
                                      self.n_shard, self.shard)
        return _neg_epoch_math_rows(syn0, syn1neg, *plan, lr, self.group,
                                    self.vocab, self.lo)

    def _launch(self, w2v, cache: SkipGramCorpusCache, seeds, plans):
        k, n = len(seeds), self.n_batches
        dev = cache.device
        f32 = dict(dtype=torch.float32, device=dev)
        it = torch.full((), float(w2v.iteration_count), **f32)
        lr0 = torch.full((), float(w2v.learning_rate), **f32)
        min_lr = torch.full((), float(w2v.min_learning_rate), **f32)
        planned = torch.full((), float(max(1, w2v.epochs) * n), **f32)
        out = torch.empty((k, n), **f32)
        syn0, syn1neg = w2v.syn0, w2v.syn1neg
        for e in range(k):
            if plans is None:
                plan = cache.plan(epoch_generator(seeds[e], dev))
            else:
                plan = tuple(torch.as_tensor(np.asarray(a)).to(dev)
                             for a in plans[e])
            for i in range(n):
                lr = torch.maximum(min_lr, lr0 * (1.0 - it / planned))
                out[e, i] = self._step(syn0, syn1neg,
                                       tuple(a[i] for a in plan), lr)
                it = it + 1.0
        return out


# ---------------------------------------------------------------------------
# the host-side chunk loop
# ---------------------------------------------------------------------------
def drive_skipgram_chunks(w2v, cache: SkipGramCorpusCache,
                          num_epochs: int,
                          chunk_epochs: Optional[int] = None,
                          on_chunk=None, plans=None):
    """Run ``num_epochs`` fused epochs in chunks of ``chunk_epochs``
    (default: the whole run without listeners, 1 with them: the dense
    path's rule). ``w2v._train_dispatches`` counts chunks.

    Ledger run/chunk windows, ``epoch.chunk`` tracer spans and the
    dispatch counter, a ``StepWatchdog`` scaled to the chunk's step count,
    the ``epoch.chunk`` fault point, listener ``chunk_done`` firing and an
    ``on_chunk(epochs_done) -> bool`` preemption hook, as in the
    reference. Nothing in a chunk reads a value back to the host. Returns
    the ``[E, N]`` history (a device tensor)."""
    from deeplearning4j_tpu_torch.monitor import record_counter, tracer
    from deeplearning4j_tpu_torch.monitor.ledger import (
        ledger_chunk_done,
        ledger_chunk_start,
        ledger_run_end,
        ledger_run_start,
    )
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.resilience.watchdog import StepWatchdog

    if plans is not None and len(plans) < num_epochs:
        raise ValueError(f"{len(plans)} plans for {num_epochs} epochs")
    if chunk_epochs is None:
        chunk_epochs = 1 if getattr(w2v, "listeners", None) else num_epochs
    chunk_epochs = max(1, min(int(chunk_epochs), num_epochs))
    model_name = type(w2v).__name__
    prog = w2v._skipgram_program(cache)
    history = []
    done = 0
    stopped = False
    run_error = None
    watchdog = StepWatchdog(
        chunk_deadline_s(chunk_epochs * cache.n_batches))
    w2v._chunk_watchdog = watchdog
    ledger_run_start(model=model_name, epochs=num_epochs,
                     steps=num_epochs * cache.n_batches,
                     chunk_epochs=chunk_epochs, guard="off")
    try:
        with watchdog:
            while done < num_epochs:
                k = min(chunk_epochs, num_epochs - done)
                faults.fault_point("epoch.chunk")
                e0 = w2v._epochs_done
                seeds = epoch_keys_for(w2v.seed, e0, k)
                t0 = time.perf_counter()
                ledger_chunk_start(model=model_name, epoch0=e0, epochs=k)
                with tracer().span("epoch.chunk", model=model_name,
                                   epochs=k, steps=k * cache.n_batches,
                                   epoch0=e0):
                    hist = prog.launch(
                        w2v, cache, seeds,
                        None if plans is None else plans[done:done + k])
                watchdog.beat()
                ledger_chunk_done(model=model_name, epoch0=e0, epochs=k)
                w2v._train_dispatches += 1
                record_counter("train_chunk_dispatches_total",
                               model=model_name)
                w2v.iteration_count += k * cache.n_batches
                w2v._epochs_done += k
                w2v._score = hist[-1, -1]  # device scalar
                if hasattr(w2v, "_heartbeat_stats"):
                    # a heartbeat reads this: one scalar read a chunk
                    last = float(hist[-1, -1])
                    dt = max(time.perf_counter() - t0, 1e-9)
                    w2v._heartbeat_stats = {
                        "step_s": dt / (k * cache.n_batches),
                        "words_per_sec": k * cache.n_words / dt,
                        "last_loss": last,
                        "epochs_done": w2v._epochs_done,
                    }
                history.append(hist)
                done += k
                for listener in getattr(w2v, "listeners", ()):
                    chunk_cb = getattr(listener, "chunk_done", None)
                    if chunk_cb is not None:
                        chunk_cb(w2v, w2v.iteration_count
                                 - k * cache.n_batches, hist,
                                 metrics=None)
                    else:
                        listener.iteration_done(w2v, w2v.iteration_count)
                if on_chunk is not None and on_chunk(done):
                    stopped = True
                    break
    except BaseException as e:
        run_error = e
        raise
    finally:
        ledger_run_end(
            status=(f"error:{type(run_error).__name__}"
                    if run_error is not None
                    else ("stopped" if stopped else "clean")),
            model=model_name, epochs_done=done)
    if len(history) == 1:
        return history[0]
    return torch.cat(history)
