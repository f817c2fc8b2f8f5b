"""Word2Vec: batched skip-gram / CBOW on the card.

Port of ``deeplearning4j_tpu/nlp/word2vec.py`` (models/word2vec/
Word2Vec.java:31, SkipGram.java:24 in the reference project). The host
walks the corpus emitting (center, context) index pairs with word2vec's
reduced window and frequent-word subsampling; the pairs are batched and
one step per batch gathers the rows, computes the NEG or HS objective
and adds the updates back with scatter-adds.

The host loop's draws are numpy's (``np.random.default_rng(seed)``), made
in the reference's order: subsampling, window draws, the permutation,
then the negatives. So for one seed ``fit`` makes exactly the pairs and
negatives the reference makes; only the device arithmetic differs.

Scatter-adds: every step adds into rows that repeat within a batch (a
Zipf corpus repeats its head rows thousands of times a batch, and the
fused plan's pad slots all point at row 0). The port sums them in a
fixed order (:func:`_row_sums`): on the CPU with ``index_add_``, which
adds them one by one in index order; on CUDA with
``index_put_(accumulate=True)``, which sorts the indices and sums each
row's repeats one after another in one warp. That chain is what a step
waits for (one row repeated 14,000 times a batch took 12.4 ms a step on
the H100), so on CUDA the repeats of the :data:`HOT_ROWS` lowest rows
(the most frequent words: vocabularies are sorted by count) are first
spread over :data:`HOT_SPLIT` partial rows by their position in the
batch and the partials then summed, which cuts the chain by that
factor. The same inputs give the same bits on every run, so a replayed
step equals the eager one bitwise. ``index_add_`` and ``scatter_add_``
on CUDA, and ``index_put_`` on a large CPU batch, add with atomics in
no fixed order.

``fit_epochs`` is the fused whole-epoch skip-gram of ``nlp/epoch_kernels``;
``fit_epochs(mesh=)`` runs it over a mesh, every rank calling it alike:
the batch split over ``data`` (``dp``) or the tables row-sharded over
``model`` (``rows``), as ``_fused_mode`` decides. Row-sharded, ``syn0``
and ``syn1neg`` hold this rank's rows after the run; ``gather_tables``
gives the whole tables.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.nlp.sentence_iterator import SentenceIterator
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    Huffman,
    VocabCache,
    build_vocab,
    padded_huffman_paths,
    subsample_keep_prob,
    unigram_table,
)


# ---------------------------------------------------------------------------
# the update steps (device tensors in, tables updated in place)
# ---------------------------------------------------------------------------


HOT_ROWS = 64    # rows whose repeats are spread before they are summed
HOT_SPLIT = 128  # partial rows each of them is spread over


def _row_sums(n_rows: int, idx: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """``[n_rows, ...]``: the sum of ``values`` over the entries of each
    row of ``idx`` (zero where a row has none), in a fixed order (see the
    module notes)."""
    if values.is_cuda:
        return _spread_row_sums(n_rows, idx, values)
    return torch.zeros((n_rows,) + tuple(values.shape[1:]),
                       dtype=values.dtype,
                       device=values.device).index_add_(0, idx, values)


def _spread_row_sums(n_rows: int, idx: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """:func:`_row_sums` on CUDA: entry i of a row below :data:`HOT_ROWS`
    goes to that row's partial ``i % HOT_SPLIT``, one sorted
    ``index_put_`` sums every row and partial, and the partials are added
    to their rows."""
    rest = tuple(values.shape[1:])
    dev = values.device
    hot = min(HOT_ROWS, n_rows)
    part = torch.remainder(torch.arange(idx.shape[0], device=dev),
                           HOT_SPLIT)
    key = torch.where(idx < hot, n_rows + idx * HOT_SPLIT + part, idx)
    sums = torch.zeros((n_rows + hot * HOT_SPLIT,) + rest,
                       dtype=values.dtype, device=dev)
    sums.index_put_((key,), values, accumulate=True)
    out = sums[:n_rows]
    out[:hot] += sums[n_rows:].view((hot, HOT_SPLIT) + rest).sum(1)
    return out


def _scatter_add(table: torch.Tensor, idx: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``table[idx] += values`` with repeated rows summed in a fixed order
    (see the module notes): in index order on the CPU, on CUDA the
    :func:`_row_sums` added once. Returns ``table``."""
    if not table.is_cuda:
        return table.index_add_(0, idx, values)
    return table.add_(_row_sums(table.shape[0], idx, values))


def _row_scale(n_rows: int, idx: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1/count-per-row scaling for scatter-adds: a row hit k times in one
    batch receives the MEAN of its k per-pair updates rather than the sum
    (the reference's rule: the sequential original recomputes the sigmoid
    between pair updates, which bounds the step size).

    ``weights`` (same shape as ``idx``) weights the counting: the masked
    fused paths pass their validity mask so that pad slots neither update
    a row nor dilute its mean. The counts are small integers in float32,
    exact in any order."""
    contrib = (torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
               if weights is None else weights.to(torch.float32))
    counts = _row_sums(n_rows, idx.reshape(-1), contrib.reshape(-1))
    return 1.0 / torch.clamp_min(counts[idx], 1.0)


def _joint_scales(n_rows: int, pos: torch.Tensor, negatives: torch.Tensor,
                  weights: Optional[torch.Tensor] = None):
    """Row scales of a positive ``[B]`` and its negatives ``[B, K]``
    scattering into one table, counted jointly."""
    joint = torch.cat([pos[:, None], negatives], dim=1)
    if weights is None:
        w = torch.ones(joint.shape, dtype=torch.float32, device=pos.device)
    else:
        w = weights[:, None].expand(joint.shape)
    counts = _row_sums(n_rows, joint.reshape(-1), w.reshape(-1))
    return (1.0 / torch.clamp_min(counts[pos], 1.0),
            1.0 / torch.clamp_min(counts[negatives], 1.0))


def _sigmoid_scores(h, v_pos, v_neg):
    s_pos = torch.sigmoid(torch.sum(h * v_pos, dim=-1))             # [B]
    s_neg = torch.sigmoid(torch.einsum("bd,bkd->bk", h, v_neg))     # [B, K]
    return s_pos, s_neg


def _neg_loss_terms(s_pos, s_neg):
    return (torch.log(s_pos + 1e-10)
            + torch.sum(torch.log(1.0 - s_neg + 1e-10), dim=-1))


def _neg_sampling_math(syn0, syn1neg, centers, contexts, negatives, lr):
    """Skip-gram with negative sampling, one batch of pairs: updates
    ``syn0`` and ``syn1neg`` in place and returns ``(syn0, syn1neg,
    loss)``. centers/contexts ``[B]``, negatives ``[B, K]`` (int), ``lr``
    a float or a device scalar."""
    centers, contexts, negatives = (centers.long(), contexts.long(),
                                    negatives.long())
    h = syn0[centers]                      # [B, D]
    v_pos = syn1neg[contexts]              # [B, D]
    v_neg = syn1neg[negatives]             # [B, K, D]
    s_pos, s_neg = _sigmoid_scores(h, v_pos, v_neg)
    loss = -torch.mean(_neg_loss_terms(s_pos, s_neg))

    g_pos = (s_pos - 1.0) * lr             # [B]
    g_neg = s_neg * lr                     # [B, K]
    grad_h = (g_pos[:, None] * v_pos
              + torch.einsum("bk,bkd->bd", g_neg, v_neg))          # [B, D]
    sc_c = _row_scale(syn0.shape[0], centers)
    _scatter_add(syn0, centers, -grad_h * sc_c[:, None])
    # contexts and negatives both scatter into syn1neg: count them jointly
    sc_pos, sc_neg = _joint_scales(syn1neg.shape[0], contexts, negatives)
    _scatter_add(syn1neg, *_output_updates(h, contexts, negatives,
                                           g_pos * sc_pos, g_neg * sc_neg))
    return syn0, syn1neg, loss


def _output_updates(h, pos, negatives, g_pos, g_neg):
    """The output table's scatter of a NEG step as one ``(idx, values)``:
    the positives' rows ``-g_pos·h`` first, then the negatives'
    ``-g_neg·h`` (the reference's two scatter-adds, in its order)."""
    d = h.shape[-1]
    return (torch.cat([pos, negatives.reshape(-1)]),
            torch.cat([-g_pos[:, None] * h,
                       -(g_neg[..., None] * h[:, None, :]).reshape(-1, d)]))


def _hs_step(syn0, syn1, centers, points, codes, mask, lr):
    """Skip-gram with hierarchical softmax, in place.

    points/codes/mask: ``[B, C]`` padded Huffman paths (mask 0 on
    padding). Objective per node: label = 1 - code; maximize
    log σ((1-2·code)·u·v)."""
    centers, points = centers.long(), points.long()
    h = syn0[centers]                              # [B, D]
    v = syn1[points]                               # [B, C, D]
    u = torch.einsum("bd,bcd->bc", h, v)           # [B, C]
    s = torch.sigmoid(u)
    label = 1.0 - codes
    loss = -torch.sum(mask * torch.log(torch.abs(label - torch.sigmoid(-u))
                                       + 1e-10)) \
        / torch.clamp_min(torch.sum(mask), 1.0)
    g = (s - label) * mask * lr                    # [B, C]
    grad_h = torch.einsum("bc,bcd->bd", g, v)
    sc_c = _row_scale(syn0.shape[0], centers)
    _scatter_add(syn0, centers, -grad_h * sc_c[:, None])
    # inner nodes near the root appear in nearly every path: normalize
    counts1 = _row_sums(syn1.shape[0], points.reshape(-1),
                        mask.reshape(-1))
    sc_p = 1.0 / torch.clamp_min(counts1[points], 1.0)
    _scatter_add(syn1, points.reshape(-1),
                 -((g * sc_p)[..., None] * h[:, None, :])
                 .reshape(-1, h.shape[-1]))
    return syn0, syn1, loss


def _cbow_neg_step(syn0, syn1neg, context_idx, context_mask, targets,
                   negatives, lr):
    """CBOW-NEG, in place: the mean of the context rows predicts the
    target."""
    context_idx, targets, negatives = (context_idx.long(), targets.long(),
                                       negatives.long())
    ctx = syn0[context_idx]                            # [B, W, D]
    m = context_mask[..., None]
    denom = torch.clamp_min(torch.sum(context_mask, dim=-1, keepdim=True),
                            1.0)
    h = torch.sum(ctx * m, dim=1) / denom              # [B, D]
    v_pos = syn1neg[targets]
    v_neg = syn1neg[negatives]
    s_pos, s_neg = _sigmoid_scores(h, v_pos, v_neg)
    loss = -torch.mean(_neg_loss_terms(s_pos, s_neg))
    g_pos = (s_pos - 1.0) * lr
    g_neg = s_neg * lr
    grad_h = (g_pos[:, None] * v_pos
              + torch.einsum("bk,bkd->bd", g_neg, v_neg)) / denom
    # distribute the mean-gradient onto each (unmasked) context row
    counts0 = _row_sums(syn0.shape[0], context_idx.reshape(-1),
                        context_mask.reshape(-1))
    sc0 = (1.0 / torch.clamp_min(counts0[context_idx], 1.0))[..., None]
    upd = grad_h[:, None, :].expand(ctx.shape) * m * sc0
    _scatter_add(syn0, context_idx.reshape(-1),
                 -upd.reshape(-1, ctx.shape[-1]))
    sc_pos, sc_neg = _joint_scales(syn1neg.shape[0], targets, negatives)
    _scatter_add(syn1neg, *_output_updates(h, targets, negatives,
                                           g_pos * sc_pos, g_neg * sc_neg))
    return syn0, syn1neg, loss


def uniform_init(seed: int, shape, device, low: float = 0.0,
                 high: float = 1.0) -> torch.Tensor:
    """``U(low, high)`` float32 draws from a CPU ``torch.Generator`` seeded
    with ``seed``, moved to ``device``: the card and the CPU start from the
    same tables. (The reference draws with ``jax.random``, which torch
    cannot replay: ``models.convert.load_embeddings_from_jax`` carries its
    tables across instead.)"""
    gen = torch.Generator().manual_seed(int(seed))
    t = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    if (low, high) != (0.0, 1.0):
        t = t * (high - low) + low
    return t.to(device)


def to_host(t) -> Optional[np.ndarray]:
    """A table as a numpy array (tensors from any device, arrays as they
    are)."""
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


# ---------------------------------------------------------------------------
# Word2Vec
# ---------------------------------------------------------------------------


class Word2Vec:
    class Builder:
        def __init__(self):
            self._kw = {}

        def min_word_frequency(self, v):
            self._kw["min_word_frequency"] = int(v)
            return self

        def layer_size(self, v):
            self._kw["layer_size"] = int(v)
            return self

        def window_size(self, v):
            self._kw["window_size"] = int(v)
            return self

        def negative_sample(self, v):
            self._kw["negative"] = int(v)
            return self

        def use_hierarchic_softmax(self, b: bool):
            self._kw["hierarchic_softmax"] = bool(b)
            return self

        def elements_learning_algorithm(self, name: str):
            # "SkipGram" | "CBOW" (ElementsLearningAlgorithm SPI)
            self._kw["algorithm"] = name.lower()
            return self

        def iterations(self, v):
            self._kw["iterations"] = int(v)
            return self

        def epochs(self, v):
            self._kw["epochs"] = int(v)
            return self

        def learning_rate(self, v):
            self._kw["learning_rate"] = float(v)
            return self

        def min_learning_rate(self, v):
            self._kw["min_learning_rate"] = float(v)
            return self

        def sampling(self, v):
            self._kw["sampling"] = float(v)
            return self

        def batch_size(self, v):
            self._kw["batch_size"] = int(v)
            return self

        def seed(self, v):
            self._kw["seed"] = int(v)
            return self

        def iterate(self, sentence_iterator: SentenceIterator):
            self._kw["sentence_iterator"] = sentence_iterator
            return self

        def tokenizer_factory(self, tf: TokenizerFactory):
            self._kw["tokenizer_factory"] = tf
            return self

        def device(self, v):
            self._kw["device"] = v
            return self

        def build(self) -> "Word2Vec":
            return Word2Vec(**self._kw)

    def __init__(self, sentence_iterator: Optional[SentenceIterator] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 5, layer_size: int = 100,
                 window_size: int = 5, negative: int = 5,
                 hierarchic_softmax: bool = False, algorithm: str = "skipgram",
                 iterations: int = 1, epochs: int = 1,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4, sampling: float = 0.0,
                 batch_size: int = 16384, seed: int = 42,
                 table_size: int = 100_000, device=None):
        self.device = resolve_device(device)
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.layer_size = layer_size
        self.window_size = window_size
        self.negative = negative
        self.hierarchic_softmax = hierarchic_softmax or negative == 0
        self.algorithm = algorithm
        self.iterations = iterations
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.sampling = sampling
        self.batch_size = batch_size
        self.seed = seed
        self.table_size = table_size

        self.vocab: Optional[VocabCache] = None
        self.syn0: Optional[torch.Tensor] = None
        self.syn1: Optional[torch.Tensor] = None      # HS inner nodes
        self.syn1neg: Optional[torch.Tensor] = None   # NEG output table
        self._table: Optional[np.ndarray] = None
        self._rng = np.random.default_rng(seed)
        self._norm_cache: Optional[np.ndarray] = None
        # fused-epoch state (nlp/epoch_kernels): chunk-boundary hooks, the
        # program cache, and the chunk counter
        self.listeners: list = []
        self.iteration_count = 0
        self._train_dispatches = 0
        self._epochs_done = 0
        self._epoch_steps: Dict[tuple, object] = {}
        self._sharding_registry = None  # row-sharded tables over a mesh
        self._corpus_cache = None
        self._score = None  # the last batch's loss (a device scalar)

    # ------------------------------------------------------------------
    def _sentences_tokens(self) -> Iterable[List[str]]:
        self.sentence_iterator.reset()
        for sentence in self.sentence_iterator:
            yield self.tokenizer_factory.create(sentence).get_tokens()

    def build_vocab(self):
        self.vocab = build_vocab(self._sentences_tokens(),
                                 self.min_word_frequency)
        if self.hierarchic_softmax:
            Huffman(self.vocab).build()
        else:
            self._table = unigram_table(self.vocab, self.table_size)
        return self

    def reset_weights(self):
        n, d = self.vocab.num_words(), self.layer_size
        # word2vec init: U(-0.5/d, 0.5/d) for syn0, zeros for output tables
        self.syn0 = (uniform_init(self.seed, (n, d), self.device) - 0.5) / d
        if self.hierarchic_softmax:
            self.syn1 = torch.zeros((max(n - 1, 1), d), dtype=torch.float32,
                                    device=self.device)
        else:
            self.syn1neg = torch.zeros((n, d), dtype=torch.float32,
                                       device=self.device)
        self._norm_cache = None
        return self

    # ------------------------------------------------------------------
    def _corpus_indices(self, subsample: bool = True) -> List[np.ndarray]:
        """Sentences as filtered index arrays with frequent-word
        subsampling (SkipGram's sampling logic): one dict lookup per
        token, then numpy masking.

        ``subsample=False`` keeps frequent words: the fused corpus cache
        (``nlp/epoch_kernels``) drains raw indices and draws the SAME
        ``subsample_keep_prob`` table on the device, per epoch."""
        out = []
        tok2idx = {w.word: w.index for w in self.vocab.vocab_words()}
        keep_prob = None
        if subsample and self.sampling > 0:
            keep_prob = subsample_keep_prob(self.vocab, self.sampling)
        for tokens in self._sentences_tokens():
            if not tokens:
                continue
            idx = np.fromiter((tok2idx.get(t, -1) for t in tokens),
                              np.int32, count=len(tokens))
            idx = idx[idx >= 0]
            if keep_prob is not None and len(idx):
                idx = idx[self._rng.random(len(idx)) < keep_prob[idx]]
            if len(idx) > 1:
                out.append(idx)
        return out

    def _emit_pairs(self, sentences: List[np.ndarray]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(center, context) with word2vec's reduced window, emitted with
        O(window) whole-corpus numpy passes: for each offset d, a pair
        (i, i±d) exists iff both positions share a sentence and the
        center's reduced window b_i >= d."""
        if not sentences:
            return (np.zeros((0,), np.int32), np.zeros((0,), np.int32))
        lens = np.asarray([len(s) for s in sentences])
        words = np.concatenate(sentences)
        sid = np.repeat(np.arange(len(sentences)), lens)
        b = self._rng.integers(1, self.window_size + 1, len(words))
        centers_parts: List[np.ndarray] = []
        contexts_parts: List[np.ndarray] = []
        for d in range(1, self.window_size + 1):
            if d >= len(words):
                break
            same = sid[:-d] == sid[d:]
            m_left = same & (b[:-d] >= d)   # center at i, context at i+d
            m_right = same & (b[d:] >= d)   # center at i+d, context at i
            centers_parts.append(words[:-d][m_left])
            contexts_parts.append(words[d:][m_left])
            centers_parts.append(words[d:][m_right])
            contexts_parts.append(words[:-d][m_right])
        return (np.concatenate(centers_parts).astype(np.int32),
                np.concatenate(contexts_parts).astype(np.int32))

    # ------------------------------------------------------------------
    # the fused whole-epoch path (nlp/epoch_kernels)
    # ------------------------------------------------------------------
    def build_corpus_cache(self, budget_mb: Optional[float] = None,
                           mesh=None):
        """Stage the corpus on the device for fused training (None over
        budget or for an empty corpus: callers fall back to the host
        loop). ``mesh=`` records the mesh the run is split over."""
        from deeplearning4j_tpu_torch.nlp import epoch_kernels

        if self.vocab is None:
            self.build_vocab()
        cache = epoch_kernels.SkipGramCorpusCache.build(
            self, budget_mb=budget_mb, mesh=mesh)
        self._corpus_cache = cache
        return cache

    def _fused_mode(self, mesh) -> str:
        """How the fused run goes on ``mesh``: ``"rows"`` (tables
        row-sharded over ``model``), ``"dp"`` (each batch split over
        ``data``), or ``"single"`` (no mesh, or a mesh of one device)."""
        import logging

        from deeplearning4j_tpu_torch.nlp.epoch_kernels import (
            w2v_row_shard_mode)
        from deeplearning4j_tpu_torch.parallel.mesh import data_axis_size
        from deeplearning4j_tpu_torch.parallel.sharding_registry import (
            model_axis_size)

        if mesh is None:
            return "single"
        tp = model_axis_size(mesh)
        mode = w2v_row_shard_mode()
        if tp > 1 and mode != "0":
            if self.vocab.num_words() % tp == 0:
                return "rows"
            if mode == "1":
                logging.getLogger(__name__).warning(
                    "DL4J_W2V_ROW_SHARD=1 but vocab %d does not tile the "
                    "model axis (size %d) — tables stay replicated",
                    self.vocab.num_words(), tp)
        if data_axis_size(mesh) > 1:
            return "dp"
        return "single"

    def _register_tables(self, cache):
        """syn0/syn1neg into the sharding registry: row-sharded over
        ``model`` when ``_fused_mode`` says so, else replicated. Keeps
        this rank's part of the live tables and stamps
        ``_sharding_registry``."""
        from deeplearning4j_tpu_torch.parallel.sharding_registry import (
            ShardingRegistry)

        mesh = cache.mesh
        if mesh is None:
            self._sharding_registry = None
            return None
        tables = {"syn0": self.syn0, "syn1neg": self.syn1neg}
        reg = ShardingRegistry.for_embedding_tables(
            tables, mesh, row_shard=(self._fused_mode(mesh) == "rows"),
            name=type(self).__name__)
        placed = reg.place(tables)
        self.syn0, self.syn1neg = placed["syn0"], placed["syn1neg"]
        self._sharding_registry = reg
        return reg

    def gather_tables(self):
        """The whole ``(syn0, syn1neg)``: gathered from every rank's rows
        after a row-sharded run (every rank calls it), else the live
        tables."""
        reg = getattr(self, "_sharding_registry", None)
        tables = {"syn0": self.syn0, "syn1neg": self.syn1neg}
        if reg is not None:
            tables = reg.gather(tables)
        return tables["syn0"], tables["syn1neg"]

    def _skipgram_program(self, cache):
        """The chunk program for ``cache``'s geometry and mode, built once
        and kept in ``_epoch_steps``."""
        from deeplearning4j_tpu_torch.nlp.epoch_kernels import (
            SkipGramChunk, SkipGramMeshChunk)

        mode = self._fused_mode(cache.mesh)
        key = (self.vocab.num_words(), self.layer_size, cache.n_batches,
               cache.batch, cache.window, cache.negative, mode,
               cache.n_shard)
        prog = self._epoch_steps.get(key)
        if prog is None:
            prog = (SkipGramChunk(self, cache, key) if mode == "single"
                    else SkipGramMeshChunk(self, cache, key, mode))
            self._epoch_steps[key] = prog
        return prog

    def _host_fallback(self, num_epochs: int):
        """Host pair-loop fallback for ``fit_epochs`` (HS/CBOW, fused
        disabled, or cache over budget): run ``fit()`` for exactly
        ``num_epochs`` without disturbing the configured schedule."""
        saved = self.epochs
        try:
            self.epochs = num_epochs
            self.fit()
        finally:
            self.epochs = saved
        self._epochs_done += num_epochs
        return None

    def fit_epochs(self, num_epochs: Optional[int] = None, *,
                   cache=None, chunk_epochs: Optional[int] = None,
                   on_chunk=None, mesh=None,
                   budget_mb: Optional[float] = None, _plan=None):
        """Fused whole-epoch training: each epoch's plan drawn on the
        device from that epoch's generator, then one captured batch step
        replayed per batch. Returns the ``[E, N]`` loss history (a device
        tensor), or ``None`` when the host loop ran instead (HS/CBOW,
        ``DL4J_W2V_FUSED=0``, or a cache over the device-memory budget:
        the reference's fallback contract; the loop runs on this model's
        device). ``mesh=`` runs over that mesh (see the module).

        ``_plan`` (tests) is a list of per-epoch plans ``(centers,
        contexts, valid, negatives)`` shaped ``[N, B]``, ``[N, B]``,
        ``[N, B]``, ``[N, B, K]`` that replace the drawn ones."""
        from deeplearning4j_tpu_torch.nlp import epoch_kernels

        if num_epochs is None:
            num_epochs = self.epochs
        num_epochs = int(num_epochs)
        if num_epochs <= 0:
            return None
        if self.vocab is None:
            self.build_vocab()
        if self.syn0 is None:
            self.reset_weights()
        if (self.hierarchic_softmax or self.algorithm == "cbow"
                or not epoch_kernels.w2v_fused_enabled()):
            return self._host_fallback(num_epochs)
        if cache is None:
            cache = self._corpus_cache
            if cache is None or (mesh is not None
                                 and cache.mesh is not mesh):
                cache = self.build_corpus_cache(budget_mb=budget_mb,
                                                mesh=mesh)
        if cache is None:
            return self._host_fallback(num_epochs)
        self._corpus_cache = cache
        if (cache.mesh is not None
                and getattr(self, "_sharding_registry", None) is None):
            self._register_tables(cache)
        hist = epoch_kernels.drive_skipgram_chunks(
            self, cache, num_epochs, chunk_epochs=chunk_epochs,
            on_chunk=on_chunk, plans=_plan)
        self._norm_cache = None
        return hist

    # ------------------------------------------------------------------
    def fit(self) -> "Word2Vec":
        if self.vocab is None:
            self.build_vocab()
        if self.syn0 is None:
            self.reset_weights()
        sentences = self._corpus_indices()
        if self.hierarchic_softmax:
            points_tbl, codes_tbl, mask_tbl = padded_huffman_paths(
                self.vocab)

        total_steps = 0
        planned = max(1, self.epochs * self.iterations)
        for epoch in range(self.epochs):
            for _ in range(self.iterations):
                centers, contexts = self._emit_pairs(sentences)
                order = self._rng.permutation(len(centers))
                centers, contexts = centers[order], contexts[order]
                # tiny corpora: shrink the batch so each epoch still takes
                # several steps (batched mean-updates need step count)
                batch_size = min(self.batch_size, max(32, len(centers) // 8))
                for start in range(0, len(centers), batch_size):
                    frac = total_steps / max(1, planned * max(
                        1, len(centers) // batch_size))
                    lr = max(self.min_learning_rate,
                             self.learning_rate * (1.0 - frac))
                    c = centers[start:start + batch_size]
                    x = contexts[start:start + batch_size]
                    if len(c) < batch_size:
                        # wrap-around pad to the constant batch shape, as
                        # the reference does (duplicate pairs collapse to
                        # a mean under the per-row scaling)
                        c = np.resize(c, batch_size)
                        x = np.resize(x, batch_size)
                    if self.hierarchic_softmax:
                        self.syn0, self.syn1, loss = _hs_step(
                            self.syn0, self.syn1, self._dev(c),
                            self._dev(points_tbl[x]),
                            self._dev(codes_tbl[x]),
                            self._dev(mask_tbl[x]), lr)
                    elif self.algorithm == "cbow":
                        # reuse pairs as (target, single-context) CBOW
                        negs = self._sample_negatives(len(c), x)
                        self.syn0, self.syn1neg, loss = _cbow_neg_step(
                            self.syn0, self.syn1neg,
                            self._dev(x[:, None]),
                            torch.ones((len(x), 1), dtype=torch.float32,
                                       device=self.device),
                            self._dev(c), self._dev(negs), lr)
                    else:
                        loss = self._neg_batch(c, x, lr)
                    self._score = loss
                    total_steps += 1
        self._norm_cache = None
        return self

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array on this model's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _neg_batch(self, c: np.ndarray, x: np.ndarray, lr: float):
        """One NEG skip-gram batch."""
        negs = self._sample_negatives(len(c), x)
        self.syn0, self.syn1neg, loss = _neg_sampling_math(
            self.syn0, self.syn1neg, self._dev(c), self._dev(x),
            self._dev(negs), lr)
        return loss

    def _sample_negatives(self, b: int, positives: np.ndarray) -> np.ndarray:
        k = max(1, self.negative)
        draws = self._table[self._rng.integers(0, len(self._table), (b, k))]
        # resample collisions with the positive once (cheap approximation of
        # the reference's redraw loop)
        collide = draws == positives[:, None]
        if collide.any():
            redraws = self._table[self._rng.integers(0, len(self._table),
                                                     collide.sum())]
            draws[collide] = redraws
        return draws.astype(np.int32)

    # ------------------------------------------------------------------
    # lookups (wordvectors/WordVectorsImpl + BasicModelUtils), on the host
    # ------------------------------------------------------------------
    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        idx = self.vocab.index_of(word)
        if idx < 0:
            return None
        return to_host(self.syn0[idx])

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.has_token(word)

    def _normed(self) -> np.ndarray:
        if self._norm_cache is None:
            m = to_host(self.syn0)
            self._norm_cache = m / (np.linalg.norm(m, axis=1, keepdims=True)
                                    + 1e-12)
        return self._norm_cache

    def similarity(self, w1: str, w2: str) -> float:
        i, j = self.vocab.index_of(w1), self.vocab.index_of(w2)
        if i < 0 or j < 0:
            return float("nan")
        n = self._normed()
        return float(np.dot(n[i], n[j]))

    def words_nearest(self, positive, negative=(), top_n: int = 10
                      ) -> List[str]:
        """Analogy-style nearest words (BasicModelUtils.wordsNearest)."""
        if isinstance(positive, str):
            positive = [positive]
        n = self._normed()
        query = np.zeros(self.layer_size, np.float32)
        exclude = set()
        for w in positive:
            idx = self.vocab.index_of(w)
            if idx >= 0:
                query += n[idx]
                exclude.add(idx)
        for w in negative:
            idx = self.vocab.index_of(w)
            if idx >= 0:
                query -= n[idx]
                exclude.add(idx)
        query /= (np.linalg.norm(query) + 1e-12)
        sims = n @ query
        for idx in exclude:
            sims[idx] = -np.inf
        top = np.argsort(-sims)[:top_n]
        return [self.vocab.word_at_index(int(i)) for i in top]

    def vocab_size(self) -> int:
        return self.vocab.num_words() if self.vocab else 0
