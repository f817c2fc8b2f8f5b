"""Port parity for Word2Vec and its fused whole-epoch skip-gram
(``deeplearning4j_tpu_torch/nlp/word2vec.py``, ``nlp/epoch_kernels.py``)
against ``deeplearning4j_tpu`` on the CPU, at small sizes (vocab 40,
``layer_size`` 16, 70 sentences).

Tolerances:

- single steps, float32 rtol 1e-4 / atol 1e-6: the same gathers and
  products, but each package sums a row's repeated updates in its own
  order (XLA's scatter against ``index_put_``'s sorted order), which
  moves a float32 sum by a few ulps of its largest term;
- whole runs, rtol 1e-4 / atol 1e-5: the reference's own gate for its
  fused path against its eager replay (``tests/test_nlp_fused.py``),
  since the ulps above compound over every step of an epoch.

The host loop's draws are numpy's in both packages, so ``fit`` makes the
same pairs and negatives. The fused plan is drawn from ``torch``
generators, which cannot replay ``jax.random``: the JAX plan is fed to the
port through ``fit_epochs(_plan=...)``, and the port's own plan is held
to the host emitter's distribution.
"""

import numpy as np
import pytest
import torch
from scipy import stats

import jax.numpy as jnp

from deeplearning4j_tpu.nlp import epoch_kernels as jax_ek
from deeplearning4j_tpu.nlp import word2vec as jax_w2v
from deeplearning4j_tpu.nlp.sentence_iterator import (
    CollectionSentenceIterator as JaxCollection,
)
from deeplearning4j_tpu_torch.models.convert import load_embeddings_from_jax
from deeplearning4j_tpu_torch.nlp import epoch_kernels as ek
from deeplearning4j_tpu_torch.nlp import word2vec as w2v_mod
from deeplearning4j_tpu_torch.nlp import (
    CollectionSentenceIterator,
    Word2Vec,
)

STEP_TOL = dict(rtol=1e-4, atol=1e-6)
RUN_TOL = dict(rtol=1e-4, atol=1e-5)


def _sentences(seed=12345, n_words=40, n_sent=70, lo=3, hi=12):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)]
    return [" ".join(rng.choice(words, size=rng.integers(lo, hi)))
            for _ in range(n_sent)]


def _kw(**kw):
    out = dict(min_word_frequency=1, layer_size=16, window_size=3,
               negative=5, seed=0, epochs=2)
    out.update(kw)
    return out


def _pair(sents, **kw):
    """A JAX model and a port model with the same vocab and tables."""
    ref = jax_w2v.Word2Vec(JaxCollection(sents), **_kw(**kw))
    ref.build_vocab()
    ref.reset_weights()
    port = Word2Vec(CollectionSentenceIterator(sents), device="cpu",
                    **_kw(**kw))
    port.build_vocab()
    load_embeddings_from_jax(port, ref)
    return ref, port


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _tables(seed, v=12, d=8, out_rows=None):
    rng = np.random.default_rng(seed)
    syn0 = rng.normal(0, 0.3, (v, d)).astype(np.float32)
    syn1 = rng.normal(0, 0.3, (out_rows or v, d)).astype(np.float32)
    return syn0, syn1


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# single steps, with repeated rows in the batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lr", [0.025, 0.4])
def test_neg_sampling_step(lr):
    syn0, syn1 = _tables(1)
    rng = np.random.default_rng(2)
    c = rng.integers(0, 4, 48).astype(np.int32)       # 4 rows, 48 pairs
    x = rng.integers(0, 12, 48).astype(np.int32)
    negs = rng.integers(0, 6, (48, 5)).astype(np.int32)
    r0, r1, rl = jax_w2v._neg_sampling_math(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(c),
        jnp.asarray(x), jnp.asarray(negs), lr)
    p0, p1, pl = w2v_mod._neg_sampling_math(_t(syn0), _t(syn1), _t(c),
                                            _t(x), _t(negs), lr)
    _close(p0, r0, STEP_TOL)
    _close(p1, r1, STEP_TOL)
    _close(pl, rl, STEP_TOL)


def test_hs_step():
    syn0, syn1 = _tables(3, v=12, out_rows=11)
    rng = np.random.default_rng(4)
    c = rng.integers(0, 3, 40).astype(np.int32)
    points = rng.integers(0, 11, (40, 4)).astype(np.int32)
    codes = rng.integers(0, 2, (40, 4)).astype(np.float32)
    mask = (rng.random((40, 4)) < 0.7).astype(np.float32)
    r0, r1, rl = jax_w2v._hs_step(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(c),
        jnp.asarray(points), jnp.asarray(codes), jnp.asarray(mask), 0.1)
    p0, p1, pl = w2v_mod._hs_step(_t(syn0), _t(syn1), _t(c), _t(points),
                                  _t(codes), _t(mask), 0.1)
    _close(p0, r0, STEP_TOL)
    _close(p1, r1, STEP_TOL)
    _close(pl, rl, STEP_TOL)


def test_cbow_neg_step():
    syn0, syn1 = _tables(5)
    rng = np.random.default_rng(6)
    ctx = rng.integers(0, 5, (32, 3)).astype(np.int32)
    cmask = (rng.random((32, 3)) < 0.8).astype(np.float32)
    tgt = rng.integers(0, 4, 32).astype(np.int32)
    negs = rng.integers(0, 12, (32, 5)).astype(np.int32)
    r0, r1, rl = jax_w2v._cbow_neg_step(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(ctx),
        jnp.asarray(cmask), jnp.asarray(tgt), jnp.asarray(negs), 0.05)
    p0, p1, pl = w2v_mod._cbow_neg_step(_t(syn0), _t(syn1), _t(ctx),
                                        _t(cmask), _t(tgt), _t(negs), 0.05)
    _close(p0, r0, STEP_TOL)
    _close(p1, r1, STEP_TOL)
    _close(pl, rl, STEP_TOL)


def test_neg_epoch_step_masked():
    syn0, syn1 = _tables(7)
    rng = np.random.default_rng(8)
    c = rng.integers(0, 4, 64).astype(np.int32)
    x = rng.integers(0, 12, 64).astype(np.int32)
    valid = (rng.random(64) < 0.6).astype(np.float32)
    negs = rng.integers(0, 6, (64, 5)).astype(np.int32)
    lr = np.float32(0.3)
    r0, r1, rl = jax_ek._neg_epoch_impl(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(c),
        jnp.asarray(x), jnp.asarray(valid), jnp.asarray(negs),
        jnp.asarray(lr))
    p0, p1, pl = ek._neg_epoch_math(_t(syn0), _t(syn1), _t(c), _t(x),
                                    _t(valid), _t(negs), _t(lr))
    _close(p0, r0, STEP_TOL)
    _close(p1, r1, STEP_TOL)
    _close(pl, rl, STEP_TOL)


def test_scatter_add_is_deterministic_and_sums_repeats():
    idx = torch.tensor([3, 1, 3, 3, 0, 1])
    vals = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    a = w2v_mod._scatter_add(torch.zeros(5, 2), idx, vals)
    b = w2v_mod._scatter_add(torch.zeros(5, 2), idx, vals)
    assert torch.equal(a, b)
    want = np.zeros((5, 2), np.float32)
    np.add.at(want, idx.numpy(), vals.numpy())
    np.testing.assert_array_equal(a.numpy(), want)


@pytest.mark.parametrize("rest", [(), (3,)])
def test_spread_row_sums_equal_the_plain_sums(rest):
    """The CUDA path's spread of hot rows' repeats (run here on CPU
    tensors) sums to the plain per-row sums; integer values, so exact in
    any order."""
    rng = np.random.default_rng(9)
    n = w2v_mod.HOT_ROWS + 40
    idx = np.concatenate([np.zeros(700, np.int64),            # one hot row
                          rng.integers(0, n, 900)])
    rng.shuffle(idx)
    vals = rng.integers(-5, 6, (len(idx),) + rest).astype(np.float32)
    got = w2v_mod._spread_row_sums(n, torch.from_numpy(idx),
                                   torch.from_numpy(vals))
    want = np.zeros((n,) + rest, np.float32)
    np.add.at(want, idx, vals)
    np.testing.assert_array_equal(got.numpy(), want)
    small = w2v_mod._spread_row_sums(5, torch.tensor([4, 4, 0]),
                                     torch.ones(3))
    np.testing.assert_array_equal(small.numpy(), [1, 0, 0, 0, 2])


# ---------------------------------------------------------------------------
# whole runs of the host loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("algo", [
    dict(), dict(hierarchic_softmax=True), dict(algorithm="cbow"),
    dict(sampling=1e-2)], ids=["skipgram-neg", "skipgram-hs", "cbow-neg",
                               "subsampled"])
def test_fit_one_epoch_matches_reference(algo):
    sents = _sentences()
    ref, port = _pair(sents, epochs=1, **algo)
    ref.fit()
    port.fit()
    _close(port.syn0, ref.syn0, RUN_TOL)
    out = "syn1" if port.hierarchic_softmax else "syn1neg"
    _close(getattr(port, out), getattr(ref, out), RUN_TOL)
    # the numpy draws stayed in step
    assert port._rng.integers(1 << 30) == ref._rng.integers(1 << 30)


def test_lookups_match_reference():
    sents = _sentences()
    ref, port = _pair(sents, epochs=1)
    ref.fit()
    port.fit()
    pairs = [("w1", "w2"), ("w3", "w30"), ("w0", "w39"), ("w5", "w5")]
    for a, b in pairs:
        assert port.similarity(a, b) == pytest.approx(ref.similarity(a, b),
                                                      rel=1e-3, abs=1e-4)
    assert np.isnan(port.similarity("w1", "nope"))
    np.testing.assert_allclose(port.get_word_vector("w7"),
                               ref.get_word_vector("w7"), **RUN_TOL)
    assert port.get_word_vector("nope") is None
    assert port.words_nearest("w3", top_n=40)[:1] == \
        ref.words_nearest("w3", top_n=40)[:1]
    assert port.vocab_size() == ref.vocab_size() == 40


# ---------------------------------------------------------------------------
# the corpus cache and the fused path against the reference
# ---------------------------------------------------------------------------
def test_corpus_cache_matches_reference():
    sents = _sentences() + ["w0", "w1 w2"]
    ref, port = _pair(sents, window_size=2)
    rc = jax_ek.SkipGramCorpusCache.build(ref)
    pc = ek.SkipGramCorpusCache.build(port)
    for name in ("tokens", "mask", "keep_prob", "table"):
        np.testing.assert_array_equal(_np(getattr(pc, name)),
                                      np.asarray(getattr(rc, name)))
    assert pc.describe() == rc.describe()
    assert pc.n_pairs == ek.pair_capacity(pc.n_sentences,
                                          pc.tokens.shape[1], 2)


def test_cache_budget_and_batch_rounding():
    sents = _sentences()
    _, port = _pair(sents)
    assert ek.SkipGramCorpusCache.build(port, budget_mb=1e-3) is None
    cache = ek.SkipGramCorpusCache.build(port, batch=37)
    assert cache.batch == 40 and cache.n_batches == -(-cache.n_pairs // 40)
    cache = ek.SkipGramCorpusCache.build(port)
    assert cache.batch == max(32, cache.n_pairs // 8) + \
        (-max(32, cache.n_pairs // 8)) % 8


def _jax_plans(ref, cache, start, count):
    keys = jax_ek.epoch_keys_for(ref.seed, start, count)
    return [tuple(np.asarray(a) for a in jax_ek.skipgram_epoch_plan(
        keys[e], cache.tokens, cache.mask, cache.keep_prob, cache.table,
        cache.window, cache.negative, cache.n_batches, cache.batch))
        for e in range(count)]


def test_fit_epochs_with_the_reference_plan_matches_reference():
    """The port's fused chunk fed the JAX plan (``_plan``) against the
    reference's fused program: the same pairs, negatives and schedule."""
    sents = _sentences()
    ref, port = _pair(sents, epochs=2)
    cache = ref.build_corpus_cache()
    plans = _jax_plans(ref, cache, 0, 2)
    ref_hist = ref.fit_epochs(2)
    hist = port.fit_epochs(2, _plan=plans)
    assert tuple(hist.shape) == (2, cache.n_batches)
    _close(hist, ref_hist, RUN_TOL)
    _close(port.syn0, ref.syn0, RUN_TOL)
    _close(port.syn1neg, ref.syn1neg, RUN_TOL)
    assert port._train_dispatches == 1 and port.iteration_count == \
        ref.iteration_count


def test_fused_chunk_equals_the_step_applied_batch_by_batch():
    """``fit_epochs`` against its own plan applied per batch through
    ``_neg_epoch_math`` with the reference's learning-rate schedule:
    bitwise (the same ops in the same order). Each batch is taken with
    ``index_select`` as the step takes it: a view at another offset can
    round differently on the CPU's vectorized kernels."""
    sents = _sentences()
    _, fused = _pair(sents, epochs=2)
    _, eager = _pair(sents, epochs=2)
    cache = fused.build_corpus_cache()
    hist = fused.fit_epochs(2)
    s0, s1 = eager.syn0.clone(), eager.syn1neg.clone()
    planned = torch.tensor(2.0 * cache.n_batches)
    it = torch.tensor(0.0)
    lr0, min_lr = torch.tensor(eager.learning_rate), \
        torch.tensor(eager.min_learning_rate)
    want = torch.zeros(2, cache.n_batches)
    for e, seed in enumerate(ek.epoch_keys_for(eager.seed, 0, 2)):
        plan = cache.plan(ek.epoch_generator(seed, "cpu"))
        for n in range(cache.n_batches):
            lr = torch.maximum(min_lr, lr0 * (1.0 - it / planned))
            i = torch.tensor([n])
            _, _, loss = ek._neg_epoch_math(
                s0, s1, *(p.index_select(0, i).squeeze(0) for p in plan), lr)
            want[e, n] = loss
            it += 1.0
    assert torch.equal(hist, want)
    assert torch.equal(fused.syn0, s0) and torch.equal(fused.syn1neg, s1)


# ---------------------------------------------------------------------------
# the port's own plan, in distribution
# ---------------------------------------------------------------------------
def test_plan_window1_matches_host_emitter_multiset():
    """At window=1 the reduced window is deterministic and sampling is
    off, so the plan's valid pairs are exactly the host emitter's."""
    _, port = _pair(_sentences(), window_size=1, sampling=0.0)
    sentences = port._corpus_indices(subsample=False)
    host_c, host_x = port._emit_pairs(sentences)
    cache = ek.SkipGramCorpusCache.build(port)
    cen, ctx, val = ek.skipgram_pair_plan(
        ek.epoch_generator(7, "cpu"), cache.tokens, cache.mask,
        cache.keep_prob, cache.window)
    m = val.numpy() > 0
    fused = sorted(zip(cen.numpy()[m].tolist(), ctx.numpy()[m].tolist()))
    assert fused == sorted(zip(host_c.tolist(), host_x.tolist()))


def test_plan_is_seed_deterministic():
    _, port = _pair(_sentences())
    cache = ek.SkipGramCorpusCache.build(port)
    a = cache.plan(ek.epoch_generator(3, "cpu"))
    b = cache.plan(ek.epoch_generator(3, "cpu"))
    c = cache.plan(ek.epoch_generator(4, "cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[3], c[3])
    assert ek.epoch_keys_for(0, 2, 2) == ek.epoch_keys_for(0, 0, 4)[2:]


def test_plan_negatives_follow_the_unigram_table():
    """Chi-square at p 0.001 of the plan's negatives against what one
    collision redraw makes of the unigram table: for a slot whose context
    is c, P(w) = q_w·[w != c] + q_c·q_w."""
    _, port = _pair(_sentences(), negative=5)
    cache = ek.SkipGramCorpusCache.build(port)
    _, ctx, _, negs = cache.plan(ek.epoch_generator(11, "cpu"))
    v = port.vocab.num_words()
    q = np.bincount(cache.table.numpy(), minlength=v) / cache.table.numel()
    c = ctx.numpy().reshape(-1)
    per_slot = q[None, :] * (np.arange(v)[None, :] != c[:, None]) \
        + (q[c])[:, None] * q[None, :]
    expected = per_slot.sum(0) * cache.negative
    observed = np.bincount(negs.numpy().reshape(-1), minlength=v)
    keep = expected >= 5
    obs = np.append(observed[keep], observed[~keep].sum())
    exp = np.append(expected[keep], expected[~keep].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    exp = exp * obs.sum() / exp.sum()
    _, p = stats.chisquare(obs, exp)
    assert p > 1e-3, p


def test_plan_reduced_window_and_subsampling_rates():
    """The valid share of the pair slots at window 3 against its
    expectation (each side of a pair of offset d valid with P(b >= d)),
    and subsampling's keep rate against ``keep_prob``."""
    _, port = _pair(_sentences(n_sent=400), window_size=3)
    cache = ek.SkipGramCorpusCache.build(port)
    tokens, mask = cache.tokens.numpy(), cache.mask.numpy()
    want = 0.0
    for d in range(1, 4):
        both = (mask[:, :-d] * mask[:, d:]).sum()
        want += 2 * both * (3 - d + 1) / 3
    gen = ek.epoch_generator(5, "cpu")
    _, _, val = ek.skipgram_pair_plan(gen, cache.tokens, cache.mask,
                                      cache.keep_prob, 3)
    got = float(val.sum())
    assert abs(got - want) < 4 * np.sqrt(want), (got, want)
    keep = torch.full_like(cache.keep_prob, 0.5)
    _, _, half = ek.skipgram_pair_plan(ek.epoch_generator(5, "cpu"),
                                       cache.tokens, cache.mask, keep, 3)
    # both ends survive with 0.25: the share of valid pairs drops to 1/4
    assert abs(float(half.sum()) / got - 0.25) < 0.03
    assert tokens.dtype == np.int32


# ---------------------------------------------------------------------------
# resume, chunks, listeners, fallbacks
# ---------------------------------------------------------------------------
def test_resume_equals_one_shot_bitwise():
    sents = _sentences()
    _, split = _pair(sents, epochs=4)
    cache = split.build_corpus_cache()
    h1 = split.fit_epochs(2)
    h2 = split.fit_epochs(2)
    _, oneshot = _pair(sents, epochs=4)
    h = oneshot.fit_epochs(4, cache=ek.SkipGramCorpusCache.build(
        oneshot, batch=cache.batch))
    assert torch.equal(torch.cat([h1, h2]), h)
    assert torch.equal(split.syn0, oneshot.syn0)
    assert torch.equal(split.syn1neg, oneshot.syn1neg)
    assert split._epochs_done == oneshot._epochs_done == 4


def test_chunks_listeners_and_preemption():
    sents = _sentences()
    _, w = _pair(sents, epochs=4)
    w.fit_epochs(4)
    assert w._train_dispatches == 1
    _, chunked = _pair(sents, epochs=4)
    hc = chunked.fit_epochs(4, chunk_epochs=1)
    assert chunked._train_dispatches == 4
    assert torch.equal(hc, torch.cat([hc[i:i + 1] for i in range(4)]))
    calls = []

    class Listener:
        def chunk_done(self, model, it0, hist, metrics=None):
            calls.append((it0, tuple(hist.shape)))

    _, lw = _pair(sents, epochs=3)
    lw.listeners.append(Listener())
    lw.fit_epochs(3)
    n = lw._corpus_cache.n_batches
    assert lw._train_dispatches == 3
    assert calls == [(0, (1, n)), (n, (1, n)), (2 * n, (1, n))]
    _, pw = _pair(sents, epochs=4)
    hist = pw.fit_epochs(4, chunk_epochs=1, on_chunk=lambda d: d >= 2)
    assert hist.shape[0] == 2 and pw._epochs_done == 2


@pytest.mark.parametrize("how", ["hs", "cbow", "env", "budget"])
def test_fallbacks_run_the_host_loop(how, monkeypatch):
    sents = _sentences()
    kw = {"hs": dict(hierarchic_softmax=True),
          "cbow": dict(algorithm="cbow")}.get(how, {})
    _, a = _pair(sents, epochs=3, **kw)
    _, b = _pair(sents, epochs=3, **kw)
    if how == "env":
        monkeypatch.setenv("DL4J_W2V_FUSED", "0")
    got = a.fit_epochs(1, budget_mb=1e-3 if how == "budget" else None)
    assert got is None and a._epochs_done == 1 and a._train_dispatches == 0
    b.epochs = 1
    b.fit()
    assert torch.equal(a.syn0, b.syn0)
    assert a.epochs == 3


def test_mesh_and_row_sharding_raise_naming_a14(monkeypatch):
    """The mesh modes are ported (their world tests are
    tests/test_torch_cluster.py): over a mesh of one device the fused
    run is the meshless one, bitwise; ``DL4J_W2V_ROW_SHARD`` reads as
    the reference's."""
    class MeshOfOne:
        mesh_dim_names, shape = ("data",), (1,)

    _, w = _pair(_sentences())
    _, plain = _pair(_sentences())
    cache = w.build_corpus_cache(mesh=MeshOfOne())
    assert cache.mesh is not None and cache.n_shard == 1
    assert w._fused_mode(MeshOfOne()) == "single"
    assert torch.equal(w.fit_epochs(1, mesh=MeshOfOne()),
                       plain.fit_epochs(1))
    assert torch.equal(w.syn0, plain.syn0)
    assert w._sharding_registry is not None
    assert w._register_tables(plain._corpus_cache) is None
    assert ek.w2v_row_shard_mode() == "auto"
    monkeypatch.setenv("DL4J_W2V_ROW_SHARD", "0")
    assert ek.w2v_row_shard_mode() == "0"
    assert w._fused_mode(None) == "single"
    assert ek.w2v_fused_enabled()


def test_fluent_configuration_and_defaults():
    w = (Word2Vec.Builder().min_word_frequency(1).layer_size(8)
         .window_size(2).negative_sample(3).iterations(1).epochs(1)
         .seed(5).iterate(CollectionSentenceIterator(_sentences()))
         .device("cpu").build())
    assert (w.layer_size, w.window_size, w.negative, w.seed) == (8, 2, 3, 5)
    assert w.device == torch.device("cpu")
    w.fit()
    assert w.syn0.shape == (40, 8) and torch.isfinite(w.syn0).all()
    assert w.fit_epochs(0) is None
