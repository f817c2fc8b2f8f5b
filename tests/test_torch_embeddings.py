"""Port parity for the models built on the word2vec tables: GloVe,
ParagraphVectors, SequenceVectors and DeepWalk
(``deeplearning4j_tpu_torch/nlp/glove.py``, ``paragraph_vectors.py``,
``sequencevectors.py``, ``graph/deepwalk.py``), and the weight carrier
``models/convert.load_embeddings_from_jax``, against ``deeplearning4j_tpu``
on the CPU at small sizes.

Tolerances, as in ``test_torch_word2vec.py``: a single step at float32
rtol 1e-4 / atol 1e-6 (each package sums a row's repeated updates in its
own order), a whole run at rtol 1e-4 / atol 1e-5 (the reference's gate
for its fused paths, ``tests/test_nlp_fused.py``). The reference draws
its initial tables with ``jax.random``; the tests carry them across. GloVe
draws its epoch permutations in the fused run: the JAX ones are fed to
the port through ``fit(_orders=...)``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.graph import DeepWalk as JaxDeepWalk
from deeplearning4j_tpu.graph import Graph as JaxGraph
from deeplearning4j_tpu.graph import RandomWalkIterator as JaxWalks
from deeplearning4j_tpu.nlp import glove as jax_glove
from deeplearning4j_tpu.nlp.paragraph_vectors import (
    ParagraphVectors as JaxPV,
)
from deeplearning4j_tpu.nlp.sentence_iterator import (
    CollectionSentenceIterator as JaxCollection,
)
from deeplearning4j_tpu.nlp.sentence_iterator import (
    LabelAwareSentenceIterator as JaxLabelAware,
)
from deeplearning4j_tpu.nlp.sequencevectors import (
    SequenceVectors as JaxSequenceVectors,
)
from deeplearning4j_tpu_torch.graph import DeepWalk, Graph, RandomWalkIterator
from deeplearning4j_tpu_torch.models.convert import load_embeddings_from_jax
from deeplearning4j_tpu_torch.nlp import (
    CollectionSentenceIterator,
    DistributedWord2Vec,
    Glove,
    ParagraphVectors,
    SequenceVectors,
    Word2Vec,
)
from deeplearning4j_tpu_torch.nlp import glove as port_glove
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
    LabelAwareSentenceIterator,
)

STEP_TOL = dict(rtol=1e-4, atol=1e-6)
RUN_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _sentences(seed=12345, n_words=30, n_sent=60, lo=3, hi=12):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)]
    return [" ".join(rng.choice(words, size=rng.integers(lo, hi)))
            for _ in range(n_sent)]


# ---------------------------------------------------------------------------
# GloVe
# ---------------------------------------------------------------------------
def test_glove_step_with_repeats_and_padding():
    rng = np.random.default_rng(0)
    n, d, b = 10, 6, 48
    tables = [rng.normal(0, 0.2, (n, d)), rng.normal(0, 0.2, (n, d)),
              rng.normal(0, 0.1, n), rng.normal(0, 0.1, n),
              rng.random((n, d)) + 0.1, rng.random((n, d)) + 0.1,
              rng.random(n) + 0.1, rng.random(n) + 0.1]
    tables = [t.astype(np.float32) for t in tables]
    rows = rng.integers(0, 3, b).astype(np.int32)
    cols = rng.integers(0, n, b).astype(np.int32)
    logx = rng.normal(0, 1, b).astype(np.float32)
    fx = np.where(rng.random(b) < 0.7, rng.random(b), 0.0).astype(np.float32)
    ref = jax_glove._glove_step_math(
        *(jnp.asarray(t) for t in tables), jnp.asarray(rows),
        jnp.asarray(cols), jnp.asarray(logx), jnp.asarray(fx),
        jnp.float32(0.05))
    got = port_glove._glove_step_math(
        *(torch.from_numpy(t.copy()) for t in tables),
        torch.from_numpy(rows), torch.from_numpy(cols),
        torch.from_numpy(logx), torch.from_numpy(fx),
        torch.tensor(0.05))
    for g, r in zip(got, ref):
        _close(g, r, STEP_TOL)


def _jax_glove_init(seed, n, d):
    """The eight tables the JAX ``Glove.fit`` makes inside the call."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    scale = 0.5 / d
    w = jax.random.uniform(k1, (n, d), jnp.float32, -scale, scale)
    wc = jax.random.uniform(k2, (n, d), jnp.float32, -scale, scale)
    return dict(w=w, wc=wc, b=np.zeros(n, np.float32),
                bc=np.zeros(n, np.float32),
                hw=np.full((n, d), 1e-8, np.float32),
                hwc=np.full((n, d), 1e-8, np.float32),
                hb=np.full(n, 1e-8, np.float32),
                hbc=np.full(n, 1e-8, np.float32))


def _jax_glove_orders(glove, n_triples, epochs):
    batch = min(glove.batch_size, max(32, n_triples // 8))
    total = -(-n_triples // batch) * batch
    base = jax.random.PRNGKey(glove.seed)
    return [np.asarray(jax.random.permutation(jax.random.fold_in(base, e),
                                              total))
            for e in range(epochs)]


@pytest.mark.parametrize("spill", [False, True])
def test_glove_counts_equal_the_reference(spill, tmp_path):
    sents = _sentences()
    kw = dict(min_word_frequency=1, window_size=3)
    if spill:
        kw.update(max_memory_pairs=40, spill_dir=str(tmp_path))
    ref = jax_glove.Glove(JaxCollection(sents), **kw)
    port = Glove(CollectionSentenceIterator(sents), device="cpu", **kw)
    for m in (ref, port):
        m.vocab = jax_glove.build_vocab(m._sentences_tokens(), 1)
    r, p = ref.count_cooccurrences(), port.count_cooccurrences()
    for a, b in zip(p, r):
        np.testing.assert_array_equal(a, b)
    assert port.spill_count == ref.spill_count


def test_glove_fit_with_the_reference_orders_matches_reference():
    sents = _sentences()
    kw = dict(min_word_frequency=1, layer_size=8, window_size=3, epochs=3,
              seed=2, learning_rate=0.05)
    ref = jax_glove.Glove(JaxCollection(sents), **kw)
    ref.fit()
    port = Glove(CollectionSentenceIterator(sents), device="cpu", **kw)
    port.vocab = jax_glove.build_vocab(port._sentences_tokens(), 1)
    n_triples = len(port.count_cooccurrences()[0])
    load_embeddings_from_jax(port, **_jax_glove_init(
        2, port.vocab.num_words(), 8))
    port.fit(_orders=_jax_glove_orders(ref, n_triples, 3))
    _close(port.syn0, ref.syn0, RUN_TOL)
    assert port._loss == pytest.approx(ref._loss, rel=1e-4, abs=1e-5)
    assert port._train_dispatches == ref._train_dispatches == 1
    assert port.similarity("w1", "w2") == pytest.approx(
        ref.similarity("w1", "w2"), rel=1e-3, abs=1e-4)
    assert port.words_nearest("w3", top_n=3)[0] == \
        ref.words_nearest("w3", top_n=3)[0]


def test_glove_own_orders_resume_per_epoch_and_learn():
    sents = _sentences()
    kw = dict(min_word_frequency=1, layer_size=8, window_size=3, seed=4,
              learning_rate=0.05, device="cpu")
    a = Glove(CollectionSentenceIterator(sents), epochs=4, **kw).fit()
    b = Glove(CollectionSentenceIterator(sents), epochs=4, **kw).fit()
    assert torch.equal(a.syn0, b.syn0)
    assert a._history.shape[0] == 4
    # the loss falls over the epochs (per-epoch means)
    means = a._history.mean(dim=1)
    assert means[-1] < means[0]
    # the first epochs of a longer run draw the same orders
    c = Glove(CollectionSentenceIterator(sents), epochs=2, **kw).fit()
    assert torch.equal(c._history[0], a._history[0])
    empty = Glove(CollectionSentenceIterator(sents), epochs=0, **kw).fit()
    assert np.isnan(empty._loss) and empty.syn0.shape == (30, 8)


# ---------------------------------------------------------------------------
# ParagraphVectors, SequenceVectors, DeepWalk
# ---------------------------------------------------------------------------
def _pv_corpus():
    rng = np.random.default_rng(1)
    animals = ["cat", "dog", "horse", "cow", "sheep", "goat"]
    tech = ["cpu", "gpu", "ram", "disk", "cache", "bus"]
    docs, labels = [], []
    for i in range(12):
        pool = animals if i % 2 == 0 else tech
        docs.append(" ".join(rng.choice(pool, size=6)))
        labels.append(f"{'A' if i % 2 == 0 else 'T'}_{i}")
    return docs, labels


def test_paragraph_vectors_match_reference():
    docs, labels = _pv_corpus()
    kw = dict(min_word_frequency=1, layer_size=12, epochs=2, seed=3,
              learning_rate=0.05)
    ref = JaxPV(sentence_iterator=JaxLabelAware(docs, labels), **kw)
    port = ParagraphVectors(sentence_iterator=LabelAwareSentenceIterator(
        docs, labels), device="cpu", **kw)
    n_rows = 12 + len(docs)
    init = (jax.random.uniform(jax.random.PRNGKey(3), (n_rows, 12),
                               jnp.float32) - 0.5) / 12
    load_embeddings_from_jax(port, syn0=init,
                             syn1neg=np.zeros((12, 12), np.float32))
    ref.fit()
    port.fit()
    _close(port.syn0, ref.syn0, RUN_TOL)
    _close(port.syn1neg, ref.syn1neg, RUN_TOL)
    _close(port.get_label_vector("T_3"), ref.get_label_vector("T_3"),
           RUN_TOL)
    assert port.get_label_vector("nope") is None
    # host numpy on both sides, the same draws: equal up to the tables' gap
    text = "cat dog cow horse"
    _close(port.infer_vector(text), ref.infer_vector(text), RUN_TOL)
    assert port.predict(text) == ref.predict(text)
    assert port.similarity_to_label(text, "A_0") == pytest.approx(
        ref.similarity_to_label(text, "A_0"), rel=1e-3, abs=1e-4)


def test_paragraph_vectors_learn_topics():
    sentences = ["cat dog horse cow"] * 3 + ["cpu gpu ram disk"] * 3
    labels = [f"A_{i}" for i in range(3)] + [f"T_{i}" for i in range(3)]
    pv = (ParagraphVectors.Builder()
          .iterate(LabelAwareSentenceIterator(sentences, labels))
          .min_word_frequency(1).layer_size(16).epochs(200)
          .learning_rate(0.1).seed(3).device("cpu").build())
    pv.fit()
    assert pv.predict("cat dog cow").startswith("A_")
    assert pv.predict("gpu cpu disk").startswith("T_")


def test_sequence_vectors_match_reference():
    rng = np.random.default_rng(5)
    seqs = [[f"item{int(t)}" for t in rng.integers(0, 25, rng.integers(4, 9))]
            for _ in range(50)]
    kw = dict(layer_size=12, window_size=2, negative=4, epochs=1, seed=6)
    ref = JaxSequenceVectors(seqs, **kw)
    port = SequenceVectors(seqs, device="cpu", **kw)
    ref.build_vocab()
    ref.reset_weights()
    port.build_vocab()
    load_embeddings_from_jax(port, ref)
    ref.fit()
    port.fit()
    _close(port.syn0, ref.syn0, RUN_TOL)
    _close(port.syn1neg, ref.syn1neg, RUN_TOL)
    np.testing.assert_allclose(port.get_element_vector("item3"),
                               ref.get_element_vector("item3"), **RUN_TOL)
    assert port.elements_nearest("item3", top_n=1) == \
        ref.elements_nearest("item3", top_n=1)
    built = (SequenceVectors.Builder().iterate(iter(seqs)).layer_size(8)
             .min_element_frequency(2).device("cpu").build())
    assert built.min_word_frequency == 2 and len(built._sequences) == 50
    with pytest.raises(ValueError):
        SequenceVectors.Builder().build()


def _graphs(n=40, seed=9):
    rng = np.random.default_rng(seed)
    edges = [(i, (i + 1) % n) for i in range(n)] + [
        (int(a), int(b)) for a, b in rng.integers(0, n, (n, 2)) if a != b]
    gj, gp = JaxGraph(n), Graph(n)
    for a, b in edges:
        gj.add_edge(a, b)
        gp.add_edge(a, b)
    return gj, gp


def test_deepwalk_matches_reference():
    gj, gp = _graphs()
    ref = JaxDeepWalk(vector_size=8, window_size=3, learning_rate=0.05,
                      batch_size=128, seed=4)
    port = (DeepWalk.Builder().vector_size(8).window_size(3)
            .learning_rate(0.05).batch_size(128).seed(4).device("cpu")
            .build())
    ref.initialize(gj)
    port.initialize(gp)
    # numpy init on both sides: the same tables without carrying them
    np.testing.assert_array_equal(port.syn0.numpy(), ref.syn0)
    ref.fit(JaxWalks(gj, walk_length=6, seed=1), epochs=2)
    port.fit(RandomWalkIterator(gp, walk_length=6, seed=1), epochs=2)
    _close(port.syn0, ref.syn0, RUN_TOL)
    _close(port.syn1, ref.syn1, RUN_TOL)
    np.testing.assert_allclose(port.loss_history, ref.loss_history,
                               **RUN_TOL)
    assert port.similarity(0, 5) == pytest.approx(ref.similarity(0, 5),
                                                  rel=1e-3, abs=1e-4)
    assert port.vertices_nearest(2, 3) == [int(i) for i in
                                           ref.vertices_nearest(2, 3)]
    # carrying the tables across is the identity here
    carried = DeepWalk(vector_size=8, device="cpu")
    carried.initialize(gp)
    load_embeddings_from_jax(carried, ref)
    _close(carried.syn0, ref.syn0, dict(rtol=0, atol=0))
    _close(carried.syn1, ref.syn1, dict(rtol=0, atol=0))


def test_glove_carrier_needs_all_eight_tables():
    g = Glove(CollectionSentenceIterator(["a b"]), device="cpu")
    with pytest.raises(ValueError, match="eight"):
        load_embeddings_from_jax(g, w=np.zeros((2, 2)))


def test_distributed_word2vec_raises_naming_a14():
    """DistributedWord2Vec is ported: over a mesh of one device its host
    loop is Word2Vec's, bitwise (the world tests are
    tests/test_torch_cluster.py)."""
    class MeshOfOne:
        mesh_dim_names, shape = ("data",), (1,)

    sents = ["a b c a b d", "b c a d d", "c a b"]
    kw = dict(min_word_frequency=1, layer_size=8, window_size=2, seed=3,
              epochs=2, device="cpu")
    dw = DistributedWord2Vec(CollectionSentenceIterator(sents),
                             mesh=MeshOfOne(), **kw)
    w = Word2Vec(CollectionSentenceIterator(sents), **kw)
    assert dw.data_parallelism == 1
    dw.fit()
    w.fit()
    assert torch.equal(dw.syn0, w.syn0) and torch.equal(dw.syn1neg,
                                                        w.syn1neg)
