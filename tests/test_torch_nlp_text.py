"""Port parity for the host-side text and graph pipeline under the
embeddings: tokenizers, stop words, sentence iterators, ``VocabCache`` and
Huffman coding, the unigram and keep tables, moving windows,
``Word2VecDataSetIterator``, the word-vector and graph-vector files, and
the graph structure and random walks. All exact: these are copies of the
JAX package's host code (numpy draws included), so every output equals
the reference's bit for bit, and a file written by either package reads
in the other with equal vectors.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import graph as jax_graph
from deeplearning4j_tpu.nlp import movingwindow as jax_mw
from deeplearning4j_tpu.nlp import sentence_iterator as jax_si
from deeplearning4j_tpu.nlp import serializer as jax_ser
from deeplearning4j_tpu.nlp import stopwords as jax_sw
from deeplearning4j_tpu.nlp import tokenization as jax_tok
from deeplearning4j_tpu.nlp import vocab as jax_vocab
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JaxWord2Vec
from deeplearning4j_tpu.nlp.word2vec_iterator import (
    Word2VecDataSetIterator as JaxW2VIterator,
)
from deeplearning4j_tpu_torch import graph as port_graph
from deeplearning4j_tpu_torch.models.convert import load_embeddings_from_jax
from deeplearning4j_tpu_torch.nlp import movingwindow as mw
from deeplearning4j_tpu_torch.nlp import sentence_iterator as si
from deeplearning4j_tpu_torch.nlp import serializer as ser
from deeplearning4j_tpu_torch.nlp import stopwords as sw
from deeplearning4j_tpu_torch.nlp import tokenization as tok
from deeplearning4j_tpu_torch.nlp import vocab as vocab_mod
from deeplearning4j_tpu_torch.nlp import Word2Vec, Word2VecDataSetIterator


def _sentences(seed=7, n_words=50, n_sent=80):
    rng = np.random.default_rng(seed)
    zipf = rng.zipf(1.3, size=(n_sent, 12)) % n_words
    return [" ".join(f"w{t}" for t in row[:rng.integers(2, 13)])
            for row in zipf]


TEXT = ["The Cats, sat: on (the) mat!", "running quickly jumped foxes",
        "I'm 42 years old; it's fine.", "", "dogs barked loudly"]


@pytest.mark.parametrize("pre", [None, "CommonPreprocessor",
                                 "LowCasePreProcessor", "EndingPreProcessor"])
def test_tokenizers_equal(pre):
    port = tok.DefaultTokenizerFactory()
    ref = jax_tok.DefaultTokenizerFactory()
    if pre:
        port.set_token_pre_processor(getattr(tok, pre)())
        ref.set_token_pre_processor(getattr(jax_tok, pre)())
    for text in TEXT:
        assert port.create(text).get_tokens() == ref.create(text).get_tokens()
        assert port.create(text).count_tokens() == \
            ref.create(text).count_tokens()
    for lo, hi in ((1, 2), (2, 3)):
        p = tok.NGramTokenizerFactory(lo, hi)
        r = jax_tok.NGramTokenizerFactory(lo, hi)
        for text in TEXT:
            assert p.create(text).get_tokens() == r.create(text).get_tokens()


def test_stop_words_equal():
    assert sw.get_stop_words() == jax_sw.get_stop_words()
    toks = "The cat and THE dog were not here".split()
    assert sw.remove_stop_words(toks) == jax_sw.remove_stop_words(toks)
    assert [sw.is_stop_word(t) for t in toks] == \
        [jax_sw.is_stop_word(t) for t in toks]


def test_sentence_iterators_equal(tmp_path):
    (tmp_path / "a.txt").write_text("one two\n\n three four \nfive\n")
    (tmp_path / "b.txt").write_text("six seven\neight\n")
    pairs = [
        (si.CollectionSentenceIterator(TEXT),
         jax_si.CollectionSentenceIterator(TEXT)),
        (si.BasicLineIterator(str(tmp_path / "a.txt")),
         jax_si.BasicLineIterator(str(tmp_path / "a.txt"))),
        (si.LineSentenceIterator(str(tmp_path / "b.txt")),
         jax_si.LineSentenceIterator(str(tmp_path / "b.txt"))),
        (si.FileSentenceIterator(str(tmp_path)),
         jax_si.FileSentenceIterator(str(tmp_path))),
    ]
    for p, r in pairs:
        assert list(p) == list(r)
        assert list(p) == list(r)  # reset by iteration
    lp = si.LabelAwareSentenceIterator(TEXT[:3], ["x", "y", "z"])
    lr = jax_si.LabelAwareSentenceIterator(TEXT[:3], ["x", "y", "z"])
    gp = si.LabelAwareSentenceIterator(TEXT[:3])
    gr = jax_si.LabelAwareSentenceIterator(TEXT[:3])
    for p, r in ((lp, lr), (gp, gr)):
        got, want = [], []
        for it, out in ((p, got), (r, want)):
            it.reset()
            while it.has_next():
                out.append((it.next_sentence(), it.current_label()))
        assert got == want
        assert p.labels_source.get_labels() == r.labels_source.get_labels()


@pytest.mark.parametrize("min_freq", [1, 3])
def test_vocab_and_huffman_equal(min_freq):
    sents = [s.split() for s in _sentences()]
    port = vocab_mod.build_vocab(sents, min_freq)
    ref = jax_vocab.build_vocab(sents, min_freq)
    assert port.words() == ref.words()
    assert [w.count for w in port.vocab_words()] == \
        [w.count for w in ref.vocab_words()]
    assert port.total_word_count == ref.total_word_count
    assert port.index_of("w1") == ref.index_of("w1")
    assert port.index_of("nope") == ref.index_of("nope") == -1
    assert port.word_frequency("w2") == ref.word_frequency("w2")
    t_p, t_r = port.truncate(4), ref.truncate(4)
    assert t_p.words() == t_r.words()
    vocab_mod.Huffman(port).build()
    jax_vocab.Huffman(ref).build()
    for a, b in zip(port.vocab_words(), ref.vocab_words()):
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.points, b.points)
    for a, b in zip(vocab_mod.padded_huffman_paths(port),
                    jax_vocab.padded_huffman_paths(ref)):
        np.testing.assert_array_equal(a, b)
    for s in (0.0, 1e-3, 1e-1):
        np.testing.assert_array_equal(
            vocab_mod.subsample_keep_prob(port, s),
            jax_vocab.subsample_keep_prob(ref, s))
    np.testing.assert_array_equal(vocab_mod.unigram_table(port, 5000),
                                  jax_vocab.unigram_table(ref, 5000))


def test_moving_windows_equal():
    toks = "a quick brown fox jumps".split()
    index = {w: i + 1 for i, w in enumerate(toks)}
    for size in (1, 3, 5):
        assert [(w.words, w.focus_index, w.focus_word)
                for w in mw.windows(toks, size)] == \
            [(w.words, w.focus_index, w.focus_word)
             for w in jax_mw.windows(toks, size)]
        np.testing.assert_array_equal(
            mw.window_indices(toks, index, size),
            jax_mw.window_indices(toks, index, size))
    np.testing.assert_array_equal(mw.window_indices([], index, 3),
                                  jax_mw.window_indices([], index, 3))
    with pytest.raises(ValueError):
        mw.windows(toks, 4)
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    for rot in (False, True):
        np.testing.assert_array_equal(
            mw.moving_window_matrix(x, 3, rot),
            jax_mw.moving_window_matrix(x, 3, rot))


def _fitted_pair():
    sents = _sentences()
    kw = dict(min_word_frequency=1, layer_size=6, window_size=2, seed=1,
              epochs=1)
    ref = JaxWord2Vec(jax_si.CollectionSentenceIterator(sents), **kw)
    ref.fit()
    port = Word2Vec(si.CollectionSentenceIterator(sents), device="cpu", **kw)
    port.build_vocab()
    load_embeddings_from_jax(port, ref)
    return ref, port


@pytest.mark.parametrize("binary", [False, True])
def test_word_vector_files_read_across_packages(binary, tmp_path):
    ref, port = _fitted_pair()
    write_p = ser.write_binary if binary else ser.write_word_vectors
    write_r = jax_ser.write_binary if binary else jax_ser.write_word_vectors
    p_path, r_path = str(tmp_path / "p.vec"), str(tmp_path / "r.vec")
    write_p(port, p_path)
    write_r(ref, r_path)
    with open(p_path, "rb") as a, open(r_path, "rb") as b:
        assert a.read() == b.read()
    # written by the port, read by the reference, and the other way
    from_p = jax_ser.load_word_vectors(p_path, binary=binary)
    from_r = ser.load_word_vectors(r_path, binary=binary, device="cpu")
    assert from_r.vocab.words() == from_p.vocab.words() == ref.vocab.words()
    np.testing.assert_array_equal(from_r.syn0.numpy(),
                                  np.asarray(from_p.syn0))
    assert from_r.similarity("w1", "w2") == from_p.similarity("w1", "w2")
    assert from_r.words_nearest("w1", top_n=3) == \
        from_p.words_nearest("w1", top_n=3)


def test_word2vec_dataset_iterator_equal():
    ref, port = _fitted_pair()
    labeled = [(s.split(), "pos" if i % 3 else "neg")
               for i, s in enumerate(_sentences(seed=3, n_sent=20))]
    labeled.append(([], "pos"))
    labeled.append((["w1", "unknown", "w2"], "neg"))
    p = Word2VecDataSetIterator(port, labeled, ["neg", "pos"], 3, batch=16)
    r = JaxW2VIterator(ref, labeled, ["neg", "pos"], 3, batch=16)
    assert (p.total_examples(), p.input_columns(), p.total_outcomes()) == \
        (r.total_examples(), r.input_columns(), r.total_outcomes())
    n = 0
    while r.has_next():
        a, b = p.next(), r.next()
        np.testing.assert_array_equal(a.features.numpy(), b.features)
        np.testing.assert_array_equal(a.labels.numpy(), b.labels)
        n += 1
    assert not p.has_next() and n == -(-r.total_examples() // 16)
    p.reset()
    assert p.next(5).features.shape == (5, 18)
    with pytest.raises(ValueError):
        Word2VecDataSetIterator(port, [(["w1"], "other")], ["neg"])


def test_graph_structure_loaders_and_walks_equal(tmp_path):
    edges = tmp_path / "e.txt"
    edges.write_text("# comment\n0 1\n1 2 2.5\n2 3\n3 0 0.5\n4 4\n")
    adj = tmp_path / "a.txt"
    adj.write_text("0 1 2\n1 2\n2 0 3\n3\n")
    for load, kw in (("load_edge_list", {}),
                     ("load_adjacency_list", {"directed": True})):
        path = str(edges if load == "load_edge_list" else adj)
        gp = getattr(port_graph.GraphLoader, load)(path, 5, **kw)
        gr = getattr(jax_graph.GraphLoader, load)(path, 5, **kw)
        assert gp.num_edges() == gr.num_edges()
        for v in range(5):
            assert gp.connected_vertices(v) == gr.connected_vertices(v)
            assert gp.weighted_neighbors(v) == gr.weighted_neighbors(v)
            assert gp.degree(v) == gr.degree(v)
        for cls in ("RandomWalkIterator", "WeightedRandomWalkIterator"):
            wp = getattr(port_graph, cls)(gp, 7, seed=3)
            wr = getattr(jax_graph, cls)(gr, 7, seed=3)
            for a, b in zip(list(wp), list(wr)):
                np.testing.assert_array_equal(a, b)
    hp = port_graph.GraphHuffman(gp)
    hr = jax_graph.GraphHuffman(gr)
    for a, b in zip(hp.padded_paths(), hr.padded_paths()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        port_graph.Graph(0)


def test_graph_vector_files_read_across_packages(tmp_path):
    g = port_graph.Graph(6)
    gj = jax_graph.Graph(6)
    for a, b in ((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0)):
        g.add_edge(a, b)
        gj.add_edge(a, b)
    port = port_graph.DeepWalk(vector_size=4, window_size=2, device="cpu")
    ref = jax_graph.DeepWalk(vector_size=4, window_size=2)
    port.initialize(g)
    ref.initialize(gj)
    p_path, r_path = str(tmp_path / "p.txt"), str(tmp_path / "r.txt")
    port_graph.GraphVectorSerializer.write_graph_vectors(port, p_path)
    jax_graph.GraphVectorSerializer.write_graph_vectors(ref, r_path)
    with open(p_path) as a, open(r_path) as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(
        port_graph.GraphVectorSerializer.read_graph_vectors(r_path),
        jax_graph.GraphVectorSerializer.read_graph_vectors(p_path))
    assert isinstance(port.syn0, torch.Tensor)
