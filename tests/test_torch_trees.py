"""Port parity for the tree and tagging side of the NLP stack: parse trees
(``Tree.parse``, ``binarize``, ``linearize``, head words), the Viterbi
decoder, the HMM tagger, the treebank parser, SentiWordNet, the inverted
index and the bag-of-words vectorizers, held against the JAX package on
the same inputs.

The trees, parser, index, lexicon and vectorizers are copies of the JAX
package's host code, so their outputs are equal. The Viterbi recursion is
float32 adds and maxes only, with the first index kept on ties in both
packages, so paths are equal and scores equal to the last bit on the CPU.
The vectorizers' float32 matrices are held at 1e-6.
"""

import json

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import bagofwords as jax_bow
from deeplearning4j_tpu.nlp import trees as jax_trees
from deeplearning4j_tpu.nlp.invertedindex import InvertedIndex as JaxIndex
from deeplearning4j_tpu.nlp.postagger import HmmPosTagger as JaxTagger
from deeplearning4j_tpu.nlp.sentiwordnet import SWN3 as JaxSWN3
from deeplearning4j_tpu.nlp.treeparser import TreebankParser as JaxParser
from deeplearning4j_tpu.nlp.viterbi import Viterbi as JaxViterbi
from deeplearning4j_tpu_torch.nlp import (
    SWN3,
    BagOfWordsVectorizer,
    HmmPosTagger,
    InvertedIndex,
    TfidfVectorizer,
    TreebankParser,
    Viterbi,
)
from deeplearning4j_tpu_torch.nlp import trees as port_trees

PTB = [
    "(S (NP (DT the) (NN cat)) (VP (VBD sat) (PP (IN on) (NP (DT the) "
    "(NN mat)))) (. .))",
    "(S (NP (DT a) (JJ big) (NN dog)) (VP (VBD ran) (ADVP (RB quickly))))",
    "(TOP (S (NP (PRP it)) (VP (VBZ works))))",
    "(S (NP (NNS dogs)) (VP (VBP bark) (NP (NNS cats))) (. .))",
]


def _sst_strings(n=20, seed=3, vocab=30, classes=5):
    """Seeded SST-format trees: random binary bracketing, labels on every
    node, a few n-ary and unary nodes."""
    rng = np.random.default_rng(seed)

    def rec(words):
        if len(words) == 1:
            return f"({rng.integers(classes)} {words[0]})"
        if len(words) >= 3 and rng.random() < 0.2:   # a ternary node
            a, b = sorted(rng.choice(np.arange(1, len(words)), 2, False))
            parts = [words[:a], words[a:b], words[b:]]
        else:
            s = int(rng.integers(1, len(words)))
            parts = [words[:s], words[s:]]
        inner = " ".join(rec(p) for p in parts)
        if rng.random() < 0.1:                         # a unary chain
            inner = f"({rng.integers(classes)} {inner})"
        return f"({rng.integers(classes)} {inner})"

    return [rec([f"w{t}" for t in rng.zipf(1.5, rng.integers(1, 12))
                 % vocab]) for _ in range(n)]


def _sexpr(t):
    """A tree's full content (label, tag, word, children) as a string."""
    head = f"{t.label}|{t.tag}|{t.word}"
    return "(" + " ".join([head] + [_sexpr(c) for c in t.children]) + ")"


@pytest.mark.parametrize("bank", ["sst", "ptb"])
def test_trees_equal(bank):
    strings = _sst_strings() if bank == "sst" else PTB
    jt = jax_trees.Tree.parse_many("\n".join(strings))
    pt = port_trees.Tree.parse_many("\n".join(strings))
    jidx = jax_trees.build_word_index(jt)
    pidx = port_trees.build_word_index(pt)
    assert jidx == pidx
    heads_j, heads_p = jax_trees.HeadWordFinder(), port_trees.HeadWordFinder()
    for a, b in zip(jt, pt):
        assert _sexpr(a) == _sexpr(b)
        assert _sexpr(a.binarize()) == _sexpr(b.binarize())
        assert a.words() == b.words() and a.depth() == b.depth()
        assert [_sexpr(n) for n in a.post_order()] == \
            [_sexpr(n) for n in b.post_order()]
        bucket = port_trees.pad_to_bucket(b.num_nodes())
        assert bucket == jax_trees.pad_to_bucket(a.num_nodes())
        for kw in ({}, {"max_nodes": 2 * bucket}):
            la, lb = a.linearize(jidx, **kw), b.linearize(pidx, **kw)
            assert la.keys() == lb.keys()
            for k in la:
                np.testing.assert_array_equal(la[k], lb[k])
                assert la[k].dtype == lb[k].dtype
        assert _sexpr(heads_j.find_head(a)) == _sexpr(heads_p.find_head(b))
    toks = ["a", "b", "c", "d"]
    assert _sexpr(jax_trees.Tree.from_tokens(toks, 2)) == \
        _sexpr(port_trees.Tree.from_tokens(toks, 2))
    for bad in ("(1 (2 a)", "(1 a b)", "(1 a))"):
        with pytest.raises(ValueError):
            port_trees.Tree.parse(bad)


def _emissions(rng, *shape, ties=False):
    if ties:   # small integers: many equal scores, so ties decide paths
        return rng.integers(-3, 1, shape).astype(np.float32)
    return rng.normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
def test_viterbi_equal(ties):
    rng = np.random.default_rng(11 + ties)
    S = 6
    trans = _emissions(rng, S, S, ties=ties)
    init = _emissions(rng, S, ties=ties)
    ref = JaxViterbi(S, transitions=trans, initial=init)
    port = Viterbi(S, transitions=trans, initial=init, device="cpu")
    for T, length in ((1, None), (7, None), (16, 5), (16, 16), (16, 1)):
        e = _emissions(rng, T, S, ties=ties)
        pa, sa = ref.decode(e, length=length)
        pb, sb = port.decode(e, length=length)
        np.testing.assert_array_equal(pa, pb)
        assert pa.dtype == pb.dtype
        assert np.float32(sa) == np.float32(sb)
    e = _emissions(rng, 9, 12, S, ties=ties)
    pa, sa = ref.decode_batch(e)
    pb, sb = port.decode_batch(e)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(np.asarray(sa), sb)
    counts = rng.integers(0, 9, (S, S))
    np.testing.assert_array_equal(
        np.asarray(JaxViterbi.from_counts(counts, 0.5).transitions),
        Viterbi.from_counts(counts, 0.5, device="cpu").transitions.numpy())
    with pytest.raises(ValueError):
        port.decode(np.zeros((4, S + 1), np.float32))
    with pytest.raises(ValueError):
        port.decode(np.zeros((4, S), np.float32), length=5)


def _tagged_corpus(n_sent, seed, n_tags=5, vocab=40):
    """A seeded HMM's (word, tag) sentences."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.ones(n_tags) * 0.5, n_tags)
    perm = np.stack([rng.permutation(vocab) for _ in range(n_tags)])
    sents = []
    for _ in range(n_sent):
        tag = int(rng.integers(n_tags))
        sent = []
        for _ in range(int(rng.integers(2, 14))):
            w = perm[tag, (rng.zipf(1.4) - 1) % vocab]
            sent.append((f"w{w}", f"T{tag}"))
            tag = int(rng.choice(n_tags, p=trans[tag]))
        sents.append(sent)
    return sents


def test_tagger_equal_and_persists_across_packages(tmp_path):
    corpus = _tagged_corpus(150, seed=5)
    ref = JaxTagger().fit(corpus)
    port = HmmPosTagger(device="cpu").fit(corpus)
    assert port.tags == ref.tags
    held = [[w for w, _ in s] for s in _tagged_corpus(25, seed=6)]
    held += [["w1", "running", "Paris", "42", "quickly", "cats"]]   # OOV
    for sent in held:
        assert port.tag_tokens(sent) == ref.tag_tokens(sent)
        np.testing.assert_array_equal(
            port.emissions(sent),
            np.stack([ref._emission_row(w) for w in sent]))
    assert port.tag("w3 w4 jumped") == ref.tag("w3 w4 jumped")
    assert port.tag_tokens([]) == []
    # the packages read each other's JSON
    port.save(str(tmp_path / "p.json"))
    ref.save(str(tmp_path / "j.json"))
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    from_port = JaxTagger.load(str(tmp_path / "p.json"))
    from_ref = HmmPosTagger.load(str(tmp_path / "j.json"), device="cpu")
    for sent in held:
        assert from_port.tag_tokens(sent) == from_ref.tag_tokens(sent) \
            == ref.tag_tokens(sent)
    bank = [jax_trees.Tree.parse(s) for s in PTB]
    bank_p = [port_trees.Tree.parse(s) for s in PTB]
    assert HmmPosTagger.from_treebank(bank_p, device="cpu").to_dict() == \
        JaxTagger.from_treebank(bank).to_dict()
    with pytest.raises(RuntimeError):
        HmmPosTagger(device="cpu").tag_tokens(["a"])


@pytest.mark.parametrize("bank", ["sst", "ptb"])
def test_parser_equal(bank, tmp_path):
    strings = _sst_strings(40, seed=9) if bank == "sst" else PTB * 2
    jt = [jax_trees.Tree.parse(s) for s in strings]
    pt = [port_trees.Tree.parse(s) for s in strings]
    ref = JaxParser(min_count=1).fit(jt)
    port = TreebankParser(min_count=1).fit(pt)
    assert port.to_dict() == ref.to_dict()
    sents = [t.words() for t in pt[:8]]
    sents += [["the", "wombat", "ran"], ["a", "cat", "sat", "zzz"],
              ["w1", "w2", "unknown", "w3"], ["solo"]]
    tagger_j = tagger_p = None
    if bank == "ptb":   # the tagger constrains OOV preterminals
        tagger_j = JaxTagger.from_treebank(jt)
        tagger_p = HmmPosTagger.from_treebank(pt, device="cpu")
    for s in sents:
        assert _sexpr(port.parse_tokens(s)) == _sexpr(ref.parse_tokens(s))
        assert _sexpr(port.parse_tokens(s, tagger=tagger_p)) == \
            _sexpr(ref.parse_tokens(s, tagger=tagger_j))
    assert _sexpr(port.parse("the dog ran quickly")) == \
        _sexpr(ref.parse("the dog ran quickly"))
    port.save(str(tmp_path / "p.json"))
    back = JaxParser.load(str(tmp_path / "p.json"))
    for s in sents:
        assert _sexpr(back.parse_tokens(s)) == _sexpr(ref.parse_tokens(s))
    assert _sexpr(TreebankParser().parse_tokens(["x", "y"])) == \
        _sexpr(JaxParser().parse_tokens(["x", "y"]))


def test_swn3_and_inverted_index_equal(tmp_path):
    lex = tmp_path / "lex.txt"
    lex.write_text("# custom\na\t1\t0.5\t0\tgreat#1 good#2\n"
                   "v\t2\t0\t0.75\tfail#1\nn\t3\t0.25\t0.5\tgood#1\n")
    for path in (None, str(lex)):
        ref, port = JaxSWN3(path), SWN3(path)
        toks = ["Good", "terrible", "love", "pain", "great", "fail", "x"]
        for w in toks:
            for pos in ("a", "v", "n", "r"):
                assert port.extract(w, pos) == ref.extract(w, pos)
        score = port.score_tokens(toks)
        assert score == ref.score_tokens(toks)
        assert port.classify(toks) == ref.classify(toks)
        for s in (-1.0, -0.3, 0.0, 0.2, 0.9):
            assert port.class_for_score(s) == ref.class_for_score(s)
    docs = [["a", "b", "a"], ["b", "c"], ["d"], ["a", "c", "e", "e"]]
    ref, port = JaxIndex(), InvertedIndex()
    for i, d in enumerate(docs):
        assert port.add_doc(d, label=f"l{i % 2}") == \
            ref.add_doc(d, label=f"l{i % 2}")
    port.add_words_to_doc(10, ["z", "a"])
    ref.add_words_to_doc(10, ["z", "a"])
    for w in ("a", "b", "c", "e", "z", "missing"):
        assert port.documents(w) == ref.documents(w)
        assert port.num_documents(w) == ref.num_documents(w)
        assert port.doc_frequency(w) == ref.doc_frequency(w)
        assert port.idf(w) == ref.idf(w)
    assert port.terms() == ref.terms() and port.num_documents() == \
        ref.num_documents()
    for d in (0, 3, 10):
        assert port.tfidf(d) == ref.tfidf(d)
        assert port.label(d) == ref.label(d)
    assert list(port.each_doc()) == list(ref.each_doc())
    assert list(port.batch_iter(2, shuffle=True, seed=4)) == \
        list(ref.batch_iter(2, shuffle=True, seed=4))
    import random
    assert port.sample_doc(random.Random(3)) == \
        ref.sample_doc(random.Random(3))
    with pytest.raises(KeyError):
        port.add_words_to_doc(10, ["again"])


@pytest.mark.parametrize("kind", ["BagOfWordsVectorizer", "TfidfVectorizer"])
def test_bag_of_words_equal(kind):
    docs = ["the cat sat on the mat", "the dog barked", "cats and dogs",
            "a mat, a hat; a cat!", "nothing in common here"]
    port_cls = {"BagOfWordsVectorizer": BagOfWordsVectorizer,
                "TfidfVectorizer": TfidfVectorizer}[kind]
    ref = getattr(jax_bow, kind)(min_word_frequency=1,
                                 stop_words=["the"]).fit(docs)
    port = port_cls(min_word_frequency=1, stop_words=["the"]).fit(docs)
    for d in docs + ["unseen words cat"]:
        np.testing.assert_allclose(port.transform(d), ref.transform(d),
                                   rtol=1e-6, atol=1e-6)
    ds_p = port.vectorize(docs, labels=[0, 1, 1, 0, 2])
    ds_j = ref.vectorize(docs, labels=[0, 1, 1, 0, 2])
    np.testing.assert_allclose(np.asarray(ds_p.features),
                               np.asarray(ds_j.features), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ds_p.labels),
                                  np.asarray(ds_j.labels))
