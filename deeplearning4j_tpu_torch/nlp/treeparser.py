"""Raw-sentence → parse-tree: a minimal trained PCFG chart parser.

Closes the reference's ``TreeParser`` capability
(``deeplearning4j-nlp/.../text/corpora/treeparser/TreeParser.java:427`` —
parses raw sentences into ``Tree`` objects so the RNTN can consume plain
text). The reference leaned on UIMA + bundled OpenNLP chunker/parser
models; the package bundles neither, so the same capability is re-expressed
as a small probabilistic grammar LEARNED from any PTB-format treebank the
user already has (e.g. the Stanford Sentiment Treebank used to train the
RNTN — the usual pairing in the RNTN literature):

- :meth:`TreebankParser.fit` reads binarized trees and counts lexical
  (symbol → word) and binary (symbol → left right) rule frequencies.
- :meth:`TreebankParser.parse_tokens` runs bottom-up CKY over the learned
  log-probabilities and returns the Viterbi tree.
- :meth:`TreebankParser.parse` tokenizes a raw sentence first
  (``DefaultTokenizerFactory``), then parses; sentences whose words admit
  no complete derivation fall back to the right-branching
  :meth:`Tree.from_tokens` shape (the fallback the module always had) so
  the downstream RNTN never sees a failure.

Node symbols are syntactic tags when present (PTB trees) and stringified
integer labels otherwise (SST trees); parsed trees carry the symbol back
into ``tag``/``label`` the same way, so ``Tree.linearize`` consumes the
output unchanged. Everything here is host-side ETL — trees compile to
device programs via ``Tree.linearize`` exactly as before.

A copy of ``deeplearning4j_tpu/nlp/treeparser.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.nlp.trees import Tree

_UNK = "*UNK*"


def _symbol(node: Tree) -> str:
    if node.tag is not None:
        return str(node.tag)
    if node.label is not None:
        return str(node.label)
    return "X"


def _apply_symbol(node: Tree, sym: str) -> None:
    if sym.lstrip("-").isdigit():
        node.label = int(sym)
    else:
        node.tag = sym


class TreebankParser:
    """Viterbi-CKY parser over a PCFG estimated from a treebank.

    ``min_count`` prunes singleton lexical entries into the unknown-word
    distribution, which is also what out-of-vocabulary words at parse
    time score against.
    """

    def __init__(self, min_count: int = 1, unk_smoothing: float = 1e-4):
        self.min_count = int(min_count)
        self.unk_smoothing = float(unk_smoothing)
        # log P(word | sym): lexical[sym][word]
        self.lexical: Dict[str, Dict[str, float]] = {}
        # log P(left,right | sym) as a list of (left, right, logp) per sym,
        # inverted to (left, right) -> [(parent, logp)] for CKY lookups
        self.binary: Dict[Tuple[str, str], List[Tuple[str, float]]] = {}
        self.root_logp: Dict[str, float] = {}
        self._vocab: set = set()
        self._fitted = False

    # -- training ------------------------------------------------------
    def fit(self, trees: Sequence[Tree]) -> "TreebankParser":
        lex_counts: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        bin_counts: Dict[str, Dict[Tuple[str, str], float]] = defaultdict(
            lambda: defaultdict(float))
        root_counts: Dict[str, float] = defaultdict(float)

        for tree in trees:
            t = tree.binarize()
            root_counts[_symbol(t)] += 1.0
            for node in t.post_order():
                if node.is_leaf:
                    if node.word is not None:
                        lex_counts[_symbol(node)][node.word] += 1.0
                else:
                    left, right = node.children
                    bin_counts[_symbol(node)][
                        (_symbol(left), _symbol(right))] += 1.0

        self._vocab = {w for words in lex_counts.values()
                       for w, c in words.items() if c >= self.min_count}
        # lexical: rare words fold into *UNK* per preterminal symbol
        self.lexical = {}
        for sym, words in lex_counts.items():
            kept: Dict[str, float] = {}
            unk = self.unk_smoothing
            for w, c in words.items():
                if c >= self.min_count:
                    kept[w] = c
                else:
                    unk += c
            kept[_UNK] = unk
            total = sum(kept.values())
            self.lexical[sym] = {w: math.log(c / total)
                                 for w, c in kept.items()}

        # binary rules, inverted for the CKY inner loop
        inverted: Dict[Tuple[str, str], List[Tuple[str, float]]] = \
            defaultdict(list)
        for sym, rules in bin_counts.items():
            total = sum(rules.values())
            for (ls, rs), c in rules.items():
                inverted[(ls, rs)].append((sym, math.log(c / total)))
        self.binary = dict(inverted)

        total_roots = sum(root_counts.values())
        self.root_logp = {s: math.log(c / total_roots)
                          for s, c in root_counts.items()}
        self._fitted = True
        return self

    # -- parsing -------------------------------------------------------
    def _lex_scores(self, word: str) -> Dict[str, float]:
        out = {}
        for sym, dist in self.lexical.items():
            lp = dist.get(word)
            if lp is None:
                lp = dist.get(_UNK)
            if lp is not None:
                out[sym] = lp
        return out

    def parse_tokens(self, tokens: Sequence[str], label: int = 0,
                     tagger=None) -> Tree:
        """CKY Viterbi parse; right-branching fallback when the grammar
        admits no complete derivation (or the parser is unfitted).

        ``tagger`` (an :class:`~deeplearning4j_tpu_torch.nlp.postagger.
        HmmPosTagger` trained on the same tag set) constrains
        OUT-OF-VOCABULARY words to the tagger's predicted preterminal
        instead of the uniform unknown-word sweep over every symbol —
        the tagger→parser pipeline the reference built from OpenNLP
        pieces. In-vocabulary words keep their lexical distributions;
        a predicted tag the grammar has never seen falls back to the
        unconstrained sweep."""
        tokens = list(tokens)
        if not tokens:
            raise ValueError("empty token list")
        if not self._fitted:
            return Tree.from_tokens(tokens, label=label)
        predicted = None
        if tagger is not None:
            predicted = [t for _, t in tagger.tag_tokens(tokens)]
        n = len(tokens)
        # chart[i][j]: span tokens[i:j] → {sym: (logp, backpointer)}
        # backpointer: None for leaves, (split, lsym, rsym) otherwise
        chart: List[List[Dict[str, Tuple[float, Optional[tuple]]]]] = [
            [dict() for _ in range(n + 1)] for _ in range(n)]
        for i, w in enumerate(tokens):
            scores = self._lex_scores(w)
            if predicted is not None and w not in self._vocab \
                    and predicted[i] in scores:
                scores = {predicted[i]: scores[predicted[i]]}
            for sym, lp in scores.items():
                chart[i][i + 1][sym] = (lp, None)
        for width in range(2, n + 1):
            for i in range(0, n - width + 1):
                j = i + width
                cell = chart[i][j]
                for split in range(i + 1, j):
                    left_cell = chart[i][split]
                    right_cell = chart[split][j]
                    if not left_cell or not right_cell:
                        continue
                    for ls, (llp, _) in left_cell.items():
                        for rs, (rlp, _) in right_cell.items():
                            for sym, rlp2 in self.binary.get((ls, rs), ()):
                                score = llp + rlp + rlp2
                                cur = cell.get(sym)
                                if cur is None or score > cur[0]:
                                    cell[sym] = (score, (split, ls, rs))
        top = chart[0][n]
        if not top:
            return Tree.from_tokens(tokens, label=label)
        best_sym = max(
            top, key=lambda s: top[s][0] + self.root_logp.get(s, -1e9))
        return self._build(chart, tokens, 0, n, best_sym)

    def _build(self, chart, tokens, i, j, sym) -> Tree:
        _, back = chart[i][j][sym]
        node = Tree()
        _apply_symbol(node, sym)
        if back is None:
            node.word = tokens[i]
            return node
        split, ls, rs = back
        node.children = [self._build(chart, tokens, i, split, ls),
                         self._build(chart, tokens, split, j, rs)]
        return node

    def parse(self, sentence: str, label: int = 0, tagger=None) -> Tree:
        """Raw sentence → tree (TreeParser.java:427 getTrees entry)."""
        from deeplearning4j_tpu_torch.nlp.tokenization import (
            DefaultTokenizerFactory)

        tokens = DefaultTokenizerFactory().create(sentence).get_tokens()
        return self.parse_tokens(tokens, label=label, tagger=tagger)

    def parse_many(self, sentences: Sequence[str],
                   tagger=None) -> List[Tree]:
        return [self.parse(s, tagger=tagger) for s in sentences]

    # -- persistence (SerializationUtils role for trained parsers) ------
    def to_dict(self) -> dict:
        return {
            "format": "deeplearning4j-tpu/TreebankParser",
            "min_count": self.min_count,
            "unk_smoothing": self.unk_smoothing,
            "lexical": self.lexical,
            # tuple keys → ["ls", "rs", [[parent, logp], ...]] rows
            "binary": [[ls, rs, [[p, lp] for p, lp in rules]]
                       for (ls, rs), rules in sorted(self.binary.items())],
            "root_logp": self.root_logp,
            "vocab": sorted(self._vocab),
        }

    @staticmethod
    def from_dict(d: dict) -> "TreebankParser":
        p = TreebankParser(min_count=int(d.get("min_count", 1)),
                           unk_smoothing=float(d.get("unk_smoothing", 1e-4)))
        p.lexical = {s: dict(w) for s, w in d["lexical"].items()}
        p.binary = {(ls, rs): [(par, float(lp)) for par, lp in rules]
                    for ls, rs, rules in d["binary"]}
        p.root_logp = dict(d["root_logp"])
        p._vocab = set(d.get("vocab", ()))
        p._fitted = True
        return p

    def save(self, path: str) -> None:
        import json

        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f)

    @staticmethod
    def load(path: str) -> "TreebankParser":
        import json

        with open(path, encoding="utf-8") as f:
            return TreebankParser.from_dict(json.load(f))
