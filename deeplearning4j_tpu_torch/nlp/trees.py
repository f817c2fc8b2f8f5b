"""Parse trees: structure, PTB parsing, binarization, linearization.

Host-side re-expression of the reference's tree machinery:
``deeplearning4j-core/.../util/..autoencoder/recursive/Tree.java`` (485 —
label/children/vector node struct) and
``deeplearning4j-nlp/.../text/corpora/treeparser/TreeParser.java`` (427 —
builds trees from text via UIMA/OpenNLP parsers). UIMA is replaced by a
Penn-Treebank s-expression reader (the format the Stanford Sentiment
Treebank and the RNTN literature use) plus a right-branching fallback for
plain token sequences.

The device-facing piece is :meth:`Tree.linearize`: trees are irregular, so
each tree compiles to a post-order program over a node buffer — (left,
right, word_id, is_leaf, label) per node — which ``models/rntn.py``
evaluates level by level (every node of one height across the batch at
once). Padding nodes carry label -1.

A copy of ``deeplearning4j_tpu/nlp/trees.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Tree:
    """An n-ary parse-tree node (Tree.java)."""

    label: Optional[int] = None        # e.g. sentiment class 0..C-1
    word: Optional[str] = None         # set on leaves
    children: List["Tree"] = field(default_factory=list)
    tag: Optional[str] = None          # syntactic category (NP, VP, NN, …)

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> List["Tree"]:
        if self.is_leaf:
            return [self]
        return [leaf for c in self.children for leaf in c.leaves()]

    def words(self) -> List[str]:
        return [leaf.word for leaf in self.leaves() if leaf.word is not None]

    def post_order(self) -> List["Tree"]:
        out: List[Tree] = []

        def rec(t: Tree) -> None:
            for c in t.children:
                rec(c)
            out.append(t)

        rec(self)
        return out

    def num_nodes(self) -> int:
        return len(self.post_order())

    def depth(self) -> int:
        if self.is_leaf:
            return 0
        return 1 + max(c.depth() for c in self.children)

    # -- construction --------------------------------------------------
    @staticmethod
    def parse(s: str) -> "Tree":
        """Parse one PTB s-expression: ``(3 (2 the) (3 (2 movie) (2 rocks)))``.

        The first token after '(' is the node label (int when numeric);
        leaves are ``(label word)``.
        """
        tokens = s.replace("(", " ( ").replace(")", " ) ").split()
        pos = 0

        def rec() -> Tree:
            nonlocal pos
            if pos >= len(tokens):
                raise ValueError(f"unbalanced tree (truncated input): {s!r}")
            if tokens[pos] != "(":
                raise ValueError(f"expected '(' at token {pos}: {tokens[pos]}")
            pos += 1
            label_tok = tokens[pos]
            pos += 1
            if _is_int(label_tok):
                node = Tree(label=int(label_tok))
            else:  # syntactic category (NP/VP/NN…): keep as the tag
                node = Tree(label=None, tag=label_tok)
            while pos < len(tokens) and tokens[pos] != ")":
                if tokens[pos] == "(":
                    node.children.append(rec())
                else:  # leaf word
                    if node.word is not None:
                        raise ValueError(
                            f"multiple bare tokens in one node: "
                            f"{node.word!r} and {tokens[pos]!r} — "
                            f"multi-word leaves must be nested nodes")
                    node.word = tokens[pos]
                    pos += 1
            if pos >= len(tokens):
                raise ValueError(f"unbalanced tree (missing ')'): {s!r}")
            pos += 1
            return node

        tree = rec()
        if pos != len(tokens):
            raise ValueError("trailing tokens after tree")
        return tree

    @staticmethod
    def parse_many(text: str) -> List["Tree"]:
        """Parse a file of one-tree-per-line s-expressions."""
        return [Tree.parse(line) for line in text.splitlines() if line.strip()]

    @staticmethod
    def from_tokens(tokens: Sequence[str], label: int = 0) -> "Tree":
        """Right-branching binary tree over a flat token list — the
        no-real-parser fallback (TreeParser's role when no model is
        available)."""
        if not tokens:
            raise ValueError("empty token list")
        leaves = [Tree(label=label, word=t) for t in tokens]
        root = leaves[-1]
        for leaf in reversed(leaves[:-1]):
            root = Tree(label=label, children=[leaf, root])
        return root

    # -- transforms ----------------------------------------------------
    def binarize(self) -> "Tree":
        """Right-binarize n-ary nodes so every internal node has exactly two
        children (the RNTN composition is strictly binary). Syntactic
        ``tag``s survive (HeadWordFinder and the treebank parser's grammar
        extraction both read them)."""
        if self.is_leaf:
            return Tree(label=self.label, word=self.word, tag=self.tag)
        kids = [c.binarize() for c in self.children]
        if len(kids) == 1:
            # unary collapse: adopt this node's label (span semantics,
            # e.g. sentiment); for TAGS a collapsed preterminal keeps the
            # child's POS (DT/NN/VBD carry the lexical information the
            # grammar and head rules need), otherwise the parent category
            child = kids[0]
            if child.word is not None and child.tag is not None:
                tag = child.tag
            else:
                tag = self.tag if self.tag is not None else child.tag
            return Tree(label=self.label if self.label is not None
                        else child.label,
                        tag=tag, word=child.word, children=child.children)
        node = kids[-1]
        for left in reversed(kids[1:-1]):
            node = Tree(label=self.label, tag=self.tag,
                        children=[left, node])
        return Tree(label=self.label, tag=self.tag,
                    children=[kids[0], node])

    # -- device program ------------------------------------------------
    def linearize(self, word_index: Dict[str, int],
                  max_nodes: Optional[int] = None,
                  unk_index: int = 0) -> Dict[str, np.ndarray]:
        """Post-order program arrays for the scan evaluator.

        Returns dict of int32 arrays, each length ``max_nodes``:
        ``left``/``right`` (buffer indices of children; 0 for leaves),
        ``word`` (embedding row for leaves; 0 otherwise), ``is_leaf``
        (0/1), ``label`` (node class; -1 on padding), ``n_nodes`` scalar.
        """
        t = self.binarize()
        nodes = t.post_order()
        n = len(nodes)
        if max_nodes is None:
            max_nodes = n
        if n > max_nodes:
            raise ValueError(f"tree has {n} nodes > max_nodes={max_nodes}")
        index = {id(node): i for i, node in enumerate(nodes)}
        left = np.zeros(max_nodes, np.int32)
        right = np.zeros(max_nodes, np.int32)
        word = np.zeros(max_nodes, np.int32)
        is_leaf = np.zeros(max_nodes, np.int32)
        label = np.full(max_nodes, -1, np.int32)
        for i, node in enumerate(nodes):
            label[i] = -1 if node.label is None else node.label
            if node.is_leaf:
                is_leaf[i] = 1
                word[i] = word_index.get(node.word, unk_index)
            else:
                left[i] = index[id(node.children[0])]
                right[i] = index[id(node.children[1])]
        return {"left": left, "right": right, "word": word,
                "is_leaf": is_leaf, "label": label,
                "n_nodes": np.int32(n)}


def _is_int(tok: str) -> bool:
    try:
        int(tok)
        return True
    except ValueError:
        return False


def build_word_index(trees: Sequence[Tree],
                     unk_token: str = "*UNK*") -> Dict[str, int]:
    """Vocabulary over tree leaves; row 0 is the unknown-word vector."""
    index: Dict[str, int] = {unk_token: 0}
    for t in trees:
        for w in t.words():
            if w not in index:
                index[w] = len(index)
    return index


def pad_to_bucket(n: int, buckets: Tuple[int, ...] = (8, 16, 32, 64, 128,
                                                      256, 512)) -> int:
    """Smallest bucket ≥ n — bounds the number of distinct batch shapes."""
    for b in buckets:
        if n <= b:
            return b
    return n


# ---------------------------------------------------------------------------
# head-word finding (text/corpora/treeparser/HeadWordFinder.java:285 —
# Charniak-style head-percolation rules). Re-expressed as data tables + a
# best-candidate scan; operates on Tree.tag (syntactic categories from
# PTB-style parses).
# ---------------------------------------------------------------------------

# primary (parent, child) head rules — certainty 1
_HEAD_RULES_1 = frozenset({
    ("ADJP", "JJ"), ("ADJP", "JJR"), ("ADJP", "JJS"), ("ADVP", "RB"),
    ("ADVP", "RBB"), ("LST", "LS"), ("NAC", "NNS"), ("NAC", "NN"),
    ("NAC", "PRP"), ("NAC", "NNPS"), ("NAC", "NNP"), ("NX", "NNS"),
    ("NX", "NN"), ("NX", "PRP"), ("NX", "NNPS"), ("NX", "NNP"),
    ("NP", "NNS"), ("NP", "NN"), ("NP", "PRP"), ("NP", "NNPS"),
    ("NP", "NNP"), ("NP", "POS"), ("NP", "$"), ("PP", "IN"), ("PP", "TO"),
    ("PP", "RP"), ("PRT", "RP"), ("S", "VP"), ("S1", "S"), ("SBAR", "IN"),
    ("SBAR", "WHNP"), ("SBARQ", "SQ"), ("SBARQ", "VP"), ("SINV", "VP"),
    ("SQ", "MD"), ("SQ", "AUX"), ("VP", "VB"), ("VP", "VBZ"), ("VP", "VBP"),
    ("VP", "VBG"), ("VP", "VBN"), ("VP", "VBD"), ("VP", "AUX"),
    ("VP", "AUXG"), ("VP", "TO"), ("VP", "MD"), ("WHADJP", "WRB"),
    ("WHADVP", "WRB"), ("WHNP", "WP"), ("WHNP", "WDT"), ("WHNP", "WP$"),
    ("WHPP", "IN"), ("WHPP", "TO"),
})

# secondary rules — certainty 3
_HEAD_RULES_2 = frozenset({
    ("ADJP", "VBN"), ("ADJP", "RB"), ("NAC", "NP"), ("NAC", "CD"),
    ("NAC", "FW"), ("NAC", "ADJP"), ("NAC", "JJ"), ("NX", "NP"),
    ("NX", "CD"), ("NX", "FW"), ("NX", "ADJP"), ("NX", "JJ"), ("NP", "CD"),
    ("NP", "ADJP"), ("NP", "JJ"), ("S", "SINV"), ("S", "SBARQ"), ("S", "X"),
    ("PRT", "RB"), ("PRT", "IN"), ("SBAR", "WHADJP"), ("SBAR", "WHADVP"),
    ("SBAR", "WHPP"), ("SBARQ", "S"), ("SBARQ", "SINV"), ("SBARQ", "X"),
    ("SINV", "SBAR"), ("SQ", "VP"),
})

_TERMINAL_TAGS = frozenset({
    "AUX", "AUXG", "CC", "CD", "DT", "EX", "FW", "IN", "JJ", "JJR", "JJS",
    "LS", "MD", "NN", "NNS", "NNP", "NNPS", "PDT", "POS", "PRP", "PRP$",
    "RB", "RBR", "RBS", "RP", "SYM", "TO", "UH", "VB", "VBD", "VBG", "VBN",
    "VBP", "VBZ", "WDT", "WP", "WP$", "WRB", "#", "$", ".", ",", ":",
    "-RRB-", "-LRB-", "``", "''", "EOS",
})


class HeadWordFinder:
    """Find the lexical head of a parsed subtree.

    Walks from the given node downward, at each level choosing the child
    with the most certain head claim: primary rule (1) > parent==child
    category (2) > secondary rule (3) > non-terminal non-PP (5) >
    non-terminal (6) > anything (7). Equal-certainty ties keep the
    RIGHTMOST candidate (the ``>=`` comparisons re-fire on later
    children) except tier 2, which keeps the leftmost — this asymmetry
    matches the reference's findHead3 scan exactly; do not "fix" the
    comparisons to strict inequalities.
    """

    def __init__(self):
        self._cache: Dict[Tuple[Optional[str], Tuple[Optional[str], ...]],
                          int] = {}

    def find_head(self, tree: Tree) -> Tree:
        """Descend to the head LEAF of ``tree``."""
        cursor = tree
        if cursor.tag == "TOP" and cursor.children:
            cursor = cursor.children[0]
        while cursor.children:
            cursor = self.find_head_child(cursor)
        return cursor

    def find_head_child(self, parent: Tree) -> Tree:
        """The immediate head child of one node."""
        child_tags = tuple(c.tag for c in parent.children)
        key = (parent.tag, child_tags)
        idx = self._cache.get(key)
        if idx is None:
            idx = self._head_index(parent.tag, child_tags)
            self._cache[key] = idx
        return parent.children[idx]

    @staticmethod
    def _head_index(parent_tag: Optional[str],
                    child_tags: Sequence[Optional[str]]) -> int:
        best, uncertainty = 0, 10
        for i, tag in enumerate(child_tags):
            if uncertainty >= 1 and (parent_tag, tag) in _HEAD_RULES_1:
                best, uncertainty = i, 1
            elif uncertainty > 2 and parent_tag is not None \
                    and parent_tag == tag:
                best, uncertainty = i, 2
            elif uncertainty >= 3 and (parent_tag, tag) in _HEAD_RULES_2:
                best, uncertainty = i, 3
            elif uncertainty >= 5 and tag is not None \
                    and tag not in _TERMINAL_TAGS and tag != "PP":
                best, uncertainty = i, 5
            elif uncertainty >= 6 and tag not in _TERMINAL_TAGS:
                best, uncertainty = i, 6
            elif uncertainty >= 7:
                best, uncertainty = i, 7
        return best
