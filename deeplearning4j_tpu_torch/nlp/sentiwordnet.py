"""Sentiment lexicon scorer (SWN3).

Re-design of ``deeplearning4j-nlp/.../sentiwordnet/SWN3.java`` (260 LoC):
the reference parses the SentiWordNet 3.0 TSV (``POS\\tID\\tPosScore\\t
NegScore\\tSynsetTerms\\t...``), averages the sense scores per ``term#pos``
and classifies strings as strong/weak positive/negative/neutral. Same
format and thresholds here; a small built-in lexicon keeps the class usable
in a zero-egress environment, and ``load()`` accepts a full SentiWordNet
file when available.

A copy of ``deeplearning4j_tpu/nlp/sentiwordnet.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# term#pos → averaged (pos - neg) score; a tiny general-purpose seed
# lexicon so the scorer works without the (non-redistributable) full file
_BUILTIN = """
a\t1\t0.75\t0\tgood#1 great#1
a\t2\t0.875\t0\texcellent#1 wonderful#1 fantastic#1
a\t3\t0.625\t0\tnice#1 happy#1 positive#1
a\t4\t0\t0.75\tbad#1 awful#1
a\t5\t0\t0.875\tterrible#1 horrible#1 worst#1
a\t6\t0\t0.625\tpoor#1 negative#1 sad#1
v\t7\t0.625\t0\tlove#1 like#1 enjoy#1
v\t8\t0\t0.625\thate#1 dislike#1
n\t9\t0.5\t0\tjoy#1 delight#1
n\t10\t0\t0.5\tpain#1 misery#1 failure#1
"""


class SWN3:
    """SentiWordNet-style scorer (SWN3.java: buildDictionary, extract,
    classify/classForScore)."""

    def __init__(self, lexicon_path: Optional[str] = None):
        self._dict: Dict[str, float] = {}
        if lexicon_path is not None:
            with open(lexicon_path) as f:
                self._build(f.read())
        else:
            self._build(_BUILTIN)

    def _build(self, text: str) -> None:
        sums: Dict[str, List[float]] = {}
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 5:
                continue
            pos_tag, _, pos_s, neg_s, terms = parts[:5]
            try:
                score = float(pos_s) - float(neg_s)
            except ValueError:
                continue
            for term in terms.split():
                word = term.rsplit("#", 1)[0]
                key = f"{word.lower()}#{pos_tag}"  # queries lower-case too
                sums.setdefault(key, []).append(score)
        self._dict = {k: sum(v) / len(v) for k, v in sums.items()}

    # -- scoring --------------------------------------------------------
    def extract(self, word: str, pos: str = "a") -> float:
        """Averaged sentiment score for word#pos; 0.0 when unknown."""
        return self._dict.get(f"{word.lower()}#{pos}", 0.0)

    def score_tokens(self, tokens) -> float:
        total = 0.0
        for t in tokens:
            for pos in ("a", "v", "n", "r"):
                s = self._dict.get(f"{t.lower()}#{pos}")
                if s is not None:
                    total += s
                    break
        return total

    def class_for_score(self, score: float) -> str:
        """SWN3.java's banding: strong/weak positive/negative, neutral."""
        if score >= 0.75:
            return "strong_positive"
        if score >= 0.25:
            return "positive"
        if score > -0.25:
            return "neutral"
        if score > -0.75:
            return "negative"
        return "strong_negative"

    def classify(self, tokens) -> str:
        return self.class_for_score(self.score_tokens(tokens))
