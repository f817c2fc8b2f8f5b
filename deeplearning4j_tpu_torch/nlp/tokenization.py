"""Tokenizers + preprocessors (text/tokenization/ in the reference:
DefaultTokenizer, NGramTokenizer, preprocessors like the stemming
EndingPreProcessor; UIMA-backed pipelines are out of scope — the default
pipeline covers the test/bench corpus needs).

A copy of ``deeplearning4j_tpu/nlp/tokenization.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional


class TokenPreProcess:
    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (nlp CommonPreprocessor)."""

    _PATTERN = re.compile(r"[\d.:,\"'()\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PATTERN.sub("", token.lower())


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude suffix stripper (util EndingPreProcessor: s/ed/ing/ly...)."""

    def pre_process(self, token: str) -> str:
        t = token
        for suffix in ("ing", "ed", "ly", "es"):
            if t.endswith(suffix) and len(t) > len(suffix) + 2:
                return t[:-len(suffix)]
        if t.endswith("s") and len(t) > 3:
            return t[:-1]
        return t


class Tokenizer:
    def __init__(self, tokens: List[str],
                 preprocessor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = preprocessor
        self._pos = 0

    def has_more_tokens(self) -> bool:
        return self._pos < len(self._tokens)

    def next_token(self) -> str:
        tok = self._tokens[self._pos]
        self._pos += 1
        return self._pre.pre_process(tok) if self._pre else tok

    def count_tokens(self) -> int:
        return len(self._tokens)

    def get_tokens(self) -> List[str]:
        out = []
        while self.has_more_tokens():
            t = self.next_token()
            if t:
                out.append(t)
        return out


class TokenizerFactory:
    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self._pre = pre
        return self

    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer (DefaultTokenizer / DefaultStreamTokenizer)."""

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text.split(), self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """Word n-grams joined with spaces (NGramTokenizer)."""

    def __init__(self, min_n: int = 1, max_n: int = 2):
        super().__init__()
        self.min_n = min_n
        self.max_n = max_n

    def create(self, text: str) -> Tokenizer:
        words = text.split()
        grams: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(words) - n + 1):
                grams.append(" ".join(words[i:i + n]))
        return Tokenizer(grams, self._pre)
