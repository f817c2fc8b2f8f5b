"""The general traffic generator: turns a mix's parameters
(``benchmark/traffic/<mix>.json``) and a seed into requests.

Every seed gets the same set of sizes and gaps in another order, so that a
seed changes which request comes when and its token ids, never the amount
of work: a length set of ``n`` is the lognormal's quantiles at ``(i + 0.5)
/ n``, clipped to the mix's range, and the gaps of an open loop are the
exponential's quantiles at the same points, scaled to the mix's rate.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np


@dataclass
class Request:
    due_s: float          # seconds after the window opens (open loop)
    prompt: np.ndarray    # int32 token ids
    max_new_tokens: int


def load(root: str, name: str) -> dict:
    """The mix ``benchmark/traffic/<name>.json``."""
    with open(os.path.join(root, "benchmark", "traffic", f"{name}.json")) as f:
        return json.load(f)


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths: lognormal quantiles (``median``, ``sigma``) clipped
    to ``[min, max]``, ascending."""
    nd = NormalDist()
    u = (np.arange(n) + 0.5) / n
    z = np.array([nd.inv_cdf(float(x)) for x in u])
    raw = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(raw), spec["min"], spec["max"]).astype(np.int64)


def pair_lengths(mix: dict, n: int, rng: np.random.Generator):
    """``n`` (prompt, output) pairs, each list permuted by ``rng``, the
    output cut so that the pair fits ``max_total``."""
    prompts = rng.permutation(quantile_lengths(mix["prompt"], n))
    outputs = rng.permutation(quantile_lengths(mix["output"], n))
    outputs = np.minimum(outputs, mix["max_total"] - prompts)
    return prompts, outputs


def open_loop(mix: dict, seconds: float, seed: int, vocab: int
              ) -> List[Request]:
    """``round(rate × seconds)`` requests due inside the window, at
    exponential gaps of mean ``1 / rate``."""
    rate = float(mix["rate_rps"])
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(seed)
    u = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-u) / rate)
    gaps *= min(n / rate, seconds) / gaps.sum()   # the last one is due in it
    due = np.cumsum(gaps)
    prompts, outputs = pair_lengths(mix, n, rng)
    return [Request(float(due[i]),
                    rng.integers(0, vocab, int(prompts[i]), dtype=np.int32),
                    int(outputs[i])) for i in range(n)]
