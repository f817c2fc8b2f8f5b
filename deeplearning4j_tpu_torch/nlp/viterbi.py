"""Viterbi decoder — most-likely label sequence under a Markov model.

Port of ``deeplearning4j_tpu/nlp/viterbi.py`` (a re-design of
``deeplearning4j-core/.../util/Viterbi.java``, which decodes label
sequences from per-step outcome scores with a host-side DP loop). The
max-product recursion is a loop over time on device tensors, batched over
sequences, and the backtrace a loop over the stored backpointers, which
stay on the device: only the decoded path and its score are read back.

Each step is float32 adds and maxes only, and ``torch.max`` keeps the
first index on ties as ``jnp.argmax`` does, so a path equals the
reference's exactly and its score to the last bit on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device


class Viterbi:
    """Decoder over ``num_states`` labels (Viterbi.java's possibleLabels).

    ``transitions``: [S, S] log-potentials (from → to); defaults to uniform
    (pure per-step argmax with tie-keeping dynamics, the reference's
    metastability-style default). ``initial``: [S] log-prior.
    """

    def __init__(self, num_states: int,
                 transitions: Optional[np.ndarray] = None,
                 initial: Optional[np.ndarray] = None,
                 device: DeviceLike = None):
        self.num_states = num_states
        self.device = resolve_device(device)
        trans = (np.zeros((num_states, num_states), np.float32)
                 if transitions is None
                 else np.asarray(transitions, np.float32))
        if trans.shape != (num_states, num_states):
            raise ValueError("transitions must be [S, S]")
        init = (np.zeros((num_states,), np.float32) if initial is None
                else np.asarray(initial, np.float32))
        self.transitions = torch.from_numpy(trans.copy()).to(self.device)
        self.initial = torch.from_numpy(init.copy()).to(self.device)

    def _decode_impl(self, emissions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """emissions: [B, T, S] log-scores on the device → (paths [B, T]
        int64, log-scores [B]), both on the device."""
        delta = self.initial + emissions[:, 0]              # [B, S]
        backptrs = []
        for t in range(1, emissions.shape[1]):
            scores = delta[:, :, None] + self.transitions   # [B, from, to]
            best, best_prev = torch.max(scores, dim=1)      # first on ties
            delta = best + emissions[:, t]
            backptrs.append(best_prev)
        score, state = torch.max(delta, dim=1)
        path = [state]
        for ptr in reversed(backptrs):
            state = torch.gather(ptr, 1, state[:, None])[:, 0]
            path.append(state)
        return torch.stack(path[::-1], dim=1), score

    def _emissions(self, emissions, ndim: int) -> torch.Tensor:
        e = np.asarray(emissions, np.float32)
        if e.ndim != ndim or e.shape[-1] != self.num_states:
            shape = "[T, S]" if ndim == 2 else "[B, T, S]"
            raise ValueError(f"emissions must be {shape} with S = "
                             f"{self.num_states}, got {e.shape}")
        return torch.from_numpy(np.ascontiguousarray(e)).to(self.device)

    # -- public API -----------------------------------------------------
    def decode(self, emissions, length: Optional[int] = None
               ) -> Tuple[np.ndarray, float]:
        """Decode one sequence of per-step label log-scores [T, S].
        ``length`` treats rows ≥ length as padding: only the first
        ``length`` steps are decoded, which gives the path and score of
        the reference's masked decode (padding steps carry the DP state
        through and point back to themselves there)."""
        e = self._emissions(emissions, 2)
        if length is not None:
            if not 1 <= length <= e.shape[0]:
                raise ValueError(
                    f"length {length} out of range 1..{e.shape[0]}")
            e = e[:length]
        path, score = self._decode_impl(e[None])
        return path[0].to(torch.int32).cpu().numpy(), float(score[0])

    def decode_batch(self, emissions) -> Tuple[np.ndarray, np.ndarray]:
        """Decode a batch [B, T, S] → (paths [B, T], scores [B])."""
        paths, scores = self._decode_impl(self._emissions(emissions, 3))
        return (paths.to(torch.int32).cpu().numpy(),
                scores.cpu().numpy())

    @staticmethod
    def from_counts(transition_counts: np.ndarray,
                    smoothing: float = 1.0,
                    device: DeviceLike = None) -> "Viterbi":
        """Build from observed transition counts (add-k smoothed log-probs),
        the way the reference derives probabilities from label statistics."""
        c = np.asarray(transition_counts, np.float64) + smoothing
        logp = np.log(c / c.sum(axis=1, keepdims=True))
        return Viterbi(c.shape[0], transitions=logp, device=device)
