"""Seeded weights and tokens, made on the device by the benchmark and handed
alike to the program and to the reference.

The layout and scales are ``TransformerLM.init()``'s (embeddings and
positions normal × 0.02, projections normal × sqrt(2 / (fan_in +
fan_out)), norms 1 and 0, biases 0), but every normal draw comes from one
``torch.randn`` call on a ``torch.Generator`` of the device, so that a
seed gives the same weights each time, in seconds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def sub_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for ``stream`` of a run's ``seed``."""
    state = np.random.SeedSequence([seed & _MASK64, stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def draw(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The model's parameters as a nested dict (the port's layout)."""
    d, f, v = cfg["hidden_size"], cfg["ffn_dim"], cfg["vocab_size"]
    n_pos, layers = cfg["max_position_embeddings"], cfg["num_hidden_layers"]
    shapes = [("embed", (v, d), 0.02), ("pos", (n_pos, d), 0.02)]
    for i in range(layers):
        shapes += [((i, "wq"), (d, d), None), ((i, "wk"), (d, d), None),
                   ((i, "wv"), (d, d), None), ((i, "wo"), (d, d), None),
                   ((i, "w1"), (d, f), None), ((i, "w2"), (f, d), None)]
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for key, shape, scale in shapes:
        n = math.prod(shape)
        w = flat[at:at + n].view(shape)
        at += n
        w.mul_(scale if scale is not None else math.sqrt(2.0 / sum(shape)))
        out[key] = w

    def norm():
        return {"g": torch.ones(d, device=device, dtype=dtype),
                "b": torch.zeros(d, device=device, dtype=dtype)}

    params = {"embed": out["embed"], "pos": out["pos"], "ln_f": norm(),
              "blocks": []}
    for i in range(layers):
        params["blocks"].append({
            "ln1": norm(),
            "attn": {k: out[(i, k)] for k in ("wq", "wk", "wv", "wo")},
            "ln2": norm(),
            "mlp": {"w1": out[(i, "w1")],
                    "b1": torch.zeros(f, device=device, dtype=dtype),
                    "w2": out[(i, "w2")],
                    "b2": torch.zeros(d, device=device, dtype=dtype)}})
    return params


def token_batches(vocab: int, shape, count: int, seed: int, device
                  ) -> torch.Tensor:
    """``count`` batches of uniform token ids, ``[count, *shape]`` int64."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    return torch.randint(0, vocab, (count, *shape), generator=gen,
                         device=device, dtype=torch.int64)
