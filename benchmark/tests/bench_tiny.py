"""A checkout-shaped directory whose cells run the benchmark's real
drivers, readers and limits on a model small enough for the CPU."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

# narrow and shallow, but wide enough (head 64, d 512) that its logits
# spread about as the cells' do
TINY = {"vocab_size": 1024, "hidden_size": 512, "num_attention_heads": 8,
        "ffn_dim": 1024, "num_hidden_layers": 2,
        "max_position_embeddings": 256, "word_embed_proj_dim": 512}

MIXES = {
    "train": {"kind": "train", "batch": 2, "seq_len": 64, "lr": 3e-4,
              "setup_steps": 3, "window_batches": 2, "in_flight": 2,
              "trace_seconds": 0.3},
    "open_loop": {"kind": "open_loop", "slots": 4, "max_len": 256,
                  "rate_rps": 20.0, "max_total": 256, "max_queue": 100000,
                  "prompt": {"median": 16, "sigma": 0.5, "min": 4, "max": 64},
                  "output": {"median": 8, "sigma": 0.5, "min": 2, "max": 16},
                  "check_requests": 3, "trace_seconds": 0.3}
}


def make_root(path: str) -> str:
    """Write the tiny checkout under ``path``: the real ``BENCHMARK.json``
    with every cell pointed at the tiny configuration and a tiny mix of
    its own kind, the real limits and the real readers."""
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b = os.path.join(path, "benchmark")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(b, sub), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(b, "metrics"))
    conf = json.load(open(os.path.join(ROOT, bench["configs"][0]["file"])))
    conf.update(TINY, name="tiny")
    json.dump(conf, open(os.path.join(b, "configs", "tiny.json"), "w"))
    bench["configs"] = [{"name": "tiny", "source": "tiny",
                         "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "tiny"}]
    for w in list(bench["workloads"]):
        real = json.load(open(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json")))
        w["config"], w["traffic"] = "tiny", f"tiny-{real['kind']}"
        shutil.copy(os.path.join(BENCH, "limits", f"{w['name']}.json"),
                    os.path.join(b, "limits", f"{w['name']}.json"))
    for kind, mix in MIXES.items():
        json.dump(mix, open(os.path.join(b, "traffic", f"tiny-{kind}.json"),
                            "w"))
    json.dump(bench, open(os.path.join(path, "BENCHMARK.json"), "w"))
    return path


def cells() -> list:
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    return [w["name"] for w in bench["workloads"]]

