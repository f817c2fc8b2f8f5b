"""Port parity for serving: ``deeplearning4j_tpu_torch.serving`` against
``deeplearning4j_tpu.serving`` on the same weights and the same seeded
request stream.

The load-bearing claims:

1. The port's ``DecodeServer`` emits, for every request of one seeded
   ``poisson_schedule``, the same greedy tokens as the JAX server with
   ``attn_impl="flash"`` (Pallas kernel in interpret mode on the JAX
   side, the kernel's plain version on the port's CPU tensors), at
   ``fuse_steps`` 1 and 4, with slots recycled and prompts bucket-padded.
2. Within the port, a slot's stream equals ``TransformerLM.generate`` on
   the same prompt: greedy, and sampled with the request's seed.
3. The pool's analytic footprint equals the JAX value, and the int8
   codec meets the JAX error bound and reproduces the JAX server's
   int8 greedy streams.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu.serving import DecodeServer as JaxServer
from deeplearning4j_tpu.serving import kv_cache as jax_kv
from deeplearning4j_tpu.serving import poisson_schedule as jax_schedule
from deeplearning4j_tpu.serving import run_open_loop as jax_open_loop
from deeplearning4j_tpu_torch.models import transformer as tm
from deeplearning4j_tpu_torch.models.convert import params_from_jax
from deeplearning4j_tpu_torch.models.transformer import TransformerLM
from deeplearning4j_tpu_torch.serving import (
    DecodeEngine, DecodeServer, ServeQueueFull, SlotKVCache, kv_pool_nbytes,
    max_slots_in_budget, poisson_schedule, run_open_loop)
from deeplearning4j_tpu_torch.serving.kv_cache import (
    dequant_slab, requant_write_slab)

CFG = dict(vocab_size=64, d_model=128, num_heads=2, num_layers=2,
           max_len=64, seed=0, attn_impl="flash")
SCHEDULE = dict(vocab_size=64, prompt_lens=(5, 13, 20, 33),
                max_new_tokens=(3, 6, 8), seed=11)
_MODELS = {}


def _pair(**kw):
    """(JAX model, port model on the JAX weights), cached per config."""
    key = tuple(sorted(kw.items()))
    if key not in _MODELS:
        ref = JaxLM(**{**CFG, **kw}).init()
        port = TransformerLM(**{**CFG, **kw}, device="cpu")
        port.params = params_from_jax(
            jax.tree_util.tree_map(np.asarray, ref.params))
        _MODELS[key] = (ref, port)
    return _MODELS[key]


class FakeClock:
    """Every read advances ``tick``; ``sleep`` jumps the idle gaps, so
    both servers see the same admissions in the same order."""

    def __init__(self, tick=0.01):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t

    def sleep(self, s):
        self.t += s


def _streams(server_cls, open_loop, lm, schedule, **kw):
    clock = FakeClock()
    srv = server_cls(lm, slots=2, max_len=64, clock=clock, **kw)
    report = open_loop(srv, schedule, clock=clock, sleep=clock.sleep)
    assert report.finished == len(schedule)
    return srv, {r.prompt.tobytes(): r.output for r in srv.finished}


@pytest.mark.parametrize("fuse_steps", [1, 4])
def test_server_streams_match_jax_server(fuse_steps, monkeypatch):
    ref, port = _pair()
    calls = []
    flash = tm.flash_attention
    monkeypatch.setattr(tm, "flash_attention",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    jsched = jax_schedule(6, 50.0, **SCHEDULE)
    sched = poisson_schedule(6, 50.0, **SCHEDULE)
    for a, b in zip(jsched, sched):
        assert np.array_equal(a.prompt, b.prompt)
        assert (a.arrival_s, a.max_new_tokens) == (b.arrival_s,
                                                   b.max_new_tokens)
    _, want = _streams(JaxServer, jax_open_loop, ref, jsched,
                       fuse_steps=fuse_steps)
    srv, got = _streams(DecodeServer, run_open_loop, port, sched,
                        fuse_steps=fuse_steps, device="cpu")
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    st = srv.stats()
    # two slots for six requests: slots were recycled
    assert st["finished"] == 6 and st["slots"] == 2
    # bucket padding: 5 -> 16, 13 -> 16, 20 -> 32, 33 -> 64
    assert set(st["compiles"]["prefill_buckets"]) <= {16, 32, 64}
    assert len(st["compiles"]["prefill_buckets"]) >= 2
    # every prefill ran its attention through the flash path
    assert len(calls) == CFG["num_layers"] * 6


@pytest.mark.parametrize("fuse_steps", [1, 3])
@pytest.mark.parametrize("sampling", [None, (0.8, 10)],
                         ids=["greedy", "sampled"])
def test_server_streams_equal_port_generate(fuse_steps, sampling):
    _, lm = _pair(pos_encoding="rope", num_kv_heads=1, attn_window=24)
    temperature, top_k = sampling or (0.0, None)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 64, n).astype(np.int32)
               for n in (5, 20, 40, 9)]
    news = [6, 9, 4, 12]
    srv = DecodeServer(lm, slots=2, max_len=64, fuse_steps=fuse_steps,
                       device="cpu", temperature=temperature, top_k=top_k)
    reqs = [srv.submit(p, m, seed=i)
            for i, (p, m) in enumerate(zip(prompts, news))]
    srv.drain()
    for i, (req, p, m) in enumerate(zip(reqs, prompts, news)):
        want = lm.generate(p[None], m, temperature=temperature,
                           top_k=top_k, seed=i)[0].numpy()
        np.testing.assert_array_equal(req.output, want)


def test_engine_steps_and_counts():
    _, lm = _pair()
    eng = DecodeEngine(lm, 2, max_len=64, device="cpu")
    tok = eng.prefill(np.arange(1, 6), 0)
    assert eng.cursor_of(0) == 5 and tok.ndim == 0
    out = eng.decode(np.array([int(tok), 0]), eng.cache.cursors, [None, None])
    assert out.shape == (2,)
    block = eng.decode_fused(np.array([int(tok), 0]), np.array([3, 0]),
                             [None, None], 4)
    assert block.shape == (4, 2)
    assert eng.cursor_of(0) == 8 and eng.cursor_of(1) == 0
    assert torch.equal(block[3], block[2])       # frozen after 3 steps
    assert eng.compile_counts() == {"decode": 2, "prefill_buckets": [16],
                                    "total": 3}
    with pytest.raises(NotImplementedError):
        DecodeEngine(lm, 2, draft_layers=1, device="cpu")
    with pytest.raises(NotImplementedError):
        DecodeEngine(lm, 2, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        eng.decode_spec()


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_kv_pool_nbytes_equals_jax(kv_dtype):
    ref, port = _pair(num_kv_heads=1)
    for slots, max_len in ((1, 64), (3, 48)):
        want = jax_kv.kv_pool_nbytes(ref, slots, max_len, kv_dtype)
        assert kv_pool_nbytes(port, slots, max_len, kv_dtype) == want
        cache = SlotKVCache(port, slots, max_len, kv_dtype)
        assert cache.nbytes == want
        assert cache.k.shape == (2, slots, max_len, 1, 64)
    budget = 1 << 20
    assert max_slots_in_budget(port, 64, budget, kv_dtype) == \
        jax_kv.max_slots_in_budget(ref, 64, budget, kv_dtype)


def test_kv_dtype_resolution(monkeypatch):
    _, port = _pair()
    assert SlotKVCache(port, 1).kv_dtype == "float32"
    monkeypatch.setenv("DL4J_SERVE_KV_DTYPE", "bf16")
    assert SlotKVCache(port, 1).kv_dtype == "bfloat16"
    with pytest.raises(ValueError):
        SlotKVCache(port, 1, kv_dtype="int4")
    with pytest.raises(ValueError, match="position table"):
        SlotKVCache(port, 1, max_len=128)


def test_int8_codec_matches_jax_and_meets_its_bound():
    """Two writes, the second larger (forcing a requantization of the
    first): the port's int8 slab and scales equal the JAX codec's, and a
    dequantized element sits within the JAX bound of the original."""
    rng = np.random.default_rng(7)
    s_, t_, h_, d_ = 3, 8, 2, 4
    vals1 = rng.normal(size=(s_, 4, h_, d_)).astype(np.float32)
    vals2 = 3.0 * rng.normal(size=(s_, 4, h_, d_)).astype(np.float32)
    pos1 = np.tile(np.arange(4)[None], (s_, 1))
    jslab = jnp.zeros((s_, t_, h_, d_), jnp.int8)
    jscale = jnp.zeros((s_, h_), jnp.float32)
    slab = torch.zeros((s_, t_, h_, d_), dtype=torch.int8)
    scale = torch.zeros((s_, h_))
    rows = np.arange(s_)
    for vals, pos in ((vals1, pos1), (vals2, pos1 + 4)):
        jslab, jscale = jax_kv.requant_write_slab(
            jslab, jscale, jnp.asarray(vals), jnp.asarray(rows),
            jnp.asarray(pos))
        requant_write_slab(slab, scale, torch.from_numpy(vals),
                           torch.from_numpy(rows), torch.from_numpy(pos))
    np.testing.assert_array_equal(slab.numpy(), np.asarray(jslab))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    deq = dequant_slab(slab, scale, torch.float32).numpy()
    bound = scale.numpy()[:, None, :, None] / 127.0 + 1e-7
    assert (np.abs(deq[:, :4] - vals1) <= 2 * bound).all()
    assert (np.abs(deq[:, 4:] - vals2) <= bound).all()


def test_int8_server_matches_jax_int8_server():
    ref, port = _pair()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 64, n).astype(np.int32) for n in (5, 17)]
    news = [7, 6]
    js = JaxServer(ref, slots=2, max_len=64, kv_dtype="int8", fuse_steps=2)
    ps = DecodeServer(port, slots=2, max_len=64, kv_dtype="int8",
                      fuse_steps=2, device="cpu")
    jr = [js.submit(p, m) for p, m in zip(prompts, news)]
    pr = [ps.submit(p, m) for p, m in zip(prompts, news)]
    js.drain()
    ps.drain()
    for a, b in zip(jr, pr):
        np.testing.assert_array_equal(b.output, a.output)
    assert ps.stats()["kv_dtype"] == "int8"
    assert ps.stats()["kv_pool_bytes"] == js.stats()["kv_pool_bytes"]


def _prompt(n=4):
    return np.arange(1, n + 1, dtype=np.int32)


def test_queue_bound_deadlines_and_displacement():
    _, lm = _pair()
    t = {"now": 10.0}
    srv = DecodeServer(lm, slots=1, max_len=64, max_queue=1, device="cpu",
                       clock=lambda: t["now"])
    v = srv.try_submit(_prompt(), 4, deadline_s=9.0)
    assert not v.admitted and v.reason == "expired"
    assert srv.shed_log[-1]["where"] == "admission"
    srv.submit(_prompt(), 8)
    srv.step()                                    # slot taken
    vb = srv.try_submit(_prompt(5), 4, criticality="batch")
    vi = srv.try_submit(_prompt(6), 4, criticality="interactive")
    assert vi.admitted and vi.displaced is vb.request
    assert vb.request.shed_reason == "shed_overload"
    with pytest.raises(ServeQueueFull):
        srv.submit(_prompt(), 4, criticality="interactive")
    with pytest.raises(ValueError, match="slot capacity"):
        srv.submit(_prompt(60), 10)
    t["now"] = 11.0
    srv.drain()
    assert [r.state for r in srv.finished] == ["finished"] * 2
    assert srv.stats()["shed_by_class"] == {"interactive": 1, "batch": 1}


def test_in_flight_deadline_frees_slot():
    _, lm = _pair()
    t = {"now": 0.0}
    srv = DecodeServer(lm, slots=1, max_len=64, device="cpu",
                       clock=lambda: t["now"])
    v = srv.try_submit(_prompt(), 8, deadline_s=0.5)
    srv.step()
    assert v.request.state == "running"
    t["now"] = 1.0
    srv.step()
    assert v.request.state == "shed"
    assert srv.stats()["expired_in_flight"] == 1
    v2 = srv.try_submit(_prompt(), 4, deadline_s=100.0)
    srv.step()
    assert v2.request.state == "running"
