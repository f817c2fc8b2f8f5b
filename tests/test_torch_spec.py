"""Port parity for speculative decoding: ``DecodeEngine.decode_spec`` and
the speculative ``DecodeServer`` against the JAX package's on the same
weights and the same seeded request stream.

The load-bearing claims:

1. Greedy speculative servers (a 1- and a 2-layer self-draft, an
   independent 1-layer draft model; ``spec_tokens`` 1 and 3;
   ``fuse_steps`` 1 and 4) emit, for every request of one seeded
   ``poisson_schedule``, the JAX server's tokens with the same
   ``spec_proposed``/``spec_accepted`` counts, and every stream equals the
   port's own greedy ``generate``.
2. A full-depth self-draft accepts every proposal, and a shallow
   self-draft shares the target's parameter tensors.
3. One sampled round of the reference's ``_serve_spec_impl``, its key
   chain replayed here through ``jax.random`` and the same draws fed to
   the port's ``_draws`` seam, gives the same ``[K, S, G+2]`` block: no
   accept flips. ``jax.random.categorical`` is ``argmax(logits +
   gumbel)`` on the jax version installed, which the seam relies on.
4. The first token of a sampled speculative round follows the target's
   filtered distribution (a chi-square test at a fixed seed), and a
   request's sampled stream does not depend on its neighbours.
"""

import numpy as np
import pytest
import torch
from scipy import stats as sps

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu.serving import DecodeEngine as JaxEngine
from deeplearning4j_tpu.serving import DecodeServer as JaxServer
from deeplearning4j_tpu.serving import poisson_schedule as jax_schedule
from deeplearning4j_tpu.serving import run_open_loop as jax_open_loop
from deeplearning4j_tpu_torch.models.convert import params_from_jax
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerLM, filter_logits)
from deeplearning4j_tpu_torch.serving import (
    DecodeEngine, DecodeServer, poisson_schedule, run_open_loop)
from deeplearning4j_tpu_torch.serving.server import draft_seed

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


def _run(server_cls, open_loop, lm, schedule, **kw):
    clock = FakeClock()
    srv = server_cls(lm, slots=2, max_len=64, clock=clock, **kw)
    report = open_loop(srv, schedule, clock=clock, sleep=clock.sleep)
    assert report.finished == len(schedule)
    return srv, {r.prompt.tobytes(): r.output for r in srv.finished}


SPEC_CASES = [
    dict(draft_layers=1, spec_tokens=3, fuse_steps=1),
    dict(draft_layers=1, spec_tokens=1, fuse_steps=4),
    dict(draft_layers=2, spec_tokens=3, fuse_steps=4),
    dict(draft_model="independent", spec_tokens=3, fuse_steps=1),
]


@pytest.mark.parametrize("case", SPEC_CASES, ids=[
    "self1-g3-k1", "self1-g1-k4", "self2-g3-k4", "draft-g3-k1"])
def test_greedy_spec_server_matches_jax_server(case):
    ref, port = _pair()
    kw = dict(case)
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("draft_model") == "independent":
        jd, pd = _pair(num_layers=1, seed=9)
        jkw["draft_model"], pkw["draft_model"] = jd, pd
    jsched = jax_schedule(6, 50.0, **SCHEDULE)
    sched = poisson_schedule(6, 50.0, **SCHEDULE)
    jsrv, want = _run(JaxServer, jax_open_loop, ref, jsched, **jkw)
    srv, got = _run(DecodeServer, run_open_loop, port, sched, device="cpu",
                    **pkw)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    js, st = jsrv.stats(), srv.stats()
    for k in ("spec_proposed", "spec_accepted", "spec_accept_rate",
              "decode_tokens", "steps", "tokens_per_slot_dispatch",
              "kv_pool_bytes", "kv_per_slot_bytes"):
        assert st[k] == js[k], k
    assert st["speculative"] and st["spec_proposed"] > 0
    for req in srv.finished:
        np.testing.assert_array_equal(
            req.output,
            port.generate(req.prompt[None], req.max_new_tokens)[0].numpy())


def test_full_depth_self_draft_accepts_everything():
    _, lm = _pair(pos_encoding="rope", num_kv_heads=1)
    p = np.arange(3, 8, dtype=np.int32)
    srv = DecodeServer(lm, slots=1, max_len=64, draft_layers=2,
                       spec_tokens=3, device="cpu")
    req = srv.submit(p, 13)     # 12 decode tokens = 3 full rounds
    srv.drain()
    np.testing.assert_array_equal(req.output,
                                  lm.generate(p[None], 13)[0].numpy())
    st = srv.stats()
    assert st["spec_accept_rate"] == 1.0
    assert st["tokens_per_slot_dispatch"] == 4.0
    assert srv.steps == 3


def test_shallow_draft_shares_the_target_tensors():
    _, lm = _pair()
    eng = DecodeEngine(lm, 2, max_len=64, draft_layers=1, device="cpu")
    draft = eng.draft_model
    assert draft.num_layers == 1 and eng.spec
    assert draft.params["embed"].data_ptr() == lm.params["embed"].data_ptr()
    assert draft.params["ln_f"]["g"] is lm.params["ln_f"]["g"]
    for name, w in draft.params["blocks"][0]["attn"].items():
        assert w.data_ptr() == lm.params["blocks"][0]["attn"][name].data_ptr()
    # its own pool, one layer deep
    assert eng.draft_cache.k.shape[0] == 1
    assert eng.draft_cache.k.data_ptr() != eng.cache.k.data_ptr()


def test_spec_validation_stats_and_counts():
    _, lm = _pair()
    with pytest.raises(ValueError, match="not both"):
        DecodeEngine(lm, 1, draft_layers=1, draft_model=lm, device="cpu")
    with pytest.raises(ValueError, match="draft_layers"):
        DecodeServer(lm, slots=1, draft_layers=3, device="cpu")
    with pytest.raises(ValueError, match="spec_tokens"):
        DecodeServer(lm, slots=1, draft_layers=1, spec_tokens=0,
                     device="cpu")
    _, small = _pair(vocab_size=32)
    with pytest.raises(ValueError, match="vocab"):
        DecodeServer(lm, slots=1, draft_model=small, device="cpu")
    # a mesh of one device: the shallow draft shares the target's
    # placement, an independent draft gets its own
    class OneDevice:
        mesh_dim_names, shape = ("data",), (1,)

    mesh = OneDevice()
    meshed = DecodeServer(TransformerLM(**CFG, device="cpu"), slots=1,
                          draft_layers=1, mesh=mesh, device="cpu")
    assert meshed.engine.draft_model._registry is meshed.engine.registry
    other = TransformerLM(**{**CFG, "num_layers": 1}, device="cpu")
    DecodeEngine(TransformerLM(**CFG, device="cpu"), 1, draft_model=other,
                 mesh=mesh, device="cpu")
    assert other._registry.mesh is mesh
    srv = DecodeServer(lm, slots=1, max_len=32, draft_layers=1,
                       spec_tokens=4, device="cpu")
    with pytest.raises(ValueError, match="speculative slack"):
        srv.submit(np.arange(1, 21), 9)              # 29 + 4 > 32
    req = srv.submit(np.arange(1, 21), 8)            # 28 + 4 == 32
    srv.drain()
    assert len(req.tokens) == 8
    st = srv.stats()
    assert st["kv_pool_bytes"] == (srv.engine.cache.nbytes
                                   + srv.engine.draft_cache.nbytes)
    assert st["kv_per_slot_bytes"] * st["slots"] == st["kv_pool_bytes"]
    assert st["spec_tokens"] == 4
    assert st["compiles"]["prefill_buckets"] == [32, 32]
    assert st["compiles"]["decode"] == 1
    # DL4J_SERVE_DRAFT_LAYERS is not read when a draft model is given
    srv2 = DecodeServer(lm, slots=1, max_len=64, draft_model=_pair(
        num_layers=1, seed=9)[1], device="cpu")
    assert srv2.engine.draft_model.num_layers == 1


def test_env_flag_turns_speculation_on(monkeypatch):
    _, lm = _pair()
    monkeypatch.setenv("DL4J_SERVE_DRAFT_LAYERS", "1")
    srv = DecodeServer(lm, slots=1, max_len=64, device="cpu")
    assert srv.engine.spec and srv.engine.draft_model.num_layers == 1


# ---------------------------------------------------------------------------
# sampled rounds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab", [7, 64, 8192])
def test_jax_categorical_is_argmax_of_logits_plus_gumbel(vocab):  # dl4j-lint: disable=rng-reuse -- one key feeds both calls on purpose: the test holds categorical(key) to argmax(logits + gumbel(key))
    """The seam's premise, on the jax version installed: a categorical
    draw is the argmax of the logits plus Gumbel noise from the same key
    (and of the same shape)."""
    rng = np.random.default_rng(vocab)
    for i in range(8):
        logits = rng.standard_normal(vocab).astype(np.float32) * 3
        logits[rng.integers(0, vocab, vocab // 4)] = -np.inf
        key = jax.random.PRNGKey(100 + i)
        want = int(jax.random.categorical(key, jnp.asarray(logits)))
        noise = np.asarray(jax.random.gumbel(key, (vocab,), jnp.float32))
        assert want == int(np.argmax(logits + noise))


def _jax_round_draws(keys, draft_keys, gamma, vocab, rounds):
    """The reference's draws of ``rounds`` sampled rounds, replayed from
    its key chain (``_serve_spec_impl``): per round and slot, per draft
    step one split of the draft key and a Gumbel vector; then one split of
    the slot's key for ``gamma`` uniforms and one for the correction's
    Gumbel vector."""
    s = keys.shape[0]
    draft = np.zeros((rounds, gamma + 1, s, vocab), np.float32)
    uni = np.zeros((rounds, s, gamma), np.float32)
    corr = np.zeros((rounds, s, vocab), np.float32)
    for j in range(s):
        dk, k = draft_keys[j], keys[j]
        for r in range(rounds):
            for i in range(gamma + 1):
                dk, sub = jax.random.split(dk)
                draft[r, i, j] = np.asarray(
                    jax.random.gumbel(sub, (vocab,), jnp.float32))
            k, su = jax.random.split(k)
            uni[r, j] = np.asarray(jax.random.uniform(su, (gamma,)))
            k, sc = jax.random.split(k)
            corr[r, j] = np.asarray(
                jax.random.gumbel(sc, (vocab,), jnp.float32))
    return {"draft": torch.from_numpy(draft), "uniform": torch.from_numpy(uni),
            "correction": torch.from_numpy(corr)}


@pytest.mark.parametrize("top_k", [None, 10])
def test_sampled_rounds_with_replayed_draws_match_jax(top_k):
    """Three rounds in one dispatch, four slots (one frozen from the start
    and one that runs out mid-dispatch) at a temperature low enough that
    the 1-layer draft is often rejected: identical blocks, so identical
    accepts, resamples and bonus draws."""
    ref, port = _pair()
    gamma, slots, rounds = 3, 4, 3
    kw = dict(max_len=64, temperature=0.3, top_k=top_k, draft_layers=1,
              spec_tokens=gamma)
    jeng = JaxEngine(ref, slots, **kw)
    peng = DecodeEngine(port, slots, device="cpu", **kw)
    rng = np.random.default_rng(2)
    toks = []
    for slot, n in enumerate((5, 12, 20, 9)):
        prompt = rng.integers(1, 64, n).astype(np.int32)
        jtok, _ = jeng.prefill(prompt, slot, jax.random.PRNGKey(slot))
        peng.prefill(prompt, slot)
        toks.append(int(jtok))
    toks = np.asarray(toks)
    remaining = np.array([12, 12, 0, 2])
    keys = jnp.stack([jax.random.PRNGKey(50 + j) for j in range(slots)])
    dkeys = jnp.stack([jax.random.fold_in(k, 0x5bec) for k in keys])
    want, _, _ = jeng.decode_spec(toks.astype(np.int32),
                                  remaining.astype(np.int32), keys, dkeys,
                                  rounds)
    draws = _jax_round_draws(keys, dkeys, gamma, 64, rounds)
    got = peng.decode_spec(toks, remaining, [None] * slots, [None] * slots,
                           rounds, _draws=draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(peng.cache.cursors.numpy(),
                                  np.asarray(jeng.cache.cursors))
    counts = got.numpy()[:, :, 0]
    assert (counts[:, 2] == 0).all()
    assert counts[0, 3] >= 1 and (counts[1:, 3] == 0).all()
    live = counts[:, :2]
    assert live.min() >= 1 and live.max() <= gamma + 1
    # some round rejected, so a resample ran
    assert (live < gamma + 1).any()


def test_spec_round_first_token_follows_target_distribution():
    """Speculative sampling draws from the target's filtered
    distribution: over 2048 rounds from one state (the cursor rewound
    after each), the first emitted token's frequencies pass a chi-square
    test against ``softmax(filter(target logits))`` at p > 0.001."""
    _, lm = _pair()
    slots, reps, top_k = 64, 32, 10
    eng = DecodeEngine(lm, slots, max_len=64, temperature=0.9, top_k=top_k,
                       draft_layers=1, spec_tokens=2, device="cpu")
    prompt = np.array([5, 9, 2, 33, 17], np.int64)
    tok = 11
    for slot in range(slots):
        eng.prefill(prompt, slot)
    logits = lm.forward(lm.params, np.append(prompt, tok)[None])[0, -1]
    p = torch.softmax(filter_logits(logits, 0.9, top_k).double(),
                      -1).numpy()
    counts = np.zeros(64)
    for r in range(reps):
        eng.cache.cursors[:] = len(prompt)
        seeds = [r * slots + j for j in range(slots)]
        block = eng.decode_spec(
            np.full(slots, tok), np.full(slots, 8),
            [torch.Generator().manual_seed(s) for s in seeds],
            [torch.Generator().manual_seed(draft_seed(s)) for s in seeds], 1)
        np.add.at(counts, block[0, :, 1].numpy(), 1)
    support = p > 0
    assert counts[~support].sum() == 0
    assert support.sum() == top_k
    chi2 = sps.chisquare(counts[support], p[support] * counts.sum())
    assert chi2.pvalue > 1e-3, (chi2, counts[support], p[support])


def test_sampled_stream_is_independent_of_neighbours():
    _, lm = _pair(pos_encoding="rope")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 64, n) for n in (6, 15, 9)]
    kw = dict(max_len=64, temperature=0.8, top_k=12, draft_layers=1,
              spec_tokens=2, device="cpu")
    alone = DecodeServer(lm, slots=1, **kw)
    a = alone.submit(prompts[0], 10, seed=21)
    alone.drain()
    crowd = DecodeServer(lm, slots=3, fuse_steps=2, **kw)
    reqs = [crowd.submit(p, m, seed=s)
            for p, m, s in zip(prompts, (10, 3, 7), (21, 5, 6))]
    crowd.drain()
    assert reqs[0].tokens == a.tokens
    again = DecodeServer(lm, slots=3, fuse_steps=2, **kw)
    reqs2 = [again.submit(p, m, seed=s)
             for p, m, s in zip(prompts, (10, 3, 7), (21, 5, 6))]
    again.drain()
    assert [r.tokens for r in reqs2] == [r.tokens for r in reqs]


def test_draft_seed_is_a_fixed_function_of_the_seed():
    assert draft_seed(0) == draft_seed(0)
    seeds = {draft_seed(s) for s in range(1000)}
    assert len(seeds) == 1000
    assert all(0 <= d < 2 ** 63 for d in seeds)
    assert draft_seed(7) not in range(1000)
