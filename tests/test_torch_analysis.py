# dl4j-lint: skip-file -- rule-fixture corpus: the snippet strings and seeded programs in this file ARE violations and would (correctly) trip the rules they test
"""The port's static analysis against the reference's:
``deeplearning4j_tpu_torch.analysis`` beside ``deeplearning4j_tpu.analysis``.

1. **Same findings.** On every fixture snippet of the reference's own
   tests (``tests/test_analysis.py``, read with ``ast``, not imported),
   the port's engine gives the reference's findings (rule, line, symbol)
   for every rule carried as it is and for suppression hygiene; the two
   rules carried with torch spellings find nothing the reference does
   not, and find the torch spellings (``.cpu()``, ``.numpy()``,
   ``.to("cpu")``, ``torch.cuda.synchronize``, ``torch.matmul`` /
   ``F.linear`` operands) on fixtures of their own. Baseline fingerprints
   are the reference's.
2. **A clean port.** The port package and the port's test files are
   lint-clean under the port's rules with an empty baseline; the CLI
   (``python -m deeplearning4j_tpu_torch.analysis``) says so.
3. **Contracts.** ``check_network_contracts`` and
   ``check_embedding_contracts`` pass on the real cached programs
   (FF/RNN/graph x {plain, accum, guard, telemetry}, a fused skip-gram
   chunk) on the CPU's eager path and leave the network as it was; each
   of the four contracts catches its seeded violation (a step that calls
   ``.item()``, a param replaced out of place, a collective on a
   one-device step, a program under another program's key). The mesh
   cases run in ``tests/test_torch_cluster.py``'s 4-rank world.
"""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.analysis import baseline as jbase
from deeplearning4j_tpu.analysis import engine as jengine
from deeplearning4j_tpu_torch.analysis import baseline as tbase
from deeplearning4j_tpu_torch.analysis import engine as tengine
from deeplearning4j_tpu_torch.analysis.annotations import (
    HOT_PATH_REGISTRY,
    traced,
)
from deeplearning4j_tpu_torch.analysis.contracts import (
    ContractViolation,
    check_embedding_contracts,
    check_network_contracts,
    host_readbacks,
)
from deeplearning4j_tpu_torch.analysis.rules import ALL_RULES
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration, Updater
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.ops.losses import LossFunction
from deeplearning4j_tpu_torch.perf.step_graph import tree_signature

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_TESTS = os.path.join(REPO, "tests", "test_analysis.py")

#: rules the port carries as the reference writes them
CARRIED = {"lock-discipline", "bare-counter", "marker-audit",
           "recompile-hazard", "adhoc-out-shardings",
           "suppression-missing-reason"}
#: rules the port carries with torch spellings
TORCH_SPELLED = {"host-sync-in-hot-path", "implicit-f32-promotion"}


# ---------------------------------------------------------------------------
# the reference's fixture snippets
# ---------------------------------------------------------------------------


def _string_assigns(nodes):
    out = {}
    for n in nodes:
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and isinstance(n.value, ast.Constant)
                and isinstance(n.value.value, str)):
            out[n.targets[0].id] = n.value.value
    return out


def reference_fixtures():
    """``(id, source, rule, relpath, markers)`` of every ``lint_snippet``
    call in the reference's tests whose source is a literal (or a name
    bound to one)."""
    tree = ast.parse(open(REFERENCE_TESTS).read())
    module = _string_assigns(tree.body)
    cases = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        names = {**module, **_string_assigns(ast.walk(fn))}
        calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                 and isinstance(c.func, ast.Name)
                 and c.func.id == "lint_snippet" and len(c.args) > 1]
        for i, call in enumerate(sorted(calls, key=lambda c: (
                c.lineno, c.col_offset))):
            arg = call.args[1]
            src = (arg.value if isinstance(arg, ast.Constant)
                   else names.get(getattr(arg, "id", None)))
            if not isinstance(src, str):
                continue
            kw = {k.arg: k.value for k in call.keywords}
            const = {k: v.value for k, v in kw.items()
                     if isinstance(v, ast.Constant)}
            markers = ({e.value for e in kw["markers"].elts}
                       if isinstance(kw.get("markers"), (ast.Set,))
                       else {"chaos", "slow"})
            cases.append((f"{fn.name}-{i}", src, const.get("rule"),
                          const.get("relpath", "snippet.py"), markers))
    return cases


FIXTURES = reference_fixtures()


def _lint(engine, root, source, rule, relpath, markers):
    path = os.path.join(root, relpath)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(source))
    config = engine.LintConfig(root=root, registered_markers=set(markers))
    return engine.run_lint(paths=[path],
                           select=None if rule is None else [rule],
                           config=config)


def _port_path(relpath):
    return (relpath.replace("deeplearning4j_tpu/", "deeplearning4j_tpu_torch/",
                            1) if relpath.startswith("deeplearning4j_tpu/")
            else relpath)


def test_the_reference_fixtures_are_read():
    assert len(FIXTURES) >= 60
    rules = {rule for _, _, rule, _, _ in FIXTURES}
    assert CARRIED - {"suppression-missing-reason"} <= rules
    assert TORCH_SPELLED <= rules


@pytest.mark.parametrize("fixture", FIXTURES, ids=[f[0] for f in FIXTURES])
def test_port_findings_match_the_reference(tmp_path, fixture):
    _, source, rule, relpath, markers = fixture
    ref = _lint(jengine, str(tmp_path / "jax"), source, rule, relpath,
                markers)
    port = _lint(tengine, str(tmp_path / "torch"), source,
                 rule if rule in CARRIED | TORCH_SPELLED else None,
                 _port_path(relpath), markers)

    def keyed(findings, rules):
        return sorted((f.rule, f.line, f.symbol) for f in findings
                      if f.rule in rules)

    assert keyed(port, CARRIED) == keyed(ref, CARRIED)
    assert set(keyed(port, TORCH_SPELLED)) <= set(keyed(ref, TORCH_SPELLED))
    for f in port:
        if f.rule in CARRIED:
            g = next(g for g in ref if (g.rule, g.line, g.symbol) == (
                f.rule, f.line, f.symbol))
            root = str(tmp_path / "jax")
            assert tbase.fingerprint(g, root) == jbase.fingerprint(g, root)


# ---------------------------------------------------------------------------
# the torch spellings
# ---------------------------------------------------------------------------


HOST_SYNC_SEEDED = {
    ".cpu()": "t.cpu()", ".numpy()": "t.numpy()",
    ".to('cpu')": 't.to("cpu")', ".item()": "t.sum().item()",
    ".tolist()": "t.tolist()", "torch.cuda.synchronize":
        "torch.cuda.synchronize()", "float()": "float(t.sum())",
    "np.asarray": "np.asarray(t)", "flight_record": "flight_record('x')",
}


@pytest.mark.parametrize("spelling", sorted(HOST_SYNC_SEEDED))
def test_host_sync_torch_spellings(tmp_path, spelling):
    src = f"""
        @traced
        def body():
            h = helper(static)

        def helper(t):
            return {HOST_SYNC_SEEDED[spelling]}
        """
    found = _lint(tengine, str(tmp_path), src, "host-sync-in-hot-path",
                  "snippet.py", ())
    assert [(f.rule, f.symbol) for f in found] == [
        ("host-sync-in-hot-path", "helper")]
    assert spelling.split("(")[0].strip(".") in found[0].message


def test_host_sync_registry_roots_and_clean_code(tmp_path):
    found = _lint(tengine, str(tmp_path), """
        class FusedTraining:
            def _variant_step(self, params, batch):
                return self._loss_grads(params, batch)

            def _loss_grads(self, params, batch):
                return params.cpu()

            def launch(self, k):
                return self.hist.cpu()  # host side of the chunk: cold

        @traced
        def body(t):
            n = float(len(t))          # a host scalar
            return t.to(torch.float32).to(device=t.device) * n

        @traced
        def muted(t):
            return t.item()  # dl4j-lint: disable=host-sync-in-hot-path -- debug helper, never captured
        """, "host-sync-in-hot-path", "snippet.py", ())
    assert [(f.line, f.symbol) for f in found] == [
        (7, "FusedTraining._loss_grads")]
    assert {"_variant_step", "_step_impl", "_neg_epoch_math",
            "skipgram_epoch_plan"} <= HOT_PATH_REGISTRY
    assert "_epoch_run_fn" not in HOT_PATH_REGISTRY


def test_implicit_f32_torch_spellings(tmp_path):
    found = _lint(tengine, str(tmp_path), """
        @traced
        def _block(self, pol, blk, h):
            w = blk["mlp"]["w1"]
            a = torch.matmul(h, blk["attn"]["wq"])
            b = F.linear(a, w)
            c = torch.mm(b, pol.cast_compute(blk["out"]["w2"]))
            d = c @ blk["out"]["w3"].to(c.dtype)
            x = blk["x"]
            return torch.bmm(d, x.transpose(0, 1))
        """, "implicit-f32-promotion", "snippet.py", ())
    assert sorted((f.line, f.symbol) for f in found) == [
        (5, "_block"), (6, "_block"), (10, "_block")]


def test_the_catalog_and_its_dropped_rules():
    ids = [r.id for r in ALL_RULES]
    assert ids == ["host-sync-in-hot-path", "implicit-f32-promotion",
                   "recompile-hazard", "lock-discipline", "bare-counter",
                   "marker-audit", "adhoc-out-shardings"]
    from deeplearning4j_tpu_torch.analysis import rules

    assert "rng-reuse" in rules.__doc__ and "torch.Generator" in rules.__doc__
    assert "donation-consistency" in rules.__doc__
    assert "contract 2" in rules.__doc__
    def step():
        pass

    assert traced(step) is step and step.__dl4j_traced__


def test_baseline_fingerprints_round_trip(tmp_path):
    src = """
        @traced
        def step(t):
            return t.item()
        """
    (f,) = _lint(tengine, str(tmp_path), src, "host-sync-in-hot-path",
                 "snippet.py", ())
    (g,) = _lint(jengine, str(tmp_path / "j"), src, "host-sync-in-hot-path",
                 "snippet.py", ())
    assert tbase.fingerprint(f, str(tmp_path)) == jbase.fingerprint(
        g, str(tmp_path / "j"))
    path = str(tmp_path / "baseline.json")
    assert tbase.save_baseline([f], path=path, root=str(tmp_path)) == 1
    assert set(jbase.load_baseline(path)) == set(tbase.load_baseline(path))
    new, old = tbase.partition_findings([f], tbase.load_baseline(path),
                                        root=str(tmp_path))
    assert new == [] and old == [f]
    assert tbase.load_baseline(str(tmp_path / "absent.json")) == {}


def test_the_port_and_its_tests_are_lint_clean():
    paths = tengine.default_scan_paths()
    assert os.path.join(REPO, "deeplearning4j_tpu_torch") in paths
    assert os.path.join(REPO, "tests", "test_torch_analysis.py") in paths
    assert not any(p.endswith("tests/test_analysis.py") for p in paths)
    findings = tengine.run_lint()
    assert [f.format() for f in findings] == []
    assert not os.path.exists(tbase.DEFAULT_BASELINE)


def _cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.analysis", *args],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})


def test_cli(tmp_path):
    ok = _cli("deeplearning4j_tpu_torch/analysis", "tests/torch_worlds.py")
    assert ok.returncode == 0 and "dl4j-lint: OK" in ok.stdout
    rules = _cli("--list-rules")
    assert rules.returncode == 0
    assert "suppression-missing-reason" in rules.stdout
    assert "rng-reuse" not in rules.stdout
    bad = tmp_path / "bad.py"
    bad.write_text("@traced\ndef step(t):\n    return t.cpu()\n")
    seeded = _cli(str(bad), "--no-baseline")
    assert seeded.returncode == 1 and "host-sync-in-hot-path" in seeded.stderr
    assert _cli("--select", "rng-reuse").returncode == 2
    assert _cli(str(tmp_path / "nope")).returncode == 2


# ---------------------------------------------------------------------------
# program contracts on the CPU's eager path
# ---------------------------------------------------------------------------


def _builder(lr=0.05, updater=Updater.ADAM):
    return (NeuralNetConfiguration.Builder().seed(0).learning_rate(lr)
            .updater(updater))


def _ff_net():
    conf = (_builder().list()
            .layer(0, L.DenseLayer(n_in=6, n_out=12, activation="tanh"))
            .layer(1, L.OutputLayer(n_in=12, n_out=3)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _rnn_net():
    conf = (_builder(0.02, Updater.SGD).list()
            .layer(0, L.GravesLSTM(n_in=3, n_out=6, activation="tanh"))
            .layer(1, L.RnnOutputLayer(n_in=6, n_out=4,
                                       loss_function=LossFunction.MCXENT))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _ff_graph():
    conf = (_builder().graph_builder().add_inputs("in")
            .add_layer("dense", L.DenseLayer(n_in=6, n_out=12,
                                             activation="tanh"), "in")
            .add_layer("out", L.OutputLayer(n_in=12, n_out=3), "dense")
            .set_outputs("out").build())
    return ComputationGraph(conf, device="cpu").init()


def _ff_data(n=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return DataSet(x, y)


def _rnn_data(n=24, t=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (n, t))]
    return DataSet(x, y)


PROGRAM_VARIANTS = (
    (True, 1, False, 0),   # plain
    (False, 2, False, 0),  # accumulated
    (True, 1, True, 0),    # sentinel-guarded (the fit_epochs default)
    (True, 1, False, 1),   # telemetry pack
    (True, 1, True, 2),    # guard + strided pack composed
)


def _net_and_cache(kind):
    if kind == "rnn":
        net, data, batch = _rnn_net(), _rnn_data(), 8
    else:
        net = _ff_net() if kind == "ff" else _ff_graph()
        data, batch = _ff_data(), 16
    cache = net.build_epoch_cache(ListDataSetIterator(data, batch))
    assert cache is not None
    return net, cache


def _key(net, cache, key):
    return ("fit_epochs", tree_signature(cache.batch_stacks())) + key


def _state_np(net):
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    return [t.detach().numpy().copy() for t in tree_leaves(
        (net.params, net.updater_state, net.net_state))]


@pytest.mark.parametrize("kind", ["ff", "rnn", "graph"])
def test_all_cached_variants_satisfy_contract(kind):
    net, cache = _net_and_cache(kind)
    for key in PROGRAM_VARIANTS:
        net._epoch_program(cache, *key)
    before, it = _state_np(net), net.iteration_count
    results = check_network_contracts(net, cache)
    assert sorted(results) == sorted(PROGRAM_VARIANTS)
    assert all(v == [] for v in results.values())
    after = _state_np(net)
    assert net.iteration_count == it
    assert all(np.array_equal(a, b) for a, b in zip(before, after))


def test_programs_cached_by_fit_epochs_pass():
    net = _ff_net()
    net.fit_epochs(ListDataSetIterator(_ff_data(), 16), 2)
    cache = net.build_epoch_cache(ListDataSetIterator(_ff_data(), 16))
    hist = net.fit_epochs(cache, 1)
    gen = net._rng.get_state()
    assert check_network_contracts(net, cache) == {(True, 1, True, 0): []}
    assert torch.equal(net._rng.get_state(), gen)
    # the checked network trains on exactly as an unchecked one
    twin = _ff_net()
    twin.fit_epochs(ListDataSetIterator(_ff_data(), 16), 2)
    twin_hist = twin.fit_epochs(twin.build_epoch_cache(
        ListDataSetIterator(_ff_data(), 16)), 1)
    assert torch.equal(hist, twin_hist)
    assert torch.equal(net.fit_epochs(cache, 1),
                       twin.fit_epochs(twin.build_epoch_cache(
                           ListDataSetIterator(_ff_data(), 16)), 1))


def _seeded(net, cache, key, make_body):
    prog = net._programs[_key(net, cache, key)]
    prog.graph.fn = make_body(prog.graph.fn, net._static, prog)
    return prog


def test_seeded_host_readback_in_a_step_fails():
    """Contract 1: a step that reads a value back (``.item()``)."""
    net, cache = _net_and_cache("ff")
    key = (True, 1, False, 0)
    net._epoch_program(cache, *key)

    def item(body, st, prog):
        def bad():
            body()
            prog.row[0, 0].item()
        return bad

    _seeded(net, cache, key, item)
    with pytest.raises(ContractViolation) as exc:
        check_network_contracts(net, cache)
    assert "host readback(s) ['item']" in str(exc.value)
    assert str(key) in str(exc.value)


def test_seeded_param_replaced_out_of_place_fails():
    """Contract 2: a step that rebinds a param instead of writing it."""
    net, cache = _net_and_cache("ff")
    key = (True, 1, True, 0)
    net._epoch_program(cache, *key)

    def rebind(body, st, prog):
        def bad():
            body()
            st.params["0"]["W"] = st.params["0"]["W"] * 1.0
        return bad

    _seeded(net, cache, key, rebind)
    results = check_network_contracts(net, cache, raise_on_violation=False)
    (probe, chunk) = results[key]
    assert "lost their storage across the probe step" in probe
    assert "across the chunk" in chunk
    assert check_network_contracts(net, cache, expect_donation=False,
                                   raise_on_violation=False)[key] == []


def test_seeded_collective_on_a_one_device_step_fails(tmp_path):
    """Contract 3: a one-device step issues no collective."""
    from deeplearning4j_tpu_torch.parallel.collectives import all_reduce_
    from deeplearning4j_tpu_torch.parallel.mesh import join_world, leave_world

    net, cache = _net_and_cache("ff")
    key = (True, 1, False, 0)
    net._epoch_program(cache, *key)

    def summed(body, st, prog):
        def bad():
            body()
            all_reduce_(torch.zeros(1), None)
        return bad

    _seeded(net, cache, key, summed)
    join_world(str(tmp_path / "store"), 0, 1, backend="gloo")
    try:
        results = check_network_contracts(net, cache,
                                          raise_on_violation=False)
    finally:
        leave_world()
    (v,) = results[key]
    assert "collective(s) ['all_reduce'] over undeclared mesh axis" in v
    assert "(declared: none)" in v


def test_seeded_key_output_mismatch_fails():
    """Contract 4: a guarded program cached under an unguarded key."""
    net, cache = _net_and_cache("ff")
    guarded = net._epoch_program(cache, True, 1, True, 0)
    net._programs[_key(net, cache, (True, 1, False, 0))] = guarded
    with pytest.raises(ContractViolation) as exc:
        check_network_contracts(net, cache)
    assert "outputs do not match its key" in str(exc.value)
    assert "returns a trip history" in str(exc.value)


def test_empty_program_cache_is_an_error_not_a_pass():
    net, cache = _net_and_cache("ff")
    with pytest.raises(ValueError, match="no cached fused programs"):
        check_network_contracts(net, cache)
    assert check_network_contracts(net, cache, require_programs=False) == {}


def test_host_readbacks_sees_each_spelling():
    t = torch.ones(3)

    def reads():
        t.sum().item()
        float(t.sum())
        bool(t.sum() > 0)
        t.tolist()
        t.to("cpu")
        t.numpy()
        t.cpu()

    assert host_readbacks(reads) == ["item", "__float__", "__bool__",
                                     "tolist", "to('cpu')", "numpy", "cpu"]
    assert host_readbacks(lambda: (t * 2).add_(1).to(torch.float64)) == []


def _w2v():
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        CollectionSentenceIterator)
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    rng = np.random.default_rng(7)
    words = [f"w{i}" for i in range(40)]
    sents = [" ".join(rng.choice(words, size=rng.integers(3, 12)))
             for _ in range(70)]
    m = Word2Vec(CollectionSentenceIterator(sents), device="cpu",
                 min_word_frequency=1, layer_size=8, window_size=3,
                 negative=3, seed=0, epochs=2)
    m.fit_epochs(2)
    return m, m.build_corpus_cache()


def test_embedding_contracts_pass_and_catch_seeded_violations():
    m, cache = _w2v()
    syn0, it = m.syn0.clone(), m.iteration_count
    (key, prog), = m._epoch_steps.items()
    assert check_embedding_contracts(m, cache) == {key: []}
    assert torch.equal(m.syn0, syn0) and m.iteration_count == it
    step = prog.graph.fn

    def reads():
        step()
        prog.row.sum().item()

    prog.graph.fn = reads
    with pytest.raises(ContractViolation, match=r"host readback"):
        check_embedding_contracts(m, cache)

    def rebinds():
        step()
        prog.syn0 = prog.syn0 + 0.0

    prog.graph.fn = rebinds
    v = check_embedding_contracts(m, cache, raise_on_violation=False)[key]
    assert any("lost their storage" in x for x in v)
    m._epoch_steps.clear()
    with pytest.raises(ValueError, match="no cached fused skip-gram"):
        check_embedding_contracts(m, cache)
