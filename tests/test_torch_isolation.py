"""The port stands alone: ``deeplearning4j_tpu_torch`` and every one of
its submodules import without pulling in ``jax`` or any module of the
JAX package, its entry points (the fused epoch path's included) refuse
to fall back to the CPU silently,
and its kernel module imports on a machine without ``nvcc``."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, env=None) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, **(env or {})})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_imports_neither_jax_nor_the_jax_package():
    out = _run("""
        import importlib, pkgutil, sys
        import deeplearning4j_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "jaxlib" or m.startswith("jaxlib.")
                        or m == "deeplearning4j_tpu"
                        or m.startswith("deeplearning4j_tpu."))
        new = [n for n in names if n.split(".")[1] in ("optimize", "utils",
                                                      "cli")]
        fleet = [n for n in names if n.startswith(
            ("deeplearning4j_tpu_torch.serving.fleet",
             "deeplearning4j_tpu_torch.parallel",
             "deeplearning4j_tpu_torch.serving.compile_cache"))]
        embeddings = [n for n in names if n.split(".")[1] in ("nlp",
                                                             "graph")]
        trees = [n for n in names if n.split(".")[1] in ("clustering", "plot")
                 or n == "deeplearning4j_tpu_torch.models.rntn"]
        host = [n for n in names if n.split(".")[1] in (
            "ui", "ml", "cloud", "analysis")
            or n in ("deeplearning4j_tpu_torch.resilience.lease",
                     "deeplearning4j_tpu_torch.resilience.autopilot",
                     "deeplearning4j_tpu_torch.parallel.registry")]
        print(len(names), len(new), len(fleet), len(embeddings), len(trees),
              len(host), leaked)
    """)
    count, new, fleet, embeddings, trees, host, leaked = out.split(" ", 6)
    assert int(count) >= 15
    # optimize (4 modules), utils (3) and cli (2) are walked too
    assert int(new) >= 9
    # and the serve fleet (6), parallel (11: the mesh, its registry and
    # collectives, data parallelism, FSDP, the TP specs, the ring and
    # Ulysses since A14.1) and the compile cache
    assert int(fleet) >= 18
    # and the embeddings: nlp (13 modules) and graph (4)
    assert int(embeddings) >= 17
    # and clustering (6 modules), plot (3) and the RNTN
    assert int(trees) >= 10
    # and the last host-side modules: ui (4), ml (3), cloud (2), analysis
    # (7 with its CLI), the lease, the autopilot and the config registry
    assert int(host) >= 19
    assert leaked.strip() == "[]"


@pytest.mark.parametrize("module", [
    "deeplearning4j_tpu_torch.optimize", "deeplearning4j_tpu_torch.utils",
    "deeplearning4j_tpu_torch.cli", "deeplearning4j_tpu_torch.datasets.records",
    "deeplearning4j_tpu_torch.nn.conf.compat",
    "deeplearning4j_tpu_torch.native", "deeplearning4j_tpu_torch.earlystopping",
    "deeplearning4j_tpu_torch.gradientcheck",
    "deeplearning4j_tpu_torch.parallel.cluster",
    "deeplearning4j_tpu_torch.monitor",
    "deeplearning4j_tpu_torch.datasets.fetchers",
    "deeplearning4j_tpu_torch.nlp", "deeplearning4j_tpu_torch.nlp.epoch_kernels",
    "deeplearning4j_tpu_torch.graph", "deeplearning4j_tpu_torch.clustering",
    "deeplearning4j_tpu_torch.plot", "deeplearning4j_tpu_torch.models.rntn",
    "deeplearning4j_tpu_torch.parallel.mesh",
    "deeplearning4j_tpu_torch.parallel.ring_attention",
    "deeplearning4j_tpu_torch.parallel.data_parallel",
    "deeplearning4j_tpu_torch.parallel.tensor_parallel",
    "deeplearning4j_tpu_torch.parallel.pipeline_parallel",
    "deeplearning4j_tpu_torch.parallel.expert_parallel",
    "deeplearning4j_tpu_torch.resilience.lease",
    "deeplearning4j_tpu_torch.ui", "deeplearning4j_tpu_torch.ml",
    "deeplearning4j_tpu_torch.analysis.contracts"])
def test_front_door_modules_import_first(module):
    """Each imports on its own in a fresh interpreter (no import cycle
    through ``nn``)."""
    assert _run(f"import {module}; print('ok')").strip() == "ok"


#: reference modules without a module of the same path in the port, each
#: with its reason
NO_COUNTERPART = {
    # a jax shard_map shim: torch has no shard_map to paper over
    "compat.py": None,
    # the Pallas kernels: hand-written CUDA in kernels/ (B1-B3)
    "pallas/__init__.py": "kernels/__init__.py",
    "pallas/flash_attention.py": "kernels/flash_attention.py",
}


def test_every_reference_module_has_a_counterpart():
    """Every ``.py`` under ``deeplearning4j_tpu/`` has a module at the
    same path under ``deeplearning4j_tpu_torch/``, apart from
    :data:`NO_COUNTERPART` (walked without importing either package)."""
    def files(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
                for d, _, fs in os.walk(root) for f in fs
                if f.endswith(".py") and "__pycache__" not in d}

    ref, port = files("deeplearning4j_tpu"), files("deeplearning4j_tpu_torch")
    assert len(ref) > 150
    missing = sorted(ref - port - set(NO_COUNTERPART))
    assert missing == []
    for path, instead in NO_COUNTERPART.items():
        assert path in ref and path not in port
        assert instead is None or instead in port


def test_entry_points_raise_without_a_card(monkeypatch):
    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving import DecodeEngine, DecodeServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(vocab_size=16, d_model=32, num_heads=1, num_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    lm = TransformerLM(vocab_size=16, d_model=32, num_heads=1,
                       num_layers=1, max_len=16, device="cpu")
    assert lm.device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    # a CPU model is served only when the caller asks for the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeServer(lm, slots=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(lm, 1)
    assert DecodeServer(lm, slots=1, device="cpu").engine.device == \
        torch.device("cpu")
    # the fleet's replicas and the speculative engine likewise
    from deeplearning4j_tpu_torch.serving.fleet import (
        FleetRouter, ServeReplica)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeReplica("r0", lm, slots=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetRouter.build(lm, replicas=1, slots=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(lm, 1, draft_layers=1)
    assert ServeReplica("r0", lm, slots=1, device="cpu").server.engine \
        .device == torch.device("cpu")


def test_fused_epoch_paths_raise_without_a_card(monkeypatch):
    """``fit_epochs`` and ``build_epoch_cache`` do not train on the CPU
    unless the CPU is asked for."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import (
        DataSet,
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.perf.epoch_cache import (
        DeviceDataSetCache,
        DeviceMultiDataSetCache,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((8, 784), np.float32)
    y = np.eye(10, dtype=np.float32)[np.zeros(8, int)]
    it = ListDataSetIterator(DataSet(x, y), 4)
    for cls in (DeviceDataSetCache, DeviceMultiDataSetCache):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls.build(it)  # no device means the card, and there is none
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.mnist_mlp(hidden=8).fit_epochs(it, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.resnet18().build_epoch_cache(it)
    net = zoo.mnist_mlp(hidden=8, device="cpu").init()
    assert net.build_epoch_cache(it).device == torch.device("cpu")
    assert net.fit_epochs(it, 1).shape == (1, 2)


def test_kernel_module_imports_without_nvcc(tmp_path):
    out = _run("""
        import os
        from deeplearning4j_tpu_torch.kernels import _build
        from deeplearning4j_tpu_torch.kernels import flash_attention as fa
        try:
            _build.nvcc_path()
            print("nvcc found")
        except RuntimeError:
            print("no nvcc")
        print(fa.flash_attention_fwd.launches)
    """, env={"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)})
    assert out.split() == ["no", "nvcc", "0"]


def test_front_door_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The CLI, ``ModelSerializer.restore`` and the networks it builds run
    on the card unless told ``cpu``."""
    import numpy as np

    from deeplearning4j_tpu_torch.cli import main
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.utils import ModelSerializer

    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(zoo.mnist_mlp(hidden=8, device="cpu"), path)
    data = tmp_path / "d.csv"
    data.write_text("\n".join(",".join(["0.5"] * 784 + ["1"])
                              for _ in range(4)) + "\n")
    conf = tmp_path / "c.json"
    conf.write_text(zoo.mnist_mlp(hidden=8, device="cpu").conf.to_json())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelSerializer.restore(path)
    for argv in (["train", "-model", str(conf), "-output", path],
                 ["test", "-model", path], ["predict", "-model", path]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["-input", str(data), "--num-classes", "10"])
    net = ModelSerializer.restore(path, device="cpu")
    assert net.device == torch.device("cpu")
    assert net.predict(np.full((2, 784), 0.5, np.float32)).shape == (2,)


def test_embedding_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """Word2Vec, SequenceVectors, ParagraphVectors, Glove, DeepWalk and
    the word-vector loader train or load on the card unless told ``cpu``;
    over a mesh of one device the fused path is the meshless one."""
    from deeplearning4j_tpu_torch.graph import DeepWalk
    from deeplearning4j_tpu_torch.nlp import (
        CollectionSentenceIterator,
        Glove,
        ParagraphVectors,
        SequenceVectors,
        Word2Vec,
    )
    from deeplearning4j_tpu_torch.nlp.serializer import (
        load_word_vectors,
        write_word_vectors,
    )

    it = CollectionSentenceIterator(["a b c a b", "b c a"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Word2Vec(it), lambda: Glove(it),
                 lambda: ParagraphVectors(sentence_iterator=it),
                 lambda: SequenceVectors([["a", "b"]]), lambda: DeepWalk(),
                 lambda: Word2Vec.Builder().iterate(it).build(),
                 lambda: DeepWalk.Builder().build()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    w = Word2Vec(it, min_word_frequency=1, layer_size=4, device="cpu")
    assert w.device == torch.device("cpu")
    class MeshOfOne:
        mesh_dim_names, shape = ("data",), (1,)

    assert w.fit_epochs(1, mesh=MeshOfOne()).shape[0] == 1
    assert w._fused_mode(MeshOfOne()) == "single"
    assert w.fit_epochs(1).shape[0] == 1
    path = str(tmp_path / "v.txt")
    write_word_vectors(w, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_word_vectors(path)
    assert load_word_vectors(path, device="cpu").syn0.shape == (3, 4)


def test_tree_and_clustering_entry_points_raise_without_a_card(monkeypatch):
    """The RNTN, the tagger's Viterbi, k-means and t-SNE run on the card
    unless told ``cpu``."""
    import numpy as np

    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.models import RNTN
    from deeplearning4j_tpu_torch.nlp import HmmPosTagger, Tree, Viterbi
    from deeplearning4j_tpu_torch.plot import Tsne

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).normal(size=(12, 3)).astype(np.float32)
    for make in (RNTN, lambda: KMeansClustering(2).apply_to(pts),
                 lambda: Tsne(max_iter=2).fit_transform(pts),
                 HmmPosTagger, lambda: Viterbi(3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    trees = [Tree.parse("(1 (0 a) (1 b))")]
    rntn = RNTN(num_hidden=3, num_classes=2, device="cpu").init(trees)
    assert rntn.params["L"].device == torch.device("cpu")
    assert rntn.predict(trees[0]).shape == (3,)
    assert KMeansClustering(2, device="cpu").apply_to(pts) \
        .assignments.shape == (12,)
    assert Tsne(max_iter=2, perplexity=3.0, device="cpu") \
        .fit_transform(pts).shape == (12, 2)


def test_mesh_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """A mesh, and the wrappers that build one, are on the card unless
    told ``cpu`` (the MoE's weights too), and so is a
    DistributedWord2Vec's; the config registry needs no card."""
    import deeplearning4j_tpu_torch.parallel as par
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, build_mesh, mesh)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.join_world("unused", 0, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParallelWrapper(zoo.mnist_mlp(hidden=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.init_moe_params(par.MoEConfig(4, 8, 2), torch.Generator())
    from deeplearning4j_tpu_torch.nlp import CollectionSentenceIterator
    from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedWord2Vec(CollectionSentenceIterator(["a b"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.NetworkWorkPerformer(zoo.mnist_mlp(hidden=8, device="cpu")
                                 .conf.to_json())
    assert par.HeartbeatMonitor(par.InMemoryStateTracker(), "w").worker_id \
        == "w"
    assert par.ConfigRegistry(str(tmp_path)).hosts() == []
