"""The port's host-side modules against the reference's: the spark.ml-style
pipeline (``ml``), the utils (``archive``, ``diskqueue``, ``mathutils``,
``stringgrid``), the config registry (``parallel/registry.py``) and the
provisioning command builder (``cloud``).

1. **Pipeline predictions** from weights carried out of a fitted JAX
   estimator (``models/convert.load_network_from_jax``) equal the
   reference's: probabilities and reconstruction columns at float32
   rtol 1e-5, predictions exactly; the scaler's statistics are the
   reference's; a port estimator fitted on the CPU separates the blobs.
2. **Utils** give the reference's results: every ``mathutils`` function
   on seeded inputs, the string grid's text, archive extraction and the
   disk queue's FIFO.
3. **One registry format**: a directory written by either package is
   read by the other.
4. **Provisioning commands** for the VM with one H100 are built as
   specified, and nothing is executed.
"""

import inspect
import os
import subprocess
import tarfile
import threading
import time
import zipfile

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import ml as jml
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import Updater as JaxUpdater
from deeplearning4j_tpu.nn.conf import layers as jax_L
from deeplearning4j_tpu.parallel.registry import ConfigRegistry as JaxRegistry
from deeplearning4j_tpu.utils import mathutils as jmu
from deeplearning4j_tpu.utils import stringgrid as jsg
from deeplearning4j_tpu_torch import ml as tml
from deeplearning4j_tpu_torch.cloud import (
    GcsTransfer,
    GpuProvisioner,
    GpuVmSpec,
)
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration, Updater
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.parallel import ConfigRegistry
from deeplearning4j_tpu_torch.utils import (
    DiskBasedQueue,
    StringGrid,
    unzip_file_to,
)
from deeplearning4j_tpu_torch.utils import mathutils as tmu

RTOL = 1e-5


def _blobs(rng, n=96, d=4, classes=3, spread=4.0):
    centers = rng.normal(size=(classes, d)) * spread
    labels = rng.integers(0, classes, n)
    x = centers[labels] + rng.normal(size=(n, d)) * 0.5
    return {"features": x.astype(np.float32), "label": labels}


def _clf_conf(nnc, updater, layers, d=4, classes=3):
    return (nnc.Builder().seed(0).learning_rate(0.1).updater(updater.ADAM)
            .list()
            .layer(0, layers.DenseLayer(n_in=d, n_out=16, activation="relu"))
            .layer(1, layers.OutputLayer(n_in=16, n_out=classes))
            .build())


def _ae_conf(nnc, updater, layers, d=6):
    return (nnc.Builder().seed(0).learning_rate(0.05)
            .updater(updater.ADAGRAD).list()
            .layer(0, layers.AutoEncoder(n_in=d, n_out=3, corruption_level=0.0,
                                         activation="sigmoid"))
            .layer(1, layers.OutputLayer(n_in=3, n_out=d,
                                         activation="sigmoid"))
            .pretrain(True).backprop(False)
            .build())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carried(jax_net, conf):
    port = MultiLayerNetwork(conf, device="cpu").init()
    return load_network_from_jax(port, _np(jax_net.params),
                                 _np(jax_net.updater_state),
                                 _np(jax_net.net_state),
                                 jax_net.iteration_count)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def test_classification_predictions_match_the_reference():
    data = _blobs(np.random.default_rng(0), spread=50.0)
    ref = jml.Pipeline([
        jml.StandardScaler(),
        jml.NeuralNetClassification(_clf_conf(JaxNNC, JaxUpdater, jax_L),
                                    epochs=3, batch_size=32),
    ]).fit(data)
    jscaler, jclf = ref.get("stages")
    scaler = tml.StandardScaler().fit(data)
    for attr in ("mean", "std"):
        np.testing.assert_allclose(getattr(scaler, attr),
                                   getattr(jscaler, attr), rtol=RTOL)
    clf = tml.NeuralNetClassificationModel(
        _carried(jclf.network, _clf_conf(NeuralNetConfiguration, Updater,
                                         L)),
        features_col="features", prediction_col="prediction",
        probability_col="probability")
    port = tml.PipelineModel([scaler, clf])
    want, got = ref.transform(data), port.transform(data)
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_array_equal(clf.predict(scaler.transform(data)[
        "features"]), want["prediction"])
    assert "prediction" not in data


@pytest.mark.parametrize("kind", ["reconstruction", "unsupervised"])
def test_pretrained_columns_match_the_reference(kind):
    x = (np.random.default_rng(1).random((64, 6)) > 0.5).astype(np.float32)
    data = {"features": x}
    if kind == "reconstruction":
        ref = jml.NeuralNetReconstruction(
            _ae_conf(JaxNNC, JaxUpdater, jax_L), epochs=2).fit(data)
        port = tml.NeuralNetReconstructionModel(
            _carried(ref.network, _ae_conf(NeuralNetConfiguration, Updater,
                                           L)),
            layer_index=0, features_col="features",
            reconstruction_col="reconstruction")
        col = "reconstruction"
    else:
        ref = jml.NeuralNetUnsupervised(
            _ae_conf(JaxNNC, JaxUpdater, jax_L), epochs=2).fit(data)
        port = tml.NeuralNetUnsupervisedModel(
            _carried(ref.network, _ae_conf(NeuralNetConfiguration, Updater,
                                           L)),
            features_col="features", output_col="embedding")
        col = "embedding"
    want, got = ref.transform(data)[col], port.transform(data)[col]
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_port_estimators_fit_on_the_cpu():
    rng = np.random.default_rng(2)
    data = _blobs(rng)
    est = tml.NeuralNetClassification(
        _clf_conf(NeuralNetConfiguration, Updater, L), epochs=30,
        batch_size=32, device="cpu")
    assert est.copy(epochs=9).get("epochs") == 9 and est.get("epochs") == 30
    with pytest.raises(KeyError):
        est.set("nope", 1)
    out = est.fit(data).transform(data)
    assert out["probability"].shape == (96, 3)
    assert (out["prediction"] == data["label"]).mean() > 0.9
    x = (rng.random((32, 6)) > 0.5).astype(np.float32)
    emb = tml.NeuralNetUnsupervised(
        _ae_conf(NeuralNetConfiguration, Updater, L), epochs=1,
        device="cpu").fit({"features": x}).transform({"features": x})
    assert np.isfinite(emb["embedding"]).all()
    with pytest.raises(TypeError):
        tml.Pipeline([object()]).fit({"features": np.zeros((2, 2))})


# ---------------------------------------------------------------------------
# the utils
# ---------------------------------------------------------------------------


def _mathutils_calls(rng):
    """(name, args) of every public mathutils function, seeded."""
    a = rng.normal(size=12)
    b = rng.normal(size=12)
    counts = rng.integers(1, 20, 5).astype(float)
    return [
        ("normalize", (3.7, -1.0, 9.5)),
        ("normalize_array", (a, -2.0, 3.0)),
        ("clamp", (12.3, -1.0, 10.0)),
        ("entropy", (counts / counts.sum(),)),
        ("information_gain", ([8, 5, 3], [[5, 1, 0], [3, 4, 3]])),
        ("log2", (37.0,)),
        ("sum_of_squares", (a,)),
        ("sum_of_products", (a, b)),
        ("ss_reg", (a, b)),
        ("ss_error", (a, b)),
        ("correlation", (a, b)),
        ("euclidean_distance", (a, b)),
        ("manhattan_distance", (a, b)),
        ("round_to_decimals", (float(a[0]), 3)),
        ("discretize", (0.37, 0.0, 1.0, 7)),
        ("next_power_of_2", (37,)),
        ("factorial", (9,)),
        ("permutation", (9, 4)),
        ("combination", (9, 4)),
        ("sigmoid", (float(a[1]),)),
        ("bernoullis", (3.0, 7.0, 0.4)),
        ("uniform", (np.random.default_rng(5), -2.0, 4.0)),
        ("weights_for", (counts,)),
    ]


def test_every_mathutils_function_matches_the_reference():
    public = {n for n, f in inspect.getmembers(tmu, inspect.isfunction)
              if not n.startswith("_") and f.__module__ == tmu.__name__}
    calls = _mathutils_calls(np.random.default_rng(3))
    assert {n for n, _ in calls} == public
    for name, args in calls:
        if name == "uniform":
            got = tmu.uniform(np.random.default_rng(5), -2.0, 4.0)
            want = jmu.uniform(np.random.default_rng(5), -2.0, 4.0)
        else:
            got, want = getattr(tmu, name)(*args), getattr(jmu, name)(*args)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_stringgrid_output_matches_the_reference(tmp_path):
    lines = ["a,1,x", "b,2,", "a,1,x", "c,3,z", "d,10,y"]
    grids = {"torch": StringGrid.from_input(lines, ","),
             "jax": jsg.StringGrid.from_input(lines, ",")}
    out = {}
    for name, g in grids.items():
        out[name] = [
            g.to_lines(), g.get_column(1), g.dedupe_rows().to_lines(),
            g.remove_rows_with_empty_column(2).to_lines(),
            g.filter_by_value(0, "a").to_lines(),
            g.sort_by_column(1, reverse=True).to_lines(),
            g.select_columns([2, 0]).to_lines(),
            g.append_column(list("pqrst")).to_lines(),
            g.filter_rows_by_column(1, lambda v: int(v) > 1).to_lines(),
        ]
        path = str(tmp_path / f"{name}.csv")
        g.write_file(path)
        out[name].append(open(path).read())
    assert out["torch"] == out["jax"]
    assert StringGrid.from_file(str(tmp_path / "jax.csv"), ",") == \
        grids["torch"]
    with pytest.raises(ValueError):
        StringGrid(",", [["a"], ["b", "c"]])


def test_archive_and_diskqueue_round_trip(tmp_path):
    z = tmp_path / "a.zip"
    with zipfile.ZipFile(z, "w") as zf:
        zf.writestr("inner/data.txt", "hello")
    unzip_file_to(str(z), str(tmp_path / "out"))
    assert (tmp_path / "out" / "inner" / "data.txt").read_text() == "hello"
    src = tmp_path / "f.txt"
    src.write_text("content")
    with tarfile.open(tmp_path / "a.tar.gz", "w:gz") as tf:
        tf.add(src, arcname="f.txt")
    unzip_file_to(str(tmp_path / "a.tar.gz"), str(tmp_path / "out2"))
    assert (tmp_path / "out2" / "f.txt").read_text() == "content"
    with zipfile.ZipFile(tmp_path / "evil.zip", "w") as zf:
        zf.writestr("../escape.txt", "bad")
    with pytest.raises(ValueError):
        unzip_file_to(str(tmp_path / "evil.zip"), str(tmp_path / "out3"))
    d = str(tmp_path / "q")
    items = [{"i": i, "a": np.arange(i)} for i in range(6)]
    with DiskBasedQueue(d) as q:
        assert q.poll() is None and q.is_empty()
        for it in items:
            q.add(it)
        assert q.size() == 6 and q.poll()["i"] == 0
        rest = list(q.drain())
        assert [x["i"] for x in rest] == [1, 2, 3, 4, 5]
        np.testing.assert_array_equal(rest[-1]["a"], items[-1]["a"])
    assert not os.path.exists(d)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [
    (ConfigRegistry, JaxRegistry), (JaxRegistry, ConfigRegistry)])
def test_registry_directory_is_read_by_the_other_package(tmp_path, writer,
                                                         reader):
    root = str(tmp_path / "reg")
    w = writer(root)
    confs = {("host-0", "train"): {"lr": 0.1, "layers": [784, 10]},
             ("host-0", "eval"): {"batch": 64},
             ("host-1", "train"): {"lr": 0.2, "note": "ü"}}
    for (h, t), c in confs.items():
        w.register(h, t, c)
    w.unregister("host-0", "eval")
    r = reader(root)
    assert r.hosts() == w.hosts() == ["host-0", "host-1"]
    assert r.tasks("host-0") == ["train"]
    for (h, t), c in confs.items():
        if (h, t) != ("host-0", "eval"):
            assert r.retrieve(h, t) == c
    assert not r.exists("host-0", "eval")
    with pytest.raises(KeyError):
        r.retrieve("host-0", "eval")
    with pytest.raises(ValueError):
        r.register("../escape", "t", {})


def test_registry_wait_and_watch(tmp_path):
    reg = ConfigRegistry(str(tmp_path / "reg"))

    def later():
        time.sleep(0.1)
        reg.register("h", "t", {"ready": True})

    t = threading.Thread(target=later)
    t.start()
    assert reg.wait_for("h", "t", timeout_s=5.0) == {"ready": True}
    t.join()
    with pytest.raises(TimeoutError):
        reg.wait_for("h", "never", timeout_s=0.2)
    seen = []
    t = threading.Thread(target=lambda: (time.sleep(0.15), reg.register(
        "h", "t", {"v": 2})))
    t.start()
    reg.watch("h", "t", seen.append, timeout_s=5.0)
    t.join()
    assert seen == [{"v": 2}]


# ---------------------------------------------------------------------------
# provisioning
# ---------------------------------------------------------------------------


@pytest.fixture
def nothing_runs(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError(f"a command was executed: {a}")

    monkeypatch.setattr(subprocess, "run", refuse)


def test_gpu_vm_commands_are_built_as_specified(nothing_runs):
    spec = GpuVmSpec(name="trainer-0", zone="us-central1-a",
                     project="my-proj", preemptible=True,
                     tags=["dl4j", "exp"], network="default")
    p = GpuProvisioner(spec)
    assert p.create_command() == [
        "gcloud", "compute", "instances", "create", "trainer-0",
        "--zone=us-central1-a", "--project=my-proj",
        "--machine-type=a3-highgpu-1g",
        "--image-family=pytorch-latest-cu124",
        "--image-project=deeplearning-platform-release",
        "--boot-disk-size=200GB", "--maintenance-policy=TERMINATE",
        "--provisioning-model=SPOT", "--network=default",
        "--tags=dl4j,exp"]
    assert p.delete_command() == [
        "gcloud", "compute", "instances", "delete", "trainer-0",
        "--zone=us-central1-a", "--project=my-proj", "--quiet"]
    assert p.run_command("echo hi") == [
        "gcloud", "compute", "ssh", "trainer-0", "--zone=us-central1-a",
        "--project=my-proj", "--command=echo hi"]
    assert p.copy_command("/tmp/x", "~/x", recurse=True) == [
        "gcloud", "compute", "scp", "--recurse", "/tmp/x", "trainer-0:~/x",
        "--zone=us-central1-a", "--project=my-proj"]
    p.create()
    p.bootstrap("/tmp/repo", extra_setup=["nvidia-smi"])
    p.delete()
    issued = p.commands_issued
    assert len(issued) == 6  # create, scp, install, setup, sanity, delete
    assert issued[1][4:6] == ["/tmp/repo", "trainer-0:~/deeplearning4j_tpu"]
    assert issued[2][-1] == "--command=pip install -e ~/deeplearning4j_tpu"
    assert "torch.cuda.device_count()" in issued[4][-1]
    assert "import deeplearning4j_tpu_torch" in issued[4][-1]
    assert p.script().count("\n") == 5
    plain = GpuProvisioner(GpuVmSpec(name="b", zone="z")).create_command()
    assert "--provisioning-model=SPOT" not in plain
    assert not any(a.startswith("--project") for a in plain)


def test_gcs_transfer_commands(nothing_runs):
    t = GcsTransfer(dry_run=True)
    t.upload("/data/mnist", "gs://bucket/mnist")
    t.download("gs://bucket/model", "/tmp/model")
    assert t.commands_issued == [
        ["gsutil", "-m", "cp", "-r", "/data/mnist", "gs://bucket/mnist"],
        ["gsutil", "-m", "cp", "-r", "gs://bucket/model", "/tmp/model"]]
    with pytest.raises(ValueError):
        t.upload("/x", "s3://nope")
    with pytest.raises(ValueError):
        t.download("s3://nope", "/x")
