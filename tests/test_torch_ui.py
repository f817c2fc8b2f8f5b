"""The port's training UI against the reference's:
``deeplearning4j_tpu_torch.ui`` beside ``deeplearning4j_tpu.ui``.

1. **Same payloads.** On weights carried from a JAX LeNet-5
   (``models/convert.load_network_from_jax``) the histogram listener's
   snapshot (param stats and histograms, the applied-update panel, a
   fused chunk's loss curve and metrics pack) and the flow listener's
   flowchart are the reference's as JSON, float stats within 1e-6 of
   each other's magnitude; the conv listener's activation tile differs
   by at most one grey level a pixel (float32 activations of two
   libraries), and ``encode_png_gray`` gives the reference's bytes.
2. **One wire format.** A listener of either package posts over HTTP to
   the server of the other, and each GET returns what was posted.
3. **The server's endpoints** behave as the reference's tests ask, on
   both servers.
"""

import base64
import json
import struct
import urllib.error
import urllib.request
import zlib

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu_torch import ui as tui
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.convert import load_network_from_jax

PACKAGES = {"jax": jui, "torch": tui}
FLOAT_TOL = 1e-6


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return json.loads(r.read())


def _get_raw(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read(), r.headers.get("Content-Type")


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def servers():
    s = {name: pkg.UiServer(port=0) for name, pkg in PACKAGES.items()}
    yield s
    for srv in s.values():
        srv.stop()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    """A JAX LeNet-5 and the port's, carrying its weights."""
    ref = jax_zoo.lenet5().init()
    port = load_network_from_jax(zoo.lenet5(device="cpu"), _np(ref.params),
                                 _np(ref.updater_state), _np(ref.net_state),
                                 ref.iteration_count)
    return {"jax": ref, "torch": port}


def _nudge(nets, seed):
    """Move both networks to the same new weights (W + noise)."""
    rng = np.random.default_rng(seed)
    ref = nets["jax"]
    noisy = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.01 * rng.standard_normal(
            np.shape(a))).astype(np.asarray(a).dtype), ref.params)
    ref.params = jax.tree_util.tree_map(jax.numpy.asarray, noisy)
    load_network_from_jax(nets["torch"], _np(noisy))


def assert_json_close(got, want, path="$"):
    """Equal JSON trees; floats within FLOAT_TOL of the larger one."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), path
        assert abs(got - want) <= FLOAT_TOL * max(1.0, abs(want)), (
            path, got, want)
    else:
        assert got == want, (path, got, want)


def _through_json(payload):
    return json.loads(json.dumps(payload))


def test_histogram_payload_matches_the_reference(nets):
    lst = {n: p.HistogramIterationListener(server=object())
           for n, p in PACKAGES.items()}
    for net in nets.values():
        net.score_value = 0.75
    first = {n: _through_json(lst[n]._payload(nets[n], 3)) for n in nets}
    assert_json_close(first["torch"], first["jax"])
    assert "gradients" not in first["torch"]
    _nudge(nets, 1)
    second = {n: _through_json(lst[n]._payload(nets[n], 4)) for n in nets}
    assert "gradients" in second["torch"]  # the applied update Δθ
    assert_json_close(second["torch"], second["jax"])


def test_chunk_done_payload_matches_the_reference(nets):
    """A fused chunk's post: the loss curve (downsampled past 512 points)
    and the metrics pack, from a device history on the port's side."""
    rng = np.random.default_rng(2)
    losses = rng.random((3, 300)).astype(np.float32)
    mets = rng.random((3, 300, 4)).astype(np.float32)
    posted = {}
    for name, pkg in PACKAGES.items():
        got = []

        class Sink:
            def post_update(self, kind, payload, sid="default"):
                got.append((kind, payload))

        lst = pkg.HistogramIterationListener(server=Sink(), frequency=50)
        net = nets[name]
        net.score_value = 0.5
        net.iteration_count = 900
        if name == "torch":
            lst.chunk_done(net, 0, torch.from_numpy(losses),
                           torch.from_numpy(mets))
        else:
            lst.chunk_done(net, 0, jax.numpy.asarray(losses),
                           jax.numpy.asarray(mets))
        posted[name] = _through_json(got)
    assert len(posted["torch"]) == 1
    assert len(posted["torch"][0][1]["loss_history"]["losses"]) == 512
    assert_json_close(posted["torch"], posted["jax"])


def test_flow_payload_matches_the_reference(nets):
    got = {n: _through_json(p.FlowIterationListener.describe(nets[n]))
           for n, p in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert [n["type"] for n in got["torch"]["nodes"]][1] == "ConvolutionLayer"


def _png_pixels(png: bytes) -> np.ndarray:
    w, h = struct.unpack(">II", png[16:24])
    n = struct.unpack(">I", png[33:37])[0]
    raw = zlib.decompress(png[41:41 + n])
    rows = np.frombuffer(raw, np.uint8).reshape(h, w + 1)
    return rows[:, 1:]


def test_conv_tile_matches_the_reference(nets):
    rng = np.random.default_rng(3)
    x = rng.random((4, 28, 28, 1)).astype(np.float32)
    tiles = {}
    for name, pkg in PACKAGES.items():
        got = []

        class Sink:
            def post_update(self, kind, payload, sid="default"):
                got.append(payload)

        lst = pkg.ConvolutionalIterationListener(server=Sink(), frequency=1,
                                                 max_rows=2)
        nets[name]._last_input = x
        lst.iteration_done(nets[name], 1)
        (payload,) = got
        tiles[name] = payload
    assert tiles["torch"]["shape"] == tiles["jax"]["shape"]
    assert tiles["torch"]["layer"] == tiles["jax"]["layer"] == 0
    img = {n: _png_pixels(base64.b64decode(t["image"].split(",", 1)[1]))
           for n, t in tiles.items()}
    assert img["torch"].shape == img["jax"].shape
    diff = np.abs(img["torch"].astype(int) - img["jax"].astype(int))
    assert diff.max() <= 1


def test_png_encoder_bytes_match_the_reference():
    rng = np.random.default_rng(4)
    for shape in ((1, 1), (8, 8), (29, 57)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        assert tui.encode_png_gray(img) == jui.encode_png_gray(img)


@pytest.mark.parametrize("src,dst", [("torch", "jax"), ("jax", "torch")])
def test_each_server_accepts_the_other_listeners_posts(servers, nets, src,
                                                       dst):
    url = servers[dst].url
    sid = f"from-{src}"
    pkg = PACKAGES[src]
    net = nets[src]
    net.score_value = 0.25
    pkg.HistogramIterationListener(url=url, session_id=sid).iteration_done(
        net, 7)
    pkg.FlowIterationListener(url=url, session_id=sid,
                              frequency=1).iteration_done(net, 7)
    weights = _get(f"{url}/weights/data?sid={sid}")
    assert weights["iteration"] == 7 and weights["score"] == 0.25
    want = _through_json(PACKAGES[src].HistogramIterationListener(
        server=object())._payload(net, 7))
    assert_json_close(weights, want)
    flow = _get(f"{url}/flow/data?sid={sid}")
    assert flow["iteration"] == 7
    assert flow["nodes"] == _through_json(
        pkg.FlowIterationListener.describe(net))["nodes"]
    hist = _get(f"{url}/weights/history?sid={sid}&last=5")
    assert hist and hist[-1]["score"] == 0.25
    assert sid in _get(f"{url}/sessions")


def test_listener_on_port_fit_posts_each_iteration(servers):
    """The three listeners attached to a port network's ``fit``."""
    srv = servers["torch"]
    net = zoo.lenet5(device="cpu")
    net.set_listeners(
        tui.HistogramIterationListener(server=srv, session_id="fit"),
        tui.FlowIterationListener(server=srv, session_id="fit", frequency=1),
        tui.ConvolutionalIterationListener(server=srv, session_id="fit",
                                           frequency=1, max_rows=2))
    rng = np.random.default_rng(5)
    from deeplearning4j_tpu_torch.datasets import DataSet

    x = rng.random((8, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    net.fit(DataSet(x, y))
    net.fit(DataSet(x, y))
    w = _get(f"{srv.url}/weights/data?sid=fit")
    assert w["iteration"] == 2 and "gradients" in w
    assert _get(f"{srv.url}/flow/data?sid=fit")["iteration"] == 2
    act = _get(f"{srv.url}/activations/data?sid=fit")
    assert act["shape"][0] == 2
    body, ctype = _get_raw(f"{srv.url}/renders/img")
    assert ctype == "image/png" and body.startswith(b"\x89PNG\r\n\x1a\n")


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_server_endpoints(servers, name):
    """The endpoints of the reference's tests, on both servers."""
    url = servers[name].url
    rng = np.random.default_rng(6)
    _post(f"{url}/tsne/upload?sid=t",
          {"coords": [[0.0, 1.0], [1.0, 0.0]], "labels": ["a", "b"]})
    assert _get(f"{url}/tsne/coords?sid=t")["labels"] == ["a", "b"]
    _post(f"{url}/api/update?sid=t", {"hello": "world"})
    assert _get(f"{url}/api/data?sid=t") == {"hello": "world"}
    vecs = np.eye(4, dtype=np.float32) + 0.01 * rng.normal(size=(4, 4))
    out = _post(f"{url}/nearestneighbors/upload",
                {"labels": ["alpha", "beta", "gamma", "delta"],
                 "vectors": vecs.tolist()})
    assert out["count"] == 4
    hits = _get(f"{url}/nearestneighbors?word=alpha&k=2")
    assert len(hits) == 2 and hits[0]["word"] != "alpha"
    assert hits[0]["distance"] <= hits[1]["distance"]
    payload = {"filename": "weights.bin",
               "content_b64": base64.b64encode(b"\x00\x01abc").decode()}
    assert _post(f"{url}/uploads/upload", payload)["bytes"] == 5
    assert _get_raw(f"{url}/uploads/weights.bin")[0] == b"\x00\x01abc"
    for bad in ("/etc/passwd", "../../../etc/passwd"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{url}/renders/update", {"path": bad})
        assert ei.value.code == 403
    with urllib.request.urlopen(url + "/", timeout=5) as r:
        assert "training UI" in r.read().decode()
    with pytest.raises(urllib.error.HTTPError):
        _get(url + "/nope")
