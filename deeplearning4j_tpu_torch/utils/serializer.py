"""ModelSerializer: model zips that both packages read and write.

Port of ``deeplearning4j_tpu/utils/serializer.py`` (the reference's
``util/ModelSerializer.java:31-96``): the same zip, entry for entry, so a
model written by either package restores in the other.

Entries:
- ``configuration.json``  — MultiLayerConfiguration / ComputationGraphConfiguration
  JSON, or TransformerLM's constructor kwargs
- ``coefficients.npz``    — params, flattened to "/"-joined keys
- ``updater.npz``         — updater state (optional)
- ``state.npz``           — non-trainable net state (BatchNorm statistics)
- ``metadata.json``       — model type, iteration count, format version and
  the training state

The training state's ``rng_key`` is the reference's ``jax.random`` key,
which the JAX reader requires. The port cannot continue a ``jax.random``
stream, so it writes the key that ``jax.random.PRNGKey(seed)`` makes from
the configuration's seed, and keeps its own generator's state under
``torch_rng`` (which the JAX reader ignores). Restoring a zip without a
``torch_rng`` of the network's device type (one written by the JAX
package, or on another device type) leaves the network's generator as
``init`` seeded it, from the configuration's seed.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _escape(component: str) -> str:
    """Escape '%', '/' and '[' so user-chosen layer names cannot collide
    with the path delimiter or the '[i]' list-index encoding."""
    return (component.replace("%", "%25").replace("/", "%2F")
            .replace("[", "%5B"))


def _unescape(component: str) -> str:
    return (component.replace("%5B", "[").replace("%2F", "/")
            .replace("%25", "%"))


def _to_host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            esc = _escape(str(k))
            sub_prefix = f"{prefix}/{esc}" if prefix else esc
            out.update(_flatten_tree(tree[k], sub_prefix))
    elif isinstance(tree, (list, tuple)):
        # lists (e.g. TransformerLM's per-layer blocks) flatten under
        # "[i]" components; _unflatten_tree rebuilds them by pattern
        for i, item in enumerate(tree):
            comp = f"[{i}]"
            sub_prefix = f"{prefix}/{comp}" if prefix else comp
            out.update(_flatten_tree(item, sub_prefix))
    else:
        out[prefix] = _to_host(tree)
    return out


def _listify_and_unescape(node: Any) -> Any:
    """Turn dict nodes whose (escaped) keys are all '[N]' back into lists,
    then unescape the other keys. ``_escape`` maps '[' to '%5B', so a
    user key literally named '[0]' never looks like a list index here."""
    if not isinstance(node, dict):
        return node
    if node and all(k.startswith("[") and k.endswith("]") for k in node):
        try:
            return [_listify_and_unescape(node[f"[{i}]"])
                    for i in range(len(node))]
        except KeyError:
            raise ValueError(
                f"corrupt archive: list entries {sorted(node)} are not "
                f"contiguous [0..{len(node) - 1}] indices") from None
    return {_unescape(k): _listify_and_unescape(v)
            for k, v in node.items()}


def _unflatten_tree(flat: Dict[str, np.ndarray], device=None) -> Any:
    """The nested tree of ``flat``'s keys, its leaves tensors on
    ``device`` (the CPU when None)."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        # components stay escaped until _listify_and_unescape
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        t = torch.from_numpy(np.array(value, copy=True))
        node[parts[-1]] = t if device is None else t.to(device)
    return _listify_and_unescape(root)


def _npz_bytes(tree: Any) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **_flatten_tree(tree))
    return buf.getvalue()


def _load_npz(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data)) as npz:
        return {k: npz[k] for k in npz.files}


def _read_npz(zf: zipfile.ZipFile, name: str, device=None) -> Any:
    return _unflatten_tree(_load_npz(zf.read(name)), device)


def _merge_into(template: Any, loaded: Any, path: str = "") -> Any:
    """Overlay loaded leaves onto the freshly initialized structure, each
    cast to its template leaf's dtype and device.

    Empty-dict slots (param-less layers) may be absent from the archive —
    ``np.savez`` drops them — but a missing *array* leaf means a
    truncated or incompatible checkpoint and raises, as does a list of
    another length, rather than keep fresh random values."""
    if isinstance(template, dict):
        out = {}
        for k in template:
            sub_path = f"{path}/{k}" if path else str(k)
            sub_loaded = loaded.get(k) if isinstance(loaded, dict) else None
            if sub_loaded is None and _has_array_leaves(template[k]):
                raise ValueError(
                    f"checkpoint is missing parameter entry {sub_path!r} "
                    "(truncated or incompatible archive)")
            out[k] = _merge_into(template[k], sub_loaded, sub_path)
        return out
    if isinstance(template, (list, tuple)):
        if not template and loaded is None:
            return template  # empty lists produce no npz keys either
        if not isinstance(loaded, list) or len(loaded) != len(template):
            raise ValueError(
                f"checkpoint entry {path!r} has "
                f"{0 if loaded is None else len(loaded)} items, expected "
                f"{len(template)}")
        return type(template)(
            _merge_into(t, l, f"{path}/[{i}]")
            for i, (t, l) in enumerate(zip(template, loaded)))
    if loaded is None:
        return template
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(loaded).to(device=template.device,
                                          dtype=template.dtype)
    return loaded


def _has_array_leaves(tree: Any) -> bool:
    if isinstance(tree, dict):
        return any(_has_array_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_array_leaves(v) for v in tree)
    return True


def prng_key_words(seed: int) -> List[int]:
    """The two uint32 words of ``jax.random.PRNGKey(seed)``: the seed's
    high and low 32 bits."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return [seed >> 32, seed & 0xFFFFFFFF]


def _training_state(model) -> Optional[dict]:
    """What a resume needs beyond the weights (see the module)."""
    gen = getattr(model, "_rng", None)
    if not isinstance(gen, torch.Generator):
        return None
    return {
        "rng_key": prng_key_words(model.conf.global_conf.seed),
        "lr_scale_host": float(getattr(model, "_lr_scale_host", 1.0)),
        "epoch_cursor": int(getattr(model, "_epoch_cursor", 0)),
        "step_cursor": int(getattr(model, "_step_cursor", 0)),
        "torch_rng": {"device": gen.device.type,
                      "state": gen.get_state().tolist()},
    }


def _restore_training_state(net, ts: Optional[dict]) -> None:
    if not ts:
        return
    net._lr_scale_host = float(ts.get("lr_scale_host", 1.0))
    net._epoch_cursor = int(ts.get("epoch_cursor", 0))
    net._step_cursor = int(ts.get("step_cursor", 0))
    own = ts.get("torch_rng")
    if own and own.get("device") == net._rng.device.type:
        net._rng.set_state(torch.tensor(own["state"], dtype=torch.uint8))


class ModelSerializer:
    FORMAT_VERSION = 1

    @staticmethod
    def write_model(model, path: str, save_updater: bool = True) -> None:
        from deeplearning4j_tpu_torch.models.transformer import TransformerLM
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        model._ensure_init()
        if isinstance(model, TransformerLM):
            mtype = "TransformerLM"
            conf_json = json.dumps(model.get_config())
            updater_tree = model.opt_state
            net_state = None  # stateless apart from params and Adam
            iteration = model.step_count
        elif isinstance(model, (MultiLayerNetwork, ComputationGraph)):
            mtype = type(model).__name__
            conf_json = model.conf.to_json()
            updater_tree = model.updater_state
            net_state = model.net_state
            iteration = model.iteration_count
        else:
            raise TypeError(f"cannot serialize {type(model).__name__}")
        meta = {
            "format_version": ModelSerializer.FORMAT_VERSION,
            "model_type": mtype,
            "iteration_count": int(iteration),
        }
        ts = _training_state(model)
        if ts is not None:
            meta["training_state"] = ts
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("configuration.json", conf_json)
            zf.writestr("coefficients.npz", _npz_bytes(model.params))
            if save_updater:
                zf.writestr("updater.npz", _npz_bytes(updater_tree))
            if net_state is not None:
                zf.writestr("state.npz", _npz_bytes(net_state))
            zf.writestr("metadata.json", json.dumps(meta))

    @staticmethod
    def restore_multi_layer_network(path: str, load_updater: bool = True,
                                    device=None):
        return ModelSerializer._restore(path, load_updater,
                                        "MultiLayerNetwork", device)

    @staticmethod
    def restore_computation_graph(path: str, load_updater: bool = True,
                                  device=None):
        return ModelSerializer._restore(path, load_updater,
                                        "ComputationGraph", device)

    @staticmethod
    def restore_transformer_lm(path: str, load_updater: bool = True,
                               device=None):
        return ModelSerializer._restore(path, load_updater, "TransformerLM",
                                        device)

    @staticmethod
    def restore(path: str, load_updater: bool = True, device=None):
        """Restore whichever model the zip holds, on ``device`` (the card
        when None; with no card that raises)."""
        return ModelSerializer._restore(path, load_updater, None, device)

    @staticmethod
    def _restore(path: str, load_updater: bool, expect, device):
        from deeplearning4j_tpu_torch.nn.conf.graph import (
            ComputationGraphConfiguration)
        from deeplearning4j_tpu_torch.nn.conf.neural_net import (
            MultiLayerConfiguration)
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        with zipfile.ZipFile(path, "r") as zf:
            meta = json.loads(zf.read("metadata.json"))
            mtype = meta.get("model_type")
            if mtype not in ("MultiLayerNetwork", "ComputationGraph",
                             "TransformerLM"):
                raise ValueError(
                    f"unknown model_type {mtype!r} in checkpoint metadata")
            if expect is not None and mtype != expect:
                other = {
                    "ComputationGraph": "restore_computation_graph",
                    "MultiLayerNetwork": "restore_multi_layer_network",
                    "TransformerLM": "restore_transformer_lm",
                }[mtype]
                raise TypeError(f"checkpoint holds a {mtype}, use {other}")
            conf_json = zf.read("configuration.json").decode()
            names = zf.namelist()
            if mtype == "TransformerLM":
                from deeplearning4j_tpu_torch.models.transformer import (
                    TransformerLM)

                lm = TransformerLM(**json.loads(conf_json),
                                   device=device).init()
                lm.params = _merge_into(
                    lm.params, _read_npz(zf, "coefficients.npz", lm.device))
                if load_updater and "updater.npz" in names:
                    lm.opt_state = _merge_into(
                        lm.opt_state,
                        _read_npz(zf, "updater.npz", lm.device))
                lm.step_count = meta.get("iteration_count", 0)
                return lm
            if mtype == "MultiLayerNetwork":
                net = MultiLayerNetwork(
                    MultiLayerConfiguration.from_json(conf_json),
                    device=device).init()
            else:
                net = ComputationGraph(
                    ComputationGraphConfiguration.from_json(conf_json),
                    device=device).init()
            net.params = _merge_into(
                net.params, _read_npz(zf, "coefficients.npz", net.device))
            if load_updater and "updater.npz" in names:
                net.updater_state = _merge_into(
                    net.updater_state,
                    _read_npz(zf, "updater.npz", net.device))
            if "state.npz" in names:
                net.net_state = _merge_into(
                    net.net_state, _read_npz(zf, "state.npz", net.device))
            net.iteration_count = meta.get("iteration_count", 0)
            _restore_training_state(net, meta.get("training_state"))
        return net
