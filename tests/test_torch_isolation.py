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
        print(len(names), leaked)
    """)
    count, leaked = out.split(" ", 1)
    assert int(count) >= 15
    assert leaked.strip() == "[]"


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
