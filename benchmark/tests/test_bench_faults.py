"""A run whose timed path is broken underneath comes out not correct, once
for each fault the cells can have, at the tiny size on the CPU, held to
the real limits. The control, the reference computed in float8 in the
program's place, reads above the program there, and fails the limits at
the cells' own size on the card."""

import contextlib
import time

import pytest
import torch

from benchmark import harness
from benchmark.drivers import train
from benchmark.reference import opt as ref

from bench_tiny import make_root

TRAIN_CELLS = ("opt-2.7b.train", "opt-1.3b.train")
SERVE_CELLS = ("opt-1.3b.chat",)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("tiny")))


def _run(root, cell, seed=2**31 + 21):
    c = harness.load_cell(root, cell, seed=seed, seconds=2.0, trace=False,
                          device="cpu")
    return harness.run(c, time.monotonic())


@contextlib.contextmanager
def patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


@pytest.mark.parametrize("cell", TRAIN_CELLS + SERVE_CELLS)
def test_a_sound_run_is_correct(root, cell):
    assert _run(root, cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_step_that_leaves_its_state_unchanged_is_caught(root, cell):
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    with patched(TransformerLM, "_adam_", lambda *a, **k: None):
        out = _run(root, cell)
    assert not out["correct"]
    assert out["check"]["change_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_half_the_batch_left_out_is_caught(root, cell):
    from benchmark.calibrate import half_batch_loss

    with half_batch_loss():
        out = _run(root, cell)
    assert not out["correct"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_a_token_altered_where_it_is_produced_is_caught(root, cell):
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    decode = DecodeEngine.decode

    def altered(self, *a, **k):
        return (decode(self, *a, **k) + 1) % self.model.vocab_size

    with patched(DecodeEngine, "decode", altered):
        out = _run(root, cell)
    assert not out["correct"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_a_decode_that_leaves_the_cache_unwritten_is_caught(root, cell):
    import deeplearning4j_tpu_torch.serving.engine as engine

    with patched(engine, "requant_write_slab",
                 lambda slab, scale, *a: (slab, scale)):
        out = _run(root, cell)
    assert not out["correct"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_the_control_reads_above_the_program_in_a_train_cell(root, cell):
    """At this size the limits, set at the cell's, need not hold; the
    control still reads well above the program on the same seed."""
    from benchmark.calibrate import readings

    c = harness.load_cell(root, cell, seed=2**31 + 22, seconds=1.0,
                          trace=False, device="cpu")
    prog, ctrl = readings(c, "program"), readings(c, "control")
    assert any(ctrl[k] >= 2 * prog[k] for k in prog), (prog, ctrl)


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_the_control_reads_above_the_program_in_a_serving_cell(root, cell):
    from benchmark.calibrate import readings

    c = harness.load_cell(root, cell, seed=2**31 + 23, seconds=2.0,
                          trace=False, device="cpu")
    got = readings(c, "program")
    assert got["control_logit_gap"] > 2 * got["logit_gap"], got


@pytest.mark.card
def test_the_control_fails_at_the_cells_size_on_the_card():
    """The control at the train cells' own size (``calibrate.py`` reads it
    on more seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cells' size")
    from bench_tiny import ROOT

    ref.strict_f32()
    for cell in TRAIN_CELLS:
        c = harness.load_cell(ROOT, cell, seed=2**31 + 24, seconds=1.0,
                              trace=False, device="cuda")
        got = train.compare(train.reference_readings(c, fp8=True),
                            train.reference_readings(c))
        ok, _ = harness.judge(got, c.limits)
        assert not ok, (cell, got)
