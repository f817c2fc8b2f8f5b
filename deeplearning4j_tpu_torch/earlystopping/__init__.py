"""Early stopping (mirror of ``earlystopping/`` in the reference).

EarlyStoppingConfiguration (Builder) + trainer epoch loop
(trainer/BaseEarlyStoppingTrainer.java:77 — fit :99-142, score calc :182,
best-model save :198, termination checks :219), model savers
(saver/LocalFileModelSaver, InMemoryModelSaver), score calculators
(scorecalc/DataSetLossCalculator), and the epoch/iteration termination
conditions (termination/: MaxEpochs, ScoreImprovementEpoch, MaxTime,
MaxScore, InvalidScore).

Port of ``deeplearning4j_tpu/earlystopping/__init__.py`` (which imports no
jax). ``fuse_epochs=True`` runs each epoch as one ``fit_epochs`` chunk of
replays of a captured step over the device cache, and checks the
iteration conditions on the host against the chunk's ``[1, N]`` loss
history.
"""

from __future__ import annotations

import copy
import enum
import os
import time
from typing import Callable, List, Optional


class EarlyStoppingResult:
    class TerminationReason(str, enum.Enum):
        ERROR = "Error"
        ITERATION_TERMINATION = "IterationTerminationCondition"
        EPOCH_TERMINATION = "EpochTerminationCondition"

    def __init__(self, reason, details: str, score_vs_epoch: dict,
                 best_epoch: int, best_score: float, total_epochs: int,
                 best_model):
        self.termination_reason = reason
        self.termination_details = details
        self.score_vs_epoch = score_vs_epoch
        self.best_model_epoch = best_epoch
        self.best_model_score = best_score
        self.total_epochs = total_epochs
        self.best_model = best_model

    def get_best_model(self):
        return self.best_model

    def __repr__(self):
        return (f"EarlyStoppingResult(reason={self.termination_reason}, "
                f"details={self.termination_details!r}, "
                f"bestEpoch={self.best_model_epoch}, "
                f"bestScore={self.best_model_score}, "
                f"epochs={self.total_epochs})")


# ---------------------------------------------------------------------------
# termination conditions
# ---------------------------------------------------------------------------


class EpochTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs

    def __str__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop when no score improvement for N consecutive epochs."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best = None
        self.since = 0

    def initialize(self):
        self.best = None
        self.since = 0

    def terminate(self, epoch, score):
        if self.best is None or self.best - score > self.min_improvement:
            self.best = score
            self.since = 0
            return False
        self.since += 1
        return self.since >= self.patience

    def __str__(self):
        return f"ScoreImprovementEpochTerminationCondition({self.patience})"


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once score is at/below a target."""

    def __init__(self, best_expected_score: float):
        self.target = best_expected_score

    def terminate(self, epoch, score):
        return score <= self.target

    def __str__(self):
        return f"BestScoreEpochTerminationCondition({self.target})"


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def initialize(self):
        self._start = time.monotonic()

    def terminate(self, last_score):
        return (time.monotonic() - self._start) >= self.max_seconds

    def __str__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort if the score exceeds a bound (divergence guard)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score):
        return last_score > self.max_score

    def __str__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, last_score):
        import math

        return math.isnan(last_score) or math.isinf(last_score)

    def __str__(self):
        return "InvalidScoreIterationTerminationCondition()"


# ---------------------------------------------------------------------------
# savers + score calculators
# ---------------------------------------------------------------------------


class InMemoryModelSaver:
    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, model, score):
        self._best = model.clone() if hasattr(model, "clone") else copy.deepcopy(model)

    def save_latest_model(self, model, score):
        self._latest = model.clone() if hasattr(model, "clone") else copy.deepcopy(model)

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver:
    """bestModel.bin / latestModel.bin zips via ModelSerializer
    (saver/LocalFileModelSaver.java)."""

    def __init__(self, directory: str):
        self.directory = directory
        self._device = None  # the saved model's: restores go back there
        os.makedirs(directory, exist_ok=True)

    @property
    def best_path(self):
        return os.path.join(self.directory, "bestModel.bin")

    @property
    def latest_path(self):
        return os.path.join(self.directory, "latestModel.bin")

    def save_best_model(self, model, score):
        from deeplearning4j_tpu_torch.utils import ModelSerializer

        self._device = getattr(model, "device", None)
        ModelSerializer.write_model(model, self.best_path)

    def save_latest_model(self, model, score):
        from deeplearning4j_tpu_torch.utils import ModelSerializer

        self._device = getattr(model, "device", None)
        ModelSerializer.write_model(model, self.latest_path)

    def get_best_model(self):
        from deeplearning4j_tpu_torch.utils import ModelSerializer

        return ModelSerializer.restore(self.best_path, device=self._device)

    def get_latest_model(self):
        from deeplearning4j_tpu_torch.utils import ModelSerializer

        return ModelSerializer.restore(self.latest_path, device=self._device)


class DataSetLossCalculator:
    """Average loss over an iterator (scorecalc/DataSetLossCalculator)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        total, count = 0.0, 0
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        for ds in self.iterator:
            n = ds.num_examples()
            total += model.score(ds) * (n if self.average else 1.0)
            count += n if self.average else 1
        return total / max(count, 1)


# ---------------------------------------------------------------------------
# configuration + trainer
# ---------------------------------------------------------------------------


class EarlyStoppingConfiguration:
    class Builder:
        def __init__(self):
            self._epoch_conditions: List[EpochTerminationCondition] = []
            self._iter_conditions: List[IterationTerminationCondition] = []
            self._saver = InMemoryModelSaver()
            self._score_calculator = None
            self._eval_every_n_epochs = 1
            self._save_last = False

        def epoch_termination_conditions(self, *conds):
            self._epoch_conditions = list(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._iter_conditions = list(conds)
            return self

        def model_saver(self, saver):
            self._saver = saver
            return self

        def score_calculator(self, calc):
            self._score_calculator = calc
            return self

        def evaluate_every_n_epochs(self, n: int):
            self._eval_every_n_epochs = max(1, n)
            return self

        def save_last_model(self, b: bool):
            self._save_last = bool(b)
            return self

        def build(self) -> "EarlyStoppingConfiguration":
            if self._score_calculator is None:
                raise ValueError("score_calculator is required")
            conf = EarlyStoppingConfiguration()
            conf.epoch_conditions = self._epoch_conditions
            conf.iter_conditions = self._iter_conditions
            conf.saver = self._saver
            conf.score_calculator = self._score_calculator
            conf.eval_every_n_epochs = self._eval_every_n_epochs
            conf.save_last = self._save_last
            return conf


class EarlyStoppingTrainer:
    """Epoch loop with scoring/saving/termination
    (trainer/BaseEarlyStoppingTrainer.java:99-142). Works for both
    MultiLayerNetwork and ComputationGraph (the reference's
    EarlyStoppingGraphTrainer is the same loop).

    ``fuse_epochs=True`` opts into the device-resident epoch pipeline:
    the training set is cached on the device once (``perf.epoch_cache``)
    and each epoch runs as one ``net.fit_epochs`` chunk (replays of one
    captured step) while this loop keeps its per-epoch decision point
    (scoring, saving, epoch conditions).
    Iteration conditions still see every batch: they are checked host-side
    against the fused chunk's ``[1, N]`` loss history. Configurations the
    fused path cannot express (non-SGD solvers, TBPTT, pretraining, the
    score-reactive LR policy) and over-budget datasets fall back to the
    per-batch loop automatically."""

    def __init__(self, config: EarlyStoppingConfiguration, network,
                 train_iterator, fuse_epochs: bool = False):
        self.config = config
        self.network = network
        self.train_iterator = train_iterator
        self.fuse_epochs = fuse_epochs

    def _build_cache(self):
        """Device dataset cache for the fused path, or None (per-batch loop).
        Built once per fit() — NOT once per epoch: re-draining and
        re-transferring the same data every epoch is exactly the cost the
        pipeline removes. The network's config predicate gates the build:
        a configuration the fused program cannot express must not pay the
        drain + device transfer for a cache it would never use. The build
        is delegated to the model handle, which places the cache on its
        device."""
        if not (self.fuse_epochs and hasattr(self.network, "fit_epochs")):
            return None
        supported = getattr(self.network, "fused_epochs_supported", None)
        if supported is None or not supported():
            return None
        return self.network.build_epoch_cache(self.train_iterator)

    def fit(self) -> EarlyStoppingResult:
        conf = self.config
        net = self.network
        for c in conf.epoch_conditions:
            c.initialize()
        for c in conf.iter_conditions:
            c.initialize()
        cache = self._build_cache()
        score_vs_epoch = {}
        best_score, best_epoch = None, -1
        epoch = 0
        reason = EarlyStoppingResult.TerminationReason.EPOCH_TERMINATION
        details = "(none)"
        while True:
            if hasattr(self.train_iterator, "reset"):
                self.train_iterator.reset()
            terminated_iter = False
            if cache is not None:
                import numpy as np

                hist = net.fit_epochs(cache, 1, chunk_epochs=1)
                if hist is None:
                    batch_scores = [net.score_value]
                else:
                    flat = hist.detach().cpu().numpy().ravel()
                    # steps the numeric sentinel tripped were identity
                    # steps — the DL4J_NAN_GUARD policy already handled
                    # them in-program, so their recorded (non-finite)
                    # losses must not double-trigger InvalidScore/
                    # MaxScore iteration conditions here
                    model = getattr(net, "network", net)
                    trips = getattr(model, "_last_sentinel", None)
                    if trips is not None:
                        t = np.asarray(trips).ravel()[:flat.size]
                        flat = flat[~t]
                    batch_scores = [float(s) for s in flat]
                for score in batch_scores:
                    for c in conf.iter_conditions:
                        if c.terminate(score):
                            reason = EarlyStoppingResult.TerminationReason.ITERATION_TERMINATION
                            details = str(c)
                            terminated_iter = True
                            break
                    if terminated_iter:
                        break
            else:
                for ds in self.train_iterator:
                    net.fit(ds)
                    for c in conf.iter_conditions:
                        if c.terminate(net.score_value):
                            reason = EarlyStoppingResult.TerminationReason.ITERATION_TERMINATION
                            details = str(c)
                            terminated_iter = True
                            break
                    if terminated_iter:
                        break
            if terminated_iter:
                epoch += 1
                break
            if epoch % conf.eval_every_n_epochs == 0:
                score = conf.score_calculator.calculate_score(net)
                score_vs_epoch[epoch] = score
                if best_score is None or score < best_score:
                    best_score, best_epoch = score, epoch
                    conf.saver.save_best_model(net, score)
                if conf.save_last:
                    conf.saver.save_latest_model(net, score)
                stop = False
                for c in conf.epoch_conditions:
                    if c.terminate(epoch, score):
                        reason = EarlyStoppingResult.TerminationReason.EPOCH_TERMINATION
                        details = str(c)
                        stop = True
                        break
                if stop:
                    epoch += 1
                    break
            epoch += 1
        best_model = conf.saver.get_best_model()
        return EarlyStoppingResult(
            reason, details, score_vs_epoch, best_epoch,
            best_score if best_score is not None else float("nan"),
            epoch, best_model)


# Graph trainer is identical (the loop only uses fit/score)
EarlyStoppingGraphTrainer = EarlyStoppingTrainer
