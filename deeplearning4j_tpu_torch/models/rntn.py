"""RNTN — Recursive Neural Tensor Network over parse trees.

Port of ``deeplearning4j_tpu/models/rntn.py`` (a re-design of
``deeplearning4j-nlp/.../models/rntn/RNTN.java``). The reference runs a
``lax.scan`` over each tree's padded post-order node buffer, one node a
step, vmapped over the batch. Here a batch is evaluated **by height**: a
node's children both sit at lower heights, so every node of one height,
across the whole batch, is one step — gather the children's rows, one
``[N, 2d] @ [2d, d]`` GEMM, the bilinear term as ``[N, (2d)²] @ [(2d)², d]``
on the children's outer product, the activation. A step costs O(height)
device launches, not O(nodes). It computes the reference's function; only
the summation order of the batched GEMMs differs. Padding nodes are not
evaluated: they carry no label and nothing reads them.

Math (Socher et al. 2013, as in RNTN.java):
  leaf vector      v_i   = tanh(L[word])
  composition      p     = tanh(W·[c1;c2] + b + [c1;c2]ᵀ T [c1;c2])
  node prediction  ŷ     = softmax(Ws·v + bs)
  loss             mean CE over labelled nodes + λ Σ p² (all but b, bs)

Training: AdaGrad (the reference's choice) through the port's updater, the
gradient from autograd. Repeated rows of ``L`` (the unknown word's row 0,
the frequent words) get their gradient summed in a fixed order
(``nlp.word2vec._row_sums``), and a level's children are distinct rows, so
two runs on one device give the same bits. The parameters initialise from
a seeded CPU ``torch.Generator`` with the reference's distributions; the
reference draws from ``jax.random``, which torch cannot replay, so
``models.convert.load_rntn_from_jax`` carries a JAX model's state over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nlp.trees import Tree, build_word_index
from deeplearning4j_tpu_torch.nlp.word2vec import _row_sums
from deeplearning4j_tpu_torch.nn.conf.enums import Updater
from deeplearning4j_tpu_torch.nn.updater import (
    UpdaterSpec,
    apply_updater,
    init_updater_state,
)


class _RowGather(torch.autograd.Function):
    """``table[idx]`` whose backward sums repeated rows in a fixed order
    (autograd's own adds them with atomics on CUDA, and on a large CPU
    batch in no fixed order either)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return _row_sums(ctx.n_rows, idx, grad.contiguous()), None


@dataclass
class _Plan:
    """A batch of trees laid out by height.

    Rows of the node buffer are sorted by (height, tree, post-order
    index). ``index`` is one int64 device array holding, one after the
    other, the leaves' words, each level's interleaved (left, right)
    child rows, and every row's label (-1: none); ``levels`` gives each
    level's (first row, row count, offset of its child pairs in
    ``index``); ``rows[t]`` maps tree ``t``'s post-order nodes to rows."""

    index: torch.Tensor
    n_leaves: int
    levels: List[Tuple[int, int, int]]
    label_offset: int
    n_rows: int
    n_labelled: int
    rows: List[np.ndarray]

    @property
    def words(self) -> torch.Tensor:
        return self.index[:self.n_leaves]

    @property
    def labels(self) -> torch.Tensor:
        return self.index[self.label_offset:self.label_offset + self.n_rows]

    def children(self, level: int) -> torch.Tensor:
        _, n, off = self.levels[level]
        return self.index[off:off + 2 * n]


def _heights(prog: Dict[str, np.ndarray]) -> np.ndarray:
    """Each node's height (leaves 0) in a post-order program."""
    n = int(prog["n_nodes"])
    left, right, leaf = prog["left"], prog["right"], prog["is_leaf"]
    h = np.zeros(n, np.int64)
    for i in range(n):
        if not leaf[i]:
            h[i] = 1 + max(h[left[i]], h[right[i]])
    return h


def make_plan(progs: Sequence[Dict[str, np.ndarray]],
              device: torch.device) -> _Plan:
    """Lay the linearized trees ``progs`` out by height (see :class:`_Plan`)
    and copy the index arrays to ``device`` in one transfer."""
    sizes = [int(p["n_nodes"]) for p in progs]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    heights = np.concatenate([_heights(p) for p in progs])
    order = np.argsort(heights, kind="stable")   # ties keep tree order
    row_of = np.empty_like(order)
    row_of[order] = np.arange(order.size)
    cat = {k: np.concatenate([p[k][:s] for p, s in zip(progs, sizes)])
           for k in ("left", "right", "word", "label")}
    glob = starts[np.repeat(np.arange(len(progs)), sizes)]  # tree offsets
    bounds = np.searchsorted(heights[order], np.arange(heights.max() + 2))
    parts = [cat["word"][order[:bounds[1]]]]
    levels, offset = [], int(bounds[1])
    for h in range(1, len(bounds) - 1):
        nodes = order[bounds[h]:bounds[h + 1]]
        pairs = np.stack([row_of[glob[nodes] + cat["left"][nodes]],
                          row_of[glob[nodes] + cat["right"][nodes]]], 1)
        parts.append(pairs.reshape(-1))
        levels.append((int(bounds[h]), nodes.size, offset))
        offset += 2 * nodes.size
    labels = cat["label"][order]
    parts.append(labels)
    index = torch.from_numpy(
        np.concatenate(parts).astype(np.int64)).to(device)
    return _Plan(index=index, n_leaves=int(bounds[1]), levels=levels,
                 label_offset=offset, n_rows=order.size,
                 n_labelled=int(np.sum(labels >= 0)),
                 rows=[row_of[starts[t]:starts[t + 1]]
                       for t in range(len(progs))])


class RNTN:
    """Recursive neural tensor network (RNTN.java Builder surface:
    setNumHidden, setRng, setUseTensors, setActivationFunction...).

    After ``fit``, ``loss_history`` holds every batch's loss (numpy)."""

    def __init__(self, num_hidden: int = 25, num_classes: int = 5,
                 vocab: Optional[Dict[str, int]] = None,
                 use_tensors: bool = True, learning_rate: float = 0.01,
                 l2: float = 1e-4, seed: int = 123,
                 activation: str = "tanh", device: DeviceLike = None):
        self.num_hidden = num_hidden
        self.num_classes = num_classes
        self.vocab = dict(vocab) if vocab else None
        self.use_tensors = use_tensors
        self.learning_rate = learning_rate
        self.l2 = l2
        self.seed = seed
        self.activation = activation
        self.device = resolve_device(device)
        self.params: Dict[str, torch.Tensor] = {}
        self.updater_state = None
        self.iteration_count = 0
        self.loss_history = np.zeros((0,), np.float32)
        self._spec = UpdaterSpec(kind=Updater.ADAGRAD,
                                 learning_rate=learning_rate)

    # -- init ----------------------------------------------------------
    def init(self, trees: Optional[Sequence[Tree]] = None) -> "RNTN":
        if self.vocab is None:
            if trees is None:
                raise ValueError("need trees or an explicit vocab to init")
            self.vocab = build_word_index(trees)
        d, c, v = self.num_hidden, self.num_classes, len(self.vocab)
        gen = torch.Generator().manual_seed(self.seed)
        r = 1.0 / np.sqrt(2.0 * d)

        def uniform(*shape):
            return torch.empty(shape).uniform_(-r, r, generator=gen)

        params = {
            "L": torch.randn((v, d), generator=gen) * 0.01,
            "W": uniform(2 * d, d),
            "b": torch.zeros((d,)),
            "T": (uniform(2 * d, 2 * d, d) if self.use_tensors
                  else torch.zeros((0, 0, 0))),
            "Ws": uniform(d, c),
            "bs": torch.zeros((c,)),
        }
        self.params = {k: p.to(self.device) for k, p in params.items()}
        self.updater_state = init_updater_state(self._spec, self.params)
        return self

    # -- the level evaluator --------------------------------------------
    def _act(self, x):
        return torch.tanh(x) if self.activation == "tanh" else torch.relu(x)

    def _leaf(self, params, words: torch.Tensor) -> torch.Tensor:
        """Leaf vectors of the embedding rows ``words``."""
        return self._act(_RowGather.apply(params["L"], words))

    def _compose(self, params, cc: torch.Tensor) -> torch.Tensor:
        """Parent vectors of ``cc`` [N, 2d], each row its children's
        vectors side by side."""
        pre = cc @ params["W"] + params["b"]
        if self.use_tensors:
            n, two_d = cc.shape
            outer = (cc[:, :, None] * cc[:, None, :]).reshape(n, -1)
            pre = pre + outer @ params["T"].reshape(two_d * two_d, -1)
        return self._act(pre)

    def _forward(self, params, plan: _Plan):
        """Node vectors [rows, d] and logits [rows, C] in the plan's row
        order."""
        buf = self._leaf(params, plan.words)
        for level in range(len(plan.levels)):
            kids = buf[plan.children(level)].reshape(-1, 2 * buf.shape[1])
            buf = torch.cat([buf, self._compose(params, kids)])
        return buf, buf @ params["Ws"] + params["bs"]

    def _loss(self, params, plan: _Plan) -> torch.Tensor:
        """Mean per-node CE over the batch + L2 (RNTN.java
        scaleAndRegularize)."""
        _, logits = self._forward(params, plan)
        labels = plan.labels
        mask = (labels >= 0).to(logits.dtype)
        logp = torch.log_softmax(logits, dim=-1)
        picked = torch.gather(logp, 1, torch.clamp(labels, min=0)[:, None])
        ce = -torch.sum(picked[:, 0] * mask) / max(plan.n_labelled, 1)
        reg = sum(torch.sum(p * p) for k, p in params.items()
                  if k not in ("b", "bs") and p.numel())
        return ce + self.l2 * reg

    def _step(self, plan: _Plan) -> torch.Tensor:
        """One AdaGrad step on ``plan``'s batch; returns the loss (on the
        device)."""
        names = list(self.params)
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in self.params.items()}
        loss = self._loss(leaves, plan)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(self.params[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        steps, self.updater_state = apply_updater(
            self._spec, grads, self.updater_state,
            torch.ones((), device=self.device),
            torch.tensor(self.iteration_count + 1, device=self.device))
        self.params = {k: self.params[k] - steps[k] for k in names}
        self.iteration_count += 1
        return loss.detach()

    # -- host API -------------------------------------------------------
    def _plan(self, trees: Sequence[Tree]) -> _Plan:
        return make_plan([t.linearize(self.vocab) for t in trees],
                         self.device)

    def fit(self, trees: Sequence[Tree], num_epochs: int = 1,
            batch_size: int = 32) -> float:
        """AdaGrad training over tree batches; returns final loss."""
        if not self.params:
            self.init(trees)
        losses = []
        for _ in range(num_epochs):
            for i in range(0, len(trees), batch_size):
                losses.append(self._step(self._plan(trees[i:i + batch_size])))
        if not losses:
            return float("nan")
        self.loss_history = torch.stack(losses).cpu().numpy()
        return float(self.loss_history[-1])

    @torch.no_grad()
    def score(self, trees: Sequence[Tree]) -> float:
        return float(self._loss(self.params, self._plan(trees)))

    @torch.no_grad()
    def _evaluate(self, tree: Tree):
        plan = self._plan([tree])
        buf, logits = self._forward(self.params, plan)
        rows = torch.from_numpy(plan.rows[0]).to(self.device)
        return buf[rows], logits[rows]

    def predict(self, tree: Tree) -> np.ndarray:
        """Per-node class predictions in post-order (root last)."""
        _, logits = self._evaluate(tree)
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def predict_root(self, tree: Tree) -> int:
        return int(self.predict(tree)[-1])

    def node_vectors(self, tree: Tree) -> np.ndarray:
        buf, _ = self._evaluate(tree)
        return buf.cpu().numpy()

    def get_word_vector(self, word: str) -> np.ndarray:
        idx = self.vocab.get(word, 0)
        return self.params["L"][idx].cpu().numpy()
