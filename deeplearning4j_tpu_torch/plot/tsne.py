"""t-SNE: exact device implementation + Barnes-Hut host implementation.

Port of ``deeplearning4j_tpu/plot/tsne.py``. Reference: ``plot/Tsne.java``
(432; exact O(n²) with gains/momentum/early exaggeration) and
``plot/BarnesHutTsne.java`` (796; SpTree O(n log n)).

The exact version is the device path: one gradient step over the dense
[n, n] affinities is a handful of GEMMs and elementwise passes, in float32.
The input affinities (``compute_gaussian_p``, a float64 perplexity search
on the host) and the initial layout (``default_rng(seed)``) are the
reference's own code, so both packages start from the same arrays. The
gains update compares signs of the gradient and the velocity, which is
discontinuous where a gradient sits within rounding of zero: two correct
runs agree step by step at first and drift apart over hundreds of
iterations, so a whole run is judged by its KL divergence. The Barnes-Hut
version is a host copy on the port's ``VPTree``/``SpTree``.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.clustering.sptree import SpTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree


# ---------------------------------------------------------------------------
# shared: input-affinity computation with perplexity binary search (host)
# ---------------------------------------------------------------------------

def _hbeta(d2_row: np.ndarray, beta: float):
    """Entropy + probabilities for one row at precision beta (Tsne.hBeta)."""
    p = np.exp(-d2_row * beta)
    sum_p = max(p.sum(), 1e-12)
    h = np.log(sum_p) + beta * float(np.dot(d2_row, p)) / sum_p
    return h, p / sum_p

def _binary_search_row(d2_row: np.ndarray, log_perp: float,
                       tol: float = 1e-5, max_tries: int = 50) -> np.ndarray:
    beta, beta_min, beta_max = 1.0, -np.inf, np.inf
    h, p = _hbeta(d2_row, beta)
    for _ in range(max_tries):
        diff = h - log_perp
        if abs(diff) < tol:
            break
        if diff > 0:
            beta_min = beta
            beta = beta * 2.0 if beta_max == np.inf else (beta + beta_max) / 2
        else:
            beta_max = beta
            beta = beta / 2.0 if beta_min == -np.inf else (beta + beta_min) / 2
        h, p = _hbeta(d2_row, beta)
    return p

def compute_gaussian_p(x: np.ndarray, perplexity: float) -> np.ndarray:
    """Symmetrized input affinities P [n, n] (Tsne.computeGaussianPerplexity)."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    sum_x2 = np.sum(x * x, axis=1)
    d2 = np.maximum(sum_x2[:, None] - 2 * x @ x.T + sum_x2[None, :], 0.0)
    p = np.zeros((n, n))
    log_perp = np.log(perplexity)
    for i in range(n):
        row = np.delete(d2[i], i)
        p_row = _binary_search_row(row, log_perp)
        p[i, np.arange(n) != i] = p_row
    p = (p + p.T) / (2.0 * n)
    return np.maximum(p, 1e-12)


# ---------------------------------------------------------------------------
# exact t-SNE: one device step
# ---------------------------------------------------------------------------

def _tsne_step(y, p, p_true, gains, velocity, momentum: float,
               learning_rate: float, with_kl: bool = True):
    """One gradient step; returns (y, gains, velocity, kl), ``kl`` None
    unless ``with_kl``.

    ``p`` drives the gradient (may be early-exaggerated); the reported KL
    is always computed against the un-exaggerated ``p_true``.
    """
    sum_y2 = torch.sum(y * y, dim=1)
    # ((1 + s_i) - 2 y_i·y_j) + s_j, the reference's order, in place
    num = torch.mm(y, y.T).mul_(-2.0)
    num.add_((1.0 + sum_y2)[:, None]).add_(sum_y2[None, :]).reciprocal_()
    num.fill_diagonal_(0.0)
    q = torch.clamp_(num / torch.sum(num), min=1e-12)
    # grad_i = 4 Σ_j (p_ij - q_ij) num_ij (y_i - y_j)
    w = (p - q).mul_(num)
    grad = 4.0 * (torch.sum(w, dim=1, keepdim=True) * y - w @ y)
    same_sign = torch.sign(grad) == torch.sign(velocity)
    gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2),
                        min=0.01)
    velocity = momentum * velocity - learning_rate * gains * grad
    y = y + velocity
    y = y - torch.mean(y, dim=0, keepdim=True)
    kl = None
    if with_kl:
        kl = torch.sum(torch.log_(p_true / q).mul_(p_true))
    return y, gains, velocity, kl


class Tsne:
    """Exact t-SNE (plot/Tsne.java) — device-batched gradient steps.

    After ``fit_transform``, ``kl_history`` holds the KL divergence every
    50 iterations and at the last.
    """

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, max_iter: int = 500,
                 momentum: float = 0.5, final_momentum: float = 0.8,
                 switch_momentum_iteration: int = 250,
                 stop_lying_iteration: int = 100,
                 exaggeration: float = 12.0, seed: int = 42,
                 device: DeviceLike = None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.stop_lying_iteration = stop_lying_iteration
        self.exaggeration = exaggeration
        self.seed = seed
        self.device = resolve_device(device)
        self.kl_history: list = []

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        p_host = compute_gaussian_p(x, min(self.perplexity, (n - 1) / 3.0))
        return self._descend(p_host)

    def _start(self, p_host: np.ndarray):
        """The descent's start on the device: (y, p, exaggerated p,
        gains, velocity)."""
        n = p_host.shape[0]
        rng = np.random.default_rng(self.seed)
        y = torch.from_numpy(rng.normal(0, 1e-4, (n, self.n_components))
                             .astype(np.float32)).to(self.device)
        p = torch.from_numpy(p_host.astype(np.float32)).to(self.device)
        p_lied = torch.clamp(p * self.exaggeration, min=1e-12)
        return y, p, p_lied, torch.ones_like(y), torch.zeros_like(y)

    def _hyper(self, it: int):
        """(momentum, the exaggeration is on) at iteration ``it``."""
        momentum = (self.momentum if it < self.switch_momentum_iteration
                    else self.final_momentum)
        return momentum, it < self.stop_lying_iteration

    def _descend(self, p_host: np.ndarray) -> np.ndarray:
        """Gradient descent from the affinities ``p_host`` [n, n]."""
        y, p, p_lied, gains, velocity = self._start(p_host)
        self.kl_history = []
        for it in range(self.max_iter):
            momentum, lying = self._hyper(it)
            read = (it + 1) % 50 == 0 or it == self.max_iter - 1
            y, gains, velocity, kl = _tsne_step(
                y, p_lied if lying else p, p, gains, velocity,
                momentum, self.learning_rate, with_kl=read)
            if read:
                self.kl_history.append(float(kl))
        return y.cpu().numpy()


# ---------------------------------------------------------------------------
# Barnes-Hut t-SNE (host, SpTree)
# ---------------------------------------------------------------------------

class BarnesHutTsne:
    """Barnes-Hut t-SNE (plot/BarnesHutTsne.java) — O(n log n) on host.

    Sparse input affinities over 3*perplexity nearest neighbors; repulsive
    forces via SpTree center-of-mass summaries at accuracy ``theta``.
    """

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 theta: float = 0.5, learning_rate: float = 200.0,
                 max_iter: int = 300, momentum: float = 0.5,
                 final_momentum: float = 0.8,
                 switch_momentum_iteration: int = 250,
                 stop_lying_iteration: int = 100,
                 exaggeration: float = 12.0, seed: int = 42):
        self.n_components = n_components
        self.perplexity = perplexity
        self.theta = theta
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.stop_lying_iteration = stop_lying_iteration
        self.exaggeration = exaggeration
        self.seed = seed

    def _sparse_p(self, x: np.ndarray):
        """Row-normalized affinities over k=3*perplexity NN, symmetrized.

        Neighbors come from a VP-tree (O(n log n) total, no dense [n, n]
        distance matrix — this path exists precisely for large n), matching
        BarnesHutTsne.computeGaussianPerplexity's tree-based kNN.
        Returns (rows, cols, vals) in COO.
        """
        n = x.shape[0]
        k = min(int(3 * self.perplexity), n - 1)
        tree = VPTree(x)
        log_perp = np.log(min(self.perplexity, k))
        p = {}
        for i in range(n):
            neighbors = tree.knn(x[i], k + 1)  # includes self at d=0
            nn = [(j, d) for j, d in neighbors if j != i][:k]
            d2_row = np.array([d * d for _, d in nn])
            p_row = _binary_search_row(d2_row, log_perp)
            for (j, _), pij in zip(nn, p_row):
                p[(i, int(j))] = pij
        # symmetrize: P = (P + Pᵀ) / 2n over the union support
        sym = {}
        for (i, j), v in p.items():
            sym[(i, j)] = sym.get((i, j), 0.0) + v / (2.0 * n)
            sym[(j, i)] = sym.get((j, i), 0.0) + v / (2.0 * n)
        rows = np.array([ij[0] for ij in sym], np.int64)
        cols = np.array([ij[1] for ij in sym], np.int64)
        vals = np.maximum(np.array(list(sym.values())), 1e-12)
        return rows, cols, vals

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        rows, cols, vals = self._sparse_p(x)
        rng = np.random.default_rng(self.seed)
        y = rng.normal(0, 1e-4, (n, self.n_components))
        gains = np.ones_like(y)
        velocity = np.zeros_like(y)
        for it in range(self.max_iter):
            exag = (self.exaggeration if it < self.stop_lying_iteration
                    else 1.0)
            momentum = (self.momentum if it < self.switch_momentum_iteration
                        else self.final_momentum)
            # attractive (edge) forces over sparse P
            diff = y[rows] - y[cols]
            qu = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
            w = (exag * vals * qu)[:, None] * diff
            pos_f = np.zeros_like(y)
            np.add.at(pos_f, rows, w)
            # repulsive forces via SpTree
            tree = SpTree(y)
            neg_f = np.zeros_like(y)
            sum_q = 0.0
            for i in range(n):
                sum_q += tree.compute_non_edge_forces(
                    i, self.theta, neg_f[i])
            grad = pos_f - neg_f / max(sum_q, 1e-12)
            same_sign = np.sign(grad) == np.sign(velocity)
            gains = np.maximum(
                np.where(same_sign, gains * 0.8, gains + 0.2), 0.01)
            velocity = momentum * velocity - self.learning_rate * gains * grad
            y = y + velocity
            y = y - y.mean(axis=0, keepdims=True)
        return y
