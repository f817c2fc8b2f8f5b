"""k-means clustering with device-batched iterations.

Port of ``deeplearning4j_tpu/clustering/kmeans.py``. Reference:
``clustering/kmeans/KMeansClustering.java`` +
``clustering/algorithm/BaseClusteringAlgorithm.java:188`` (iteration strategy
with convergence on cluster-assignment stability) and
``clustering/cluster/ClusterUtils.java`` helpers.

One iteration (:func:`_kmeans_step`) runs on the device: the [n, k]
distances (Euclidean as ``‖p‖² − 2p·c + ‖c‖²`` through a GEMM), the
first-index argmin, and the centroid sums as ``one_hot(assign)ᵀ @ points``,
a GEMM that adds each cluster's points in a fixed order (a scatter-add with
atomics would not), so two runs give the same bits. Empty clusters keep
their previous centroid (the reference respawns from the most-spread
cluster; keeping the centroid is the standard fixed-point-compatible choice
and is deterministic). The k-means++ init is the reference's host numpy, so
both packages start from the same centroids; the convergence test reads the
assignments back once an iteration, as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device

# rows of points a Manhattan distance block holds at once ([rows, k, d])
_MANHATTAN_ROWS = 4096


def _distances(points: torch.Tensor, centroids: torch.Tensor,
               distance: str) -> torch.Tensor:
    """[n, k] distances from every point to every centroid."""
    if distance == "cosine":
        pn = points / (torch.linalg.vector_norm(points, dim=1, keepdim=True)
                       + 1e-12)
        cn = centroids / (torch.linalg.vector_norm(centroids, dim=1,
                                                   keepdim=True) + 1e-12)
        return 1.0 - pn @ cn.T
    if distance == "manhattan":
        return torch.cat([
            torch.sum(torch.abs(block[:, None, :] - centroids[None]), dim=-1)
            for block in torch.split(points, _MANHATTAN_ROWS)])
    p2 = torch.sum(points * points, dim=1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=1)
    return p2 - 2.0 * (points @ centroids.T) + c2[None, :]


def _kmeans_step(points: torch.Tensor, centroids: torch.Tensor,
                 distance: str):
    """One assignment + update step. points [n, d], centroids [k, d] →
    (new centroids, assignments [n] int64, cost), all on the device."""
    dists = _distances(points, centroids, distance)
    best, assign = torch.min(dists, dim=1)              # first on ties
    k = centroids.shape[0]
    one_hot = (assign[:, None] == torch.arange(k, device=points.device)
               ).to(points.dtype)
    sums = one_hot.T @ points
    counts = torch.sum(one_hot, dim=0)
    new_centroids = torch.where(counts[:, None] > 0,
                                sums / torch.clamp(counts[:, None], min=1.0),
                                centroids)
    return new_centroids, assign, torch.sum(best)


@dataclass
class Cluster:
    """One cluster: centroid + member point indices (cluster/Cluster.java)."""
    center: np.ndarray
    point_indices: List[int] = field(default_factory=list)

    @property
    def count(self) -> int:
        return len(self.point_indices)


@dataclass
class ClusterSet:
    """Result container (cluster/ClusterSet.java)."""
    clusters: List[Cluster]
    assignments: np.ndarray
    cost: float

    def nearest_cluster(self, point: np.ndarray) -> int:
        centers = np.stack([c.center for c in self.clusters])
        return int(np.argmin(np.sum((centers - point[None]) ** 2, axis=1)))


class KMeansClustering:
    """k-means with k-means++ init and assignment-stability convergence.

    ``setup(k, max_iterations, distance)`` mirrors
    ``KMeansClustering.setup(clusterCount, maxIterationCount, distanceFunction)``.
    ``iterations`` holds the number of steps the last ``apply_to`` ran.
    """

    def __init__(self, k: int, max_iterations: int = 100,
                 distance: str = "euclidean", seed: int = 123,
                 tolerance: float = 1e-4, device: DeviceLike = None):
        if distance not in ("euclidean", "cosine", "manhattan"):
            raise ValueError(f"unknown distance: {distance}")
        if max_iterations < 1:
            raise ValueError("max_iterations must be >= 1")
        self.k = k
        self.max_iterations = max_iterations
        self.distance = distance
        self.seed = seed
        self.tolerance = tolerance
        self.device = resolve_device(device)
        self.iterations = 0

    @classmethod
    def setup(cls, cluster_count: int, max_iteration_count: int,
              distance_function: str = "euclidean", seed: int = 123,
              tolerance: float = 1e-4,
              device: DeviceLike = None) -> "KMeansClustering":
        return cls(cluster_count, max_iteration_count, distance_function,
                   seed, tolerance, device)

    def _init_centroids(self, points: np.ndarray) -> np.ndarray:
        """k-means++ seeding (host, O(nk)). The reference recomputes every
        chosen center's distances at each pick (O(nk²)); keeping their
        running minimum gives the same array, so the same draws."""
        rng = np.random.default_rng(self.seed)
        n = points.shape[0]
        centers = [points[rng.integers(n)]]
        d2 = None
        for _ in range(1, self.k):
            new = np.sum((points - centers[-1][None]) ** 2, axis=1)
            d2 = new if d2 is None else np.minimum(d2, new)
            total = d2.sum()
            if total <= 0:
                centers.append(points[rng.integers(n)])
                continue
            probs = d2 / total
            centers.append(points[rng.choice(n, p=probs)])
        return np.stack(centers)

    def apply_to(self, points: np.ndarray) -> ClusterSet:
        points = np.asarray(points, np.float32)
        if points.shape[0] < self.k:
            raise ValueError(
                f"need at least k={self.k} points, got {points.shape[0]}")
        centroids = torch.from_numpy(
            self._init_centroids(points)).to(self.device)
        dev_points = torch.from_numpy(points).to(self.device)
        prev_assign: Optional[np.ndarray] = None
        assign = None
        cost = prev_cost = np.inf
        self.iterations = 0
        for _ in range(self.max_iterations):
            centroids, assign_dev, cost_dev = _kmeans_step(
                dev_points, centroids, self.distance)
            self.iterations += 1
            assign = assign_dev.to(torch.int32).cpu().numpy()
            cost = float(cost_dev)
            # converged when assignments are stable (the reference's
            # criterion) or the cost improvement falls below tolerance
            if prev_assign is not None and (
                    np.array_equal(assign, prev_assign)
                    or abs(prev_cost - cost)
                    <= self.tolerance * max(abs(prev_cost), 1.0)):
                break
            prev_assign = assign
            prev_cost = cost
        centers = centroids.cpu().numpy()
        clusters = [Cluster(center=centers[i]) for i in range(self.k)]
        for idx, a in enumerate(assign):
            clusters[int(a)].point_indices.append(idx)
        return ClusterSet(clusters=clusters, assignments=assign, cost=cost)
