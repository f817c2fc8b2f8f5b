"""Clustering suite: k-means + spatial trees.

Port of ``deeplearning4j_tpu/clustering``. Reference: deeplearning4j-core
clustering/ (SURVEY §2.3) — ``clustering/kmeans/KMeansClustering``,
``algorithm/BaseClusteringAlgorithm`` (iteration strategy + convergence),
spatial trees ``kdtree/KDTree``, ``vptree/VPTree`` (NN search for the UI),
``quadtree/QuadTree``, ``sptree/SpTree`` (Barnes-Hut).

k-means' distance/assignment/update runs as one device step per iteration
([n, k] distances through a GEMM, a fixed-order GEMM for the centroid
sums); the trees are host-side numpy index structures serving Barnes-Hut
t-SNE and nearest-neighbor queries.
"""

from .kmeans import KMeansClustering, Cluster, ClusterSet
from .kdtree import KDTree
from .vptree import VPTree
from .quadtree import QuadTree
from .sptree import SpTree

__all__ = [
    "KMeansClustering", "Cluster", "ClusterSet",
    "KDTree", "VPTree", "QuadTree", "SpTree",
]
