"""Graph embeddings: graph structure, random walks, DeepWalk.

Reference: deeplearning4j-graph (SURVEY §2.6) — ``graph/Graph.java`` (221;
adjacency-list IGraph), ``data/GraphLoader`` (170), ``iterator/
RandomWalkIterator`` (133) / ``WeightedRandomWalkIterator`` (156),
``models/deepwalk/DeepWalk.java`` (253; skip-gram-with-HS over random
walks, ``GraphHuffman`` 130), ``GraphVectorsImpl`` (107),
``loader/GraphVectorSerializer`` (82).

Port of ``deeplearning4j_tpu/graph``: DeepWalk's steps run on the card.
"""

from .graph import Graph, GraphLoader
from .walks import NoEdgeHandling, RandomWalkIterator, WeightedRandomWalkIterator
from .deepwalk import DeepWalk, GraphHuffman
from .serializer import GraphVectorSerializer

__all__ = [
    "Graph", "GraphLoader", "RandomWalkIterator",
    "WeightedRandomWalkIterator", "NoEdgeHandling", "DeepWalk",
    "GraphHuffman", "GraphVectorSerializer",
]
