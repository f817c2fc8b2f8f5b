"""Visualization/dimensionality-reduction: t-SNE (exact on the device,
Barnes-Hut on the host) and weight-filter rendering.

Port of ``deeplearning4j_tpu/plot``. Reference: deeplearning4j-core
``plot/`` (SURVEY §2.3) — ``BarnesHutTsne.java`` (796), ``Tsne.java``
(432 exact version), ``PlotFilters.java`` (141).
"""

from .tsne import Tsne, BarnesHutTsne
from .filters import filters_grid, render_layer, render_to_png

__all__ = ["Tsne", "BarnesHutTsne", "filters_grid", "render_layer",
           "render_to_png"]
