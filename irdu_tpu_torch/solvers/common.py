"""Learnable parameters of one GLR/GTV graph operator
(counterpart: ``irdu_tpu/solvers/common.py``, per-channel stats mode)."""

from __future__ import annotations

import torch
from torch import nn

_STATS_INIT = (("p01", 1.0), ("p02a", 0.5), ("p02b", 0.5), ("p03", 0.5))


class GraphOpParams(nn.Module):
    """The metric diagonal ``multiM`` (G, F) and the per-channel stencil
    coefficients ``stats_p01``, ``stats_p02a``, ``stats_p02b``, ``stats_p03``
    (each (G, F))."""

    def __init__(self, n_graphs: int, n_node_fts: int):
        super().__init__()
        shape = (n_graphs, n_node_fts)
        self.multiM = nn.Parameter(torch.ones(shape))
        for k, v in _STATS_INIT:
            setattr(self, f"stats_{k}", nn.Parameter(torch.full(shape, v)))

    def stats_table(self) -> torch.Tensor:
        """(G, 4, F) f32 table [p01, p02a, p02b, p03], the kernels' layout."""
        return torch.stack([getattr(self, f"stats_{k}").float()
                            for k, _ in _STATS_INIT], dim=1).contiguous()
