"""Learnable parameters of one GLR/GTV graph operator
(counterpart: ``irdu_tpu/solvers/common.py``)."""

from __future__ import annotations

import torch
from torch import nn

from irdu_tpu_torch.ops.graph import at_least_f32

_STATS_INIT = (("p01", 1.0), ("p02a", 0.5), ("p02b", 0.5), ("p03", 0.5))
STATS_MODES = ("per_channel", "scalar", "none")


class GraphOpParams(nn.Module):
    """The metric diagonal ``multiM`` (G, F) and the stencil coefficients
    ``stats_p01``, ``stats_p02a``, ``stats_p02b``, ``stats_p03``: each (G, F)
    with ``stats_mode="per_channel"`` (the flagship), each (1,) with
    ``"scalar"`` (the pixel family), none with ``"none"`` (the single-scale
    ablations: the stencil is the identity)."""

    def __init__(self, n_graphs: int, n_node_fts: int, stats_mode: str = "per_channel"):
        super().__init__()
        if stats_mode not in STATS_MODES:
            raise ValueError(f"stats_mode must be one of {STATS_MODES}, got {stats_mode!r}")
        self.shape = (n_graphs, n_node_fts)
        self.stats_mode = stats_mode
        self.multiM = nn.Parameter(torch.ones(self.shape))
        if stats_mode != "none":
            shape = self.shape if stats_mode == "per_channel" else (1,)
            for k, v in _STATS_INIT:
                setattr(self, f"stats_{k}", nn.Parameter(torch.full(shape, v)))

    def stats_table(self) -> torch.Tensor | None:
        """(G, 4, F) f32 (f64 for f64 parameters) table [p01, p02a, p02b, p03],
        the kernels' layout; a
        scalar coefficient is broadcast over (G, F); None without a stencil."""
        if self.stats_mode == "none":
            return None
        return torch.stack([at_least_f32(getattr(self, f"stats_{k}")).expand(self.multiM.shape)
                            for k, _ in _STATS_INIT], dim=1).contiguous()

    def stats_scalars(self) -> torch.Tensor:
        """The four scalar coefficients as a (4,) f32 tensor (scalar mode);
        without a stencil the identity's, [1, 0, 0, 0]."""
        if self.stats_mode == "none":
            return torch.tensor([1.0, 0.0, 0.0, 0.0], device=self.multiM.device)
        return torch.cat([getattr(self, f"stats_{k}").float().reshape(1)
                          for k, _ in _STATS_INIT])
