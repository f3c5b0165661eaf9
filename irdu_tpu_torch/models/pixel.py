"""The pixel-domain model top (counterpart: ``irdu_tpu/models/pixel.py``
``MultiScaleSequenceDenoiser``): a learnable 0.1/0.9 global skip around one
``MixtureGTV`` block. Images are NHWC (B, H, W, 3) at the model boundary, as
in the JAX package, and channels-first inside; H and W multiples of 4 (the
feature U-Net).
"""

from __future__ import annotations

import torch
from torch import nn

from irdu_tpu_torch.solvers.pixel_gtv import MixtureGTV


class MultiScaleSequenceDenoiser(nn.Module):
    def __init__(self, n_graphs: int = 24, n_node_fts: int = 3, n_cnn_fts: int = 72,
                 feature_num_blocks=(2, 3, 3), feature_num_refinement: int = 4,
                 use_pallas_solver: bool = False, use_nhwc_solver: bool = False):
        super().__init__()
        self.skip_connect_weight03 = nn.Parameter(torch.tensor([0.1, 0.9]))
        self.mixtureGLR_block03 = MixtureGTV(
            n_graphs=n_graphs, n_node_fts=n_node_fts, n_cnn_fts=n_cnn_fts,
            feature_num_blocks=feature_num_blocks,
            feature_num_refinement=feature_num_refinement,
            use_pallas_unroll=use_pallas_solver, use_nhwc_unroll=use_nhwc_solver)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img.permute(0, 3, 1, 2)
        sw = self.skip_connect_weight03
        y = sw[0] * x + sw[1] * self.mixtureGLR_block03(x)
        return y.permute(0, 2, 3, 1)
