"""The pixel-domain model top (counterpart: ``irdu_tpu/models/pixel.py``
``MultiScaleSequenceDenoiser``): a learnable 0.1/0.9 global skip around one
``MixtureGTV`` block. Images are NHWC (B, H, W, 3) at the model boundary, as
in the JAX package, and channels-first inside; H and W multiples of 4 (the
feature U-Net; 8 with ``feature_n_levels=4``).
"""

from __future__ import annotations

import torch
from torch import nn

from irdu_tpu_torch.models.registry import require
from irdu_tpu_torch.ops.windows import WINDOWS
from irdu_tpu_torch.solvers.pixel_gtv import N_CGD_ITERS, MixtureGTV


class MultiScaleSequenceDenoiser(nn.Module):
    def __init__(self, n_graphs: int = 24, n_node_fts: int = 3, n_cnn_fts: int = 72,
                 feature_num_blocks=(2, 3, 3, 4), feature_num_refinement: int = 4,
                 use_pallas_solver: bool = False, use_nhwc_solver: bool = False, *,
                 window: str = "diamond12", stats_mode: str = "scalar",
                 n_cgd_iters: int = 4, muy_init=(0.1, 0.0, 0.0, 0.0),
                 ro_init=(0.1, 0.0, 0.0, 0.0), gamma_init=(0.001, 0.0, 0.0, 0.0),
                 feature_n_levels: int = 3, remat: bool = False,
                 eval_skip_solve: bool = False):
        """The keywords after ``use_nhwc_solver`` are JAX's fields with JAX's
        defaults, so that a configuration's ``model`` section builds. The
        ``*_init``s set the solver's initial μ, ρ and γ as JAX's do (their
        first entries); ``remat`` (the solver's and its feature U-Net's
        attribute; ``registry.set_remat`` flips it) recomputes each FFBlock
        and the plain route's unroll in the backward pass, a training-memory
        knob with no effect at inference. ``stats_mode`` ("scalar", or
        "none": the v4 core, no stencil) and ``feature_n_levels`` (3, or 4:
        the v4 full-depth feature U-Net), ``window`` ("diamond12", "cross4"
        or "ring8") and ``eval_skip_solve`` (JAX's accounting probe: the
        forward without the unroll, no solver launch) go to the solver.
        ``registry.require`` raises on a CG count other than 4, which JAX
        refuses too, and on a window JAX does not have."""
        require("window", window, list(WINDOWS), "JAX's WINDOWS has no such window")
        require("n_cgd_iters", n_cgd_iters, [N_CGD_ITERS],
                "the reference unroll is fixed at 4 CG iterations (2 ADMM rounds)")
        super().__init__()
        self.skip_connect_weight03 = nn.Parameter(torch.tensor([0.1, 0.9]))
        self.mixtureGLR_block03 = MixtureGTV(
            n_graphs=n_graphs, n_node_fts=n_node_fts, n_cnn_fts=n_cnn_fts,
            feature_num_blocks=feature_num_blocks,
            feature_num_refinement=feature_num_refinement,
            use_pallas_unroll=use_pallas_solver, use_nhwc_unroll=use_nhwc_solver,
            muy_init=muy_init[0], ro_init=ro_init[0], gamma_init=gamma_init[0],
            stats_mode=stats_mode, feature_n_levels=feature_n_levels, remat=remat,
            window=window, eval_skip_solve=eval_skip_solve)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img.permute(0, 3, 1, 2)
        sw = self.skip_connect_weight03
        y = sw[0] * x + sw[1] * self.mixtureGLR_block03(x)
        return y.permute(0, 2, 3, 1)
