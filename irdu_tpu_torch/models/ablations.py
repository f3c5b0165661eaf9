"""The ablation model tops (counterpart: ``irdu_tpu/models/ablations.py``).
Images are NHWC (B, H, W, 3) at the model boundary, as in the JAX package,
and channels-first inside; H and W even (the two-scale solver's box).

  MultiScaleGraphFilter  "no latent": the image tiled across G graphs, the
                         flagship's two-scale solver with the ``nonlinear3``
                         feature heads in pixel space, a 1×1 combine;
  OneGraphFilter         "no latent, no mixture": one graph over the image
                         tiled to ``n_channels_hidden`` channels, the solver
                         chosen by ``solver``: "two_scale_nl" (the flagship
                         solver with the ``nonlinear3`` heads), "single" and
                         "single_split" (``GTVGLRSingleScale``, without and
                         with split heads) or "single_noGTV"
                         (``GLRSingleScale``). Only the first 3 channels feed
                         the output head (a reference quirk, JAX
                         ``ablations.py:86-87``).

Every solver takes JAX's ``window`` ("cross4", "diamond12", "ring8"): the
two-scale solver solves a window other than cross-4 on the K5 band route
(``solvers/gtv_glr.py``, as the flagship does), the single-scale GTV+GLR
solver's matvecs go to K9 on cross-4 and to K6a on the others
(``solvers/ablation_solvers.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from irdu_tpu_torch.models.layers import GroupedPointwise
from irdu_tpu_torch.solvers.ablation_solvers import GLRSingleScale, GTVGLRSingleScale
from irdu_tpu_torch.solvers.gtv_glr import MixtureGTVGLR

SOLVERS = ("two_scale_nl", "single", "single_split", "single_noGTV")


class MultiScaleGraphFilter(nn.Module):
    def __init__(self, n_channels_in: int = 3, n_channels_out: int = 3, ngraphs: int = 16,
                 window: str = "cross4"):
        super().__init__()
        self.ngraphs = ngraphs
        self.localfilter = MixtureGTVGLR(
            ngraphs, n_channels_in, alpha_init=0.5, beta_init=0.1, muy_init=(0.001, 0.0001),
            ro_init=(0.0001, 0.0001), gamma_init=(0.0001, 0.0001), feature_head="nonlinear3",
            window=window)
        self.linear_combination = GroupedPointwise(ngraphs * n_channels_in, n_channels_out)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img.permute(0, 3, 1, 2).repeat(1, self.ngraphs, 1, 1)
        return self.linear_combination(self.localfilter(x)).permute(0, 2, 3, 1)


class OneGraphFilter(nn.Module):
    def __init__(self, n_channels_in: int = 3, n_channels_hidden: int = 96,
                 n_channels_out: int = 3, solver: str = "single", window: str = "cross4"):
        super().__init__()
        if solver not in SOLVERS:
            raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
        self.n_channels_in = n_channels_in
        self.reps = n_channels_hidden // n_channels_in
        common = dict(alpha_init=0.5, beta_init=0.1)
        if solver == "two_scale_nl":
            self.localfilter = MixtureGTVGLR(
                1, n_channels_hidden, muy_init=(0.001, 0.0001), ro_init=(1e-6, 1e-6),
                gamma_init=(1e-6, 1e-6), feature_head="nonlinear3", window=window, **common)
        elif solver == "single_noGTV":
            self.localfilter = GLRSingleScale(1, n_channels_hidden, muy_init=0.001,
                                              window=window, **common)
        else:
            self.localfilter = GTVGLRSingleScale(
                1, n_channels_hidden, muy_init=0.001, ro_init=1e-6, gamma_init=1e-6,
                window=window, split_heads=solver == "single_split", **common)
        self.linear_combination = GroupedPointwise(n_channels_in, n_channels_out)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.localfilter(img.permute(0, 3, 1, 2).repeat(1, self.reps, 1, 1))
        # a reference quirk: only the first 3 channels feed the output head
        return self.linear_combination(x[:, :self.n_channels_in]).permute(0, 2, 3, 1)
