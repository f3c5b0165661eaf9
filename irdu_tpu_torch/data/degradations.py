"""Additive Gaussian noise for training and eval (a copy of
``irdu_tpu/data/degradations.py``, numpy only, with its RNG call sequences,
so that a shared seed gives the same noise):

  * "addictive_noise":        n ~ N(0, σ/255) drawn directly
  * "addictive_noise_scale":  n ~ N(0, 1) · (σ/255)   (flagship trainers)
  * "vary_addictive_noise":   σ ~ choice(levels, p), then N(0, σ/255)

The misspelled mode names are the configurations' own; "additive_*" aliases
are accepted.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_ALIASES = {
    "additive_noise": "addictive_noise",
    "additive_noise_scale": "addictive_noise_scale",
    "vary_additive_noise": "vary_addictive_noise",
}


def add_noise(patch: np.ndarray, mode: str, lambda_noise,
              random_state: np.random.RandomState) -> np.ndarray:
    """The degraded copy of ``patch`` (float32 HWC in [0, 1])."""
    mode = _ALIASES.get(mode, mode)
    shape = patch.shape
    if mode == "addictive_noise":
        noise = random_state.normal(loc=0.0, scale=float(lambda_noise) / 255.0, size=shape)
    elif mode == "addictive_noise_scale":
        noise = random_state.normal(loc=0.0, scale=1.0, size=shape)
        noise = noise * (float(lambda_noise) / 255.0)
    elif mode == "vary_addictive_noise":
        levels, probs = lambda_noise
        sigma = random_state.choice(levels, p=probs)
        noise = random_state.normal(loc=0.0, scale=float(sigma) / 255.0, size=shape)
    elif mode in ("", "none", None):
        return patch.copy()
    else:
        raise ValueError(f"unknown dist_mode: {mode}")
    return patch + noise.astype(np.float32)


def eval_noise(shape: Sequence[int], sigma: float, seed: int = 2204,
               random_state: np.random.RandomState | None = None) -> np.ndarray:
    """The eval protocol's noise: ``RandomState(2204).normal(0, σ/255)``,
    drawn per image in dataset order from one stream (pass it as
    ``random_state``)."""
    rs = random_state if random_state is not None else np.random.RandomState(seed=seed)
    return rs.normal(0, sigma / 255.0, tuple(shape))
