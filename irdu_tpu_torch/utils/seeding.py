"""Deterministic seeding (counterpart: ``irdu_tpu/utils/seeding.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """Seed Python's and numpy's global RNGs and torch's default generators
    (so a model's initial parameters follow the seed), and return a fresh
    ``torch.Generator`` on ``device`` seeded with ``seed`` for the draws of
    training (JAX returns ``PRNGKey(seed)`` for the same role)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
