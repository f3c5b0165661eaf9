"""8-mode dihedral data augmentation (a copy of ``irdu_tpu/data/augment.py``):
mode 0 identity, 1 flipud, 2/4/6 rot90×{1,2,3}, 3/5/7 rot+flipud. The
sampler draws ``randint(0, 7)``, so mode 7 is never sampled: the
reference's off-by-one, kept so that the training stream is JAX's."""

from __future__ import annotations

import numpy as np


def dihedral_augment(image: np.ndarray, mode: int) -> np.ndarray:
    if mode == 0:
        out = image
    elif mode == 1:
        out = np.flipud(image)
    elif mode == 2:
        out = np.rot90(image)
    elif mode == 3:
        out = np.flipud(np.rot90(image))
    elif mode == 4:
        out = np.rot90(image, k=2)
    elif mode == 5:
        out = np.flipud(np.rot90(image, k=2))
    elif mode == 6:
        out = np.rot90(image, k=3)
    elif mode == 7:
        out = np.flipud(np.rot90(image, k=3))
    else:
        raise ValueError(f"augment mode must be 0..7, got {mode}")
    return np.ascontiguousarray(out)


def sample_augment_mode(random_state: np.random.RandomState) -> int:
    """``randint(0, 7)``: mode 7 unreachable, as in the reference."""
    return int(random_state.randint(0, 7))
