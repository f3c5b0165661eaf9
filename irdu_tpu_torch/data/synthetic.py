"""The synthetic image corpus (a copy of ``irdu_tpu/data/synthetic.py``'s
``make_synthetic_image``, numpy only) and the synthetic val set the
committed snapshots are evaluated on.

``synthetic_val_set`` draws the 6 val images in memory in the order
``scripts/run_convergence_tpu.py``'s ``build_corpus`` draws them: one
``RandomState(42)``, 24 train images of 420-519 × 420-519 pixels drawn and
dropped, then 6 images at 384×512. ``build_corpus`` writes them as PNGs, a
lossless round trip, so these arrays are what the JAX package's eval reads
back; no PNG is read or written here.
"""

from __future__ import annotations

import numpy as np

VAL_SEED = 42
N_TRAIN, TRAIN_SIDES = 24, (420, 520)
N_VAL, VAL_SHAPE = 6, (384, 512)


def make_synthetic_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Piecewise-smooth uint8 RGB: a random gradient background, random
    near-constant rectangles and one sinusoid texture."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        gx, gy = rng.uniform(-1, 1, 2)
        img[..., c] = 0.5 + 0.3 * (gx * xx / w + gy * yy / h)
    for _ in range(rng.randint(4, 9)):
        r0, c0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        rh, cw = rng.randint(h // 8, h // 2), rng.randint(w // 8, w // 2)
        color = rng.uniform(0.1, 0.9, 3).astype(np.float32)
        img[r0:r0 + rh, c0:c0 + cw] = 0.8 * color + 0.2 * img[r0:r0 + rh, c0:c0 + cw]
    fx, fy = rng.uniform(0.02, 0.1, 2)
    img[..., rng.randint(3)] += 0.08 * np.sin(2 * np.pi * (fx * xx + fy * yy))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def synthetic_val_set() -> list[np.ndarray]:
    """The 6 val images, uint8 (384, 512, 3), in index order."""
    rng = np.random.RandomState(VAL_SEED)
    for _ in range(N_TRAIN):  # the train images come first in the stream
        h, w = int(rng.randint(*TRAIN_SIDES)), int(rng.randint(*TRAIN_SIDES))
        make_synthetic_image(rng, h, w)
    return [make_synthetic_image(rng, *VAL_SHAPE) for _ in range(N_VAL)]
