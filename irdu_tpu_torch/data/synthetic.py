"""The synthetic image corpus (a copy of ``irdu_tpu/data/synthetic.py``:
``make_synthetic_image``, numpy only, and ``write_synthetic_corpus``, which
needs PIL) and the synthetic train and val sets the committed snapshots were
trained and evaluated on.

``synthetic_train_set`` and ``synthetic_val_set`` draw in memory, in the
order ``scripts/run_convergence_tpu.py``'s ``build_corpus`` draws them: one
``RandomState(42)``, 24 train images of 420-519 × 420-519 pixels, then 6 val
images at 384×512. ``build_corpus`` writes them as PNGs, a lossless round
trip, so these arrays are what the JAX package's trainer and eval read
back; no PNG is read or written here.
"""

from __future__ import annotations

import os

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


def write_synthetic_corpus(root: str, n_images: int = 8,
                           size_range: tuple[int, int] = (96, 200), seed: int = 0,
                           csv_name: str = "index.csv") -> str:
    """Write ``n_images`` PNGs under ``root/images`` and their CSV index
    (``data.dataset.build_image_index``) as JAX's function does, with its
    draws; returns the CSV path. Needs PIL."""
    from PIL import Image

    from irdu_tpu_torch.data.dataset import build_image_index

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    for i in range(n_images):
        h = int(rng.randint(*size_range))
        w = int(rng.randint(*size_range))
        Image.fromarray(make_synthetic_image(rng, h, w)).save(
            os.path.join(img_dir, f"img{i:03d}.png"))
    csv_path = os.path.join(root, csv_name)
    build_image_index(root, csv_path)
    return csv_path


def _convergence_corpus(with_val: bool):
    """The train images and, with ``with_val``, the val images of one draw."""
    rng = np.random.RandomState(VAL_SEED)
    train = []
    for _ in range(N_TRAIN):
        h, w = int(rng.randint(*TRAIN_SIDES)), int(rng.randint(*TRAIN_SIDES))
        train.append(make_synthetic_image(rng, h, w))
    val = [make_synthetic_image(rng, *VAL_SHAPE) for _ in range(N_VAL)] if with_val else []
    return train, val


def synthetic_train_set() -> list[np.ndarray]:
    """The 24 train images, uint8 (H, W, 3) with H, W in 420-519, in index
    order (``build_corpus``'s ``t000.png`` ... ``t023.png``)."""
    return _convergence_corpus(with_val=False)[0]


def synthetic_val_set() -> list[np.ndarray]:
    """The 6 val images, uint8 (384, 512, 3), in index order."""
    return _convergence_corpus(with_val=True)[1]
