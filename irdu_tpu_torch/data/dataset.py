"""CSV-indexed noisy-pair patch dataset (a copy of
``irdu_tpu/data/dataset.py``, numpy only, with its RNG call sequences, so
that a shared seed gives the same patches and noise):

  * big images (both sides > 800) are pre-tiled into 512×512 tiles with
    overlap 96; small ones contribute a single tile;
  * ``max_num_patchs`` random crop positions are drawn over the tiles with
    a seeded RandomState, permuted, subselected;
  * an item: crop → symmetric pad if the tile is smaller than the patch →
    floor to /16 → optional dihedral augment → /255 → degradation noise,
    from an RNG seeded with (dataset seed, index);
  * returns (noisy, clean) float32 HWC pairs.

Images are read with PIL at first use and cached; ``images`` hands them over
as arrays instead (the card's machine has no PIL). ``build_image_index``
writes the ``index,path,height,width,nchannels`` CSV schema.
``get_batch`` assembles a whole batch in the native C++ path
(``data/native``), bitwise what ``__getitem__`` stacks, wherever
``native_compatible`` holds.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

from irdu_tpu_torch.data.augment import dihedral_augment, sample_augment_mode
from irdu_tpu_torch.data.degradations import _ALIASES, add_noise

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(path))


def build_image_index(root_folder: str, out_csv: str,
                      subdirs: list[str] | None = None) -> int:
    """Scan ``root_folder`` (or the given subdirs) for images and write the
    CSV schema; returns the number of rows written. Needs PIL."""
    rows = []
    roots = [os.path.join(root_folder, s) for s in subdirs] if subdirs else [root_folder]
    for r in roots:
        for dirpath, _, files in sorted(os.walk(r)):
            for f in sorted(files):
                if not f.lower().endswith(_IMG_EXTS):
                    continue
                full = os.path.join(dirpath, f)
                img = _load_image(full)
                h, w = img.shape[:2]
                c = 1 if img.ndim == 2 else img.shape[2]
                rows.append((os.path.relpath(full, root_folder), h, w, c))
    with open(out_csv, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["index", "path", "height", "width", "nchannels"])
        for i, (p, h, w, c) in enumerate(rows):
            writer.writerow([i, p, h, w, c])
    return len(rows)


def read_image_index(csv_path: str) -> list[dict]:
    with open(csv_path, newline="") as fh:
        return [
            {
                "path": row["path"],
                "height": int(row["height"]),
                "width": int(row["width"]),
                "nchannels": int(row["nchannels"]),
            }
            for row in csv.DictReader(fh)
        ]


@dataclass
class PatchDataset:
    """sampling modes (one per reference dataloader generation):
      "random_tiled" — big images pre-tiled 512/96, seeded random crops (the
                       flagship trainers' mode);
      "grid"         — a fixed-overlap grid of patch positions over every
                       image;
      "resize"       — like "random_tiled", but big images are dropped (the
                       reference resizes them and never appends them; quirk
                       kept) and the noisy patch is clipped to [0, 1].

    images: {path as the CSV names it: uint8 array}, put in the image cache
    so that no file is read.
    """

    csv_path: str
    root_folder: str
    patch_size: tuple[int, int] = (64, 64)
    max_num_patchs: int = 100000
    dist_mode: str = "addictive_noise_scale"
    lambda_noise: object = 25.0
    use_data_aug: bool = False
    seed: int = 2204
    sampling: str = "random_tiled"
    patch_overlap_size: tuple[int, int] = (32, 32)  # grid mode
    clip_noisy: bool | None = None  # default: True only for "resize"
    # the tiling plan's constants
    tile_size: int = 512
    tile_overlap: int = 96
    tile_threshold: int = 800
    cache_images: bool = True
    images: Mapping[str, np.ndarray] | None = field(default=None, repr=False)

    _tiles: list[dict] = field(default_factory=list, init=False, repr=False)
    _patches: list[dict] = field(default_factory=list, init=False, repr=False)
    _cache: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        if self.images is not None:
            self._cache = {os.path.join(self.root_folder, k): v for k, v in self.images.items()}
        self.random_state = np.random.RandomState(seed=self.seed)
        self._item_seed = self.seed
        self._create_tiles()
        self._create_patches(self.max_num_patchs)
        self._permute_subselect(self.max_num_patchs)

    # -- sampling plan ---------------------------------------------------

    def _create_tiles(self):
        infos = read_image_index(self.csv_path)
        tiles = []
        for info in infos:
            h, w, c = info["height"], info["width"], info["nchannels"]
            path = os.path.join(self.root_folder, info["path"])
            if self.sampling == "resize":
                if not ((w > self.tile_threshold) and (h > self.tile_threshold)):
                    tiles.append({
                        "row": 0, "col": 0, "height": h, "width": w,
                        "nchannels": c, "path": path,
                    })
                continue
            if (w > self.tile_threshold) and (h > self.tile_threshold):
                step = self.tile_size - self.tile_overlap
                for row in np.arange(0, h - self.tile_size, step):
                    for col in np.arange(0, w - self.tile_size, step):
                        tiles.append({
                            "row": int(row), "col": int(col),
                            "height": self.tile_size, "width": self.tile_size,
                            "nchannels": c, "path": path,
                        })
            else:
                tiles.append({
                    "row": 0, "col": 0, "height": h, "width": w,
                    "nchannels": c, "path": path,
                })
        self._tiles = tiles

    def _create_patches(self, max_num_patchs: int):
        """Draw crop positions with the reference's RNG call pattern (randint
        per eligible tile, looping until ``max_num_patchs`` are covered), or
        in grid mode enumerate the fixed-overlap positions."""
        if self.sampling == "grid":
            patches = []
            ph, pw = self.patch_size
            oh, ow = self.patch_overlap_size
            for tile in self._tiles:
                if tile["nchannels"] > 3:
                    continue
                for row in np.arange(0, tile["height"] - ph, ph - oh):
                    for col in np.arange(0, tile["width"] - pw, pw - ow):
                        patches.append({
                            "row": int(row), "col": int(col),
                            "padding": False, "path": tile["path"],
                        })
            self._patches_all = patches
            return
        patches = []
        n_loops = max_num_patchs // max(len(self._tiles), 1) + 1
        ph, pw = self.patch_size
        for _ in range(n_loops):
            for tile in self._tiles:
                if tile["nchannels"] > 3:
                    continue
                if (ph < tile["height"]) and (pw < tile["width"]):
                    patches.append({
                        "row": tile["row"] + int(self.random_state.randint(0, tile["height"] - ph)),
                        "col": tile["col"] + int(self.random_state.randint(0, tile["width"] - pw)),
                        "padding": False,
                        "path": tile["path"],
                    })
                else:
                    patches.append({
                        "row": tile["row"], "col": tile["col"],
                        "padding": True, "path": tile["path"],
                    })
        self._patches_all = patches

    def _permute_subselect(self, max_num_patchs: int):
        ind = self.random_state.permutation(len(self._patches_all))[:max_num_patchs]
        self._patches = [self._patches_all[i] for i in ind]

    def reroll(self, seed: int):
        """Re-draw the crop positions and the items' seed (a per-epoch
        reshuffle)."""
        self.random_state = np.random.RandomState(seed=seed)
        self._item_seed = seed
        self._create_patches(self.max_num_patchs)
        self._permute_subselect(self.max_num_patchs)

    # -- item access -----------------------------------------------------

    def __len__(self):
        return len(self._patches)

    def _image(self, path: str) -> np.ndarray:
        if path in self._cache:
            return self._cache[path]
        img = _load_image(path)
        if self.cache_images:
            self._cache[path] = img
        return img

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        # The item's RNG comes from (dataset seed, idx): its content is a pure
        # function of the index, so a threaded loader stays deterministic and
        # a resume that skips indices replays the same batches.
        item_rs = np.random.RandomState(
            np.random.MT19937(np.random.SeedSequence((self._item_seed, idx))))
        rec = self._patches[idx]
        img = self._image(rec["path"])
        ph, pw = self.patch_size
        patch = img[rec["row"]: rec["row"] + ph, rec["col"]: rec["col"] + pw, :]
        if rec["padding"]:
            h, w = patch.shape[:2]
            patch = np.pad(patch, ((0, ph - h), (0, pw - w), (0, 0)), mode="symmetric")
        h_, w_ = (patch.shape[0] // 16) * 16, (patch.shape[1] // 16) * 16
        patch = patch[:h_, :w_]
        if self.use_data_aug:
            patch = dihedral_augment(patch, sample_augment_mode(item_rs))
        patch = patch.astype(np.float32) / 255.0
        noisy = add_noise(patch, self.dist_mode, self.lambda_noise, item_rs)
        clip = self.clip_noisy if self.clip_noisy is not None else (self.sampling == "resize")
        if clip:
            noisy = np.clip(noisy, 0.0, 1.0)
        return noisy, patch

    # -- native batch path -------------------------------------------------

    def native_compatible(self) -> bool:
        """True when ``get_batch`` serves items bit-identically to
        ``__getitem__`` (JAX's conditions): the native library builds and
        loads, the sources are 3-channel (uint8 where they are already
        loaded), the noise mode is one of the four, and when augmenting the
        /16-floored patch is square."""
        from irdu_tpu_torch.data import native

        if not native.available():
            return False
        if any(t["nchannels"] != 3 for t in self._tiles if t["nchannels"] <= 3):
            return False
        if any(im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3
               for im in self._cache.values()):
            return False
        mode = _ALIASES.get(self.dist_mode, self.dist_mode)
        if mode not in ("addictive_noise", "addictive_noise_scale",
                        "vary_addictive_noise", "none", "", None):
            return False
        ph, pw = self.patch_size
        if self.use_data_aug and (ph // 16) * 16 != (pw // 16) * 16:
            return False
        return True

    def get_batch(self, indices, num_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """The (noisy, clean) batch of ``indices`` assembled in the native C++
        path, items across ``num_threads`` threads (0: one a core, up to one
        an item): bitwise ``__getitem__``'s items stacked."""
        from irdu_tpu_torch.data import native

        recs = [self._patches[int(i)] for i in indices]
        images = [np.ascontiguousarray(self._image(r["path"])) for r in recs]
        crops = np.array([[r["row"], r["col"]] for r in recs], np.int32)
        pads = np.array([r["padding"] for r in recs], np.uint8)
        idx = np.asarray(list(indices), np.int64)
        clip = self.clip_noisy if self.clip_noisy is not None else (self.sampling == "resize")
        return native.make_pairs(
            images, crops, pads, idx,
            patch_size=tuple(self.patch_size),
            seed=self._item_seed,
            use_aug=self.use_data_aug,
            dist_mode=_ALIASES.get(self.dist_mode, self.dist_mode),
            lambda_noise=self.lambda_noise,
            clip=bool(clip),
            num_threads=num_threads,
        )
