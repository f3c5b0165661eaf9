"""The port's training data path against the JAX package's, bitwise: the
synthetic corpus writer, ``PatchDataset`` in its three sampling modes,
``batched_loader`` with and without ``skip_batches``, augmentation and
colour; and the port's own rules (arrays instead of files, the CPU prefetch,
the native backend refused for a dataset it cannot serve). The native batch
path itself is ``test_torch_native_data.py``'s."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from irdu_tpu.data import augment as jax_augment
from irdu_tpu.data import color as jax_color
from irdu_tpu.data.dataset import PatchDataset as JaxPatchDataset
from irdu_tpu.data.dataset import read_image_index as jax_read_index
from irdu_tpu.data.loader import batched_loader as jax_loader
from irdu_tpu.data.synthetic import make_synthetic_image as jax_make_image
from irdu_tpu.data.synthetic import write_synthetic_corpus as jax_write_corpus
from irdu_tpu_torch.data import augment, color
from irdu_tpu_torch.data.dataset import PatchDataset, read_image_index
from irdu_tpu_torch.data.loader import batched_loader, device_prefetch
from irdu_tpu_torch.data.synthetic import (synthetic_train_set, synthetic_val_set,
                                           write_synthetic_corpus)

# two images above the 800-pixel tiling threshold would make the corpus slow
# to write; 6 images of 70-180 pixels cover padding (a side below the patch)
CORPUS = dict(n_images=6, size_range=(70, 180), seed=3)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's corpus; the JAX writer's beside it, for the writer test."""
    root = str(tmp_path_factory.mktemp("port_corpus"))
    jax_root = str(tmp_path_factory.mktemp("jax_corpus"))
    return (root, write_synthetic_corpus(root, **CORPUS),
            jax_root, jax_write_corpus(jax_root, **CORPUS))


def _images(root, csv_path):
    from PIL import Image

    return {r["path"]: np.array(Image.open(os.path.join(root, r["path"])))
            for r in read_image_index(csv_path)}


def test_corpus_writer_matches_jax(corpus):
    """Same PNG pixels and the same CSV index rows."""
    root, csv_path, jax_root, jax_csv = corpus
    assert read_image_index(csv_path) == jax_read_index(jax_csv)
    ours, theirs = _images(root, csv_path), _images(jax_root, jax_csv)
    assert ours.keys() == theirs.keys() and len(ours) == CORPUS["n_images"]
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


MODES = {
    "random_tiled": dict(patch_size=(64, 64), max_num_patchs=40, use_data_aug=True),
    "grid": dict(patch_size=(48, 48), max_num_patchs=1000, patch_overlap_size=(16, 16),
                 use_data_aug=True, dist_mode="addictive_noise", lambda_noise=15.0),
    "resize": dict(patch_size=(96, 96), max_num_patchs=30, dist_mode="vary_addictive_noise",
                   lambda_noise=((10.0, 25.0), (0.5, 0.5))),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_patch_dataset_items_match_jax(corpus, mode):
    """Every item of the plan, then of a rerolled plan, bitwise JAX's."""
    root, csv_path, _, _ = corpus
    kw = dict(csv_path=csv_path, root_folder=root, sampling=mode, seed=11, **MODES[mode])
    ours, theirs = PatchDataset(**kw), JaxPatchDataset(**kw)
    assert len(ours) == len(theirs) > 0
    for rerolled in (False, True):
        if rerolled:
            ours.reroll(12)
            theirs.reroll(12)
        for i in range(len(ours)):
            for a, b in zip(ours[i], theirs[i]):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    # every mode's corpus is native-compatible: the native batch is the items
    assert ours.native_compatible()
    noisy, clean = ours.get_batch(range(len(ours)))
    np.testing.assert_array_equal(noisy, np.stack([theirs[i][0] for i in range(len(ours))]))
    np.testing.assert_array_equal(clean, np.stack([theirs[i][1] for i in range(len(ours))]))


@pytest.mark.parametrize("skip", [0, 3])
def test_batched_loader_matches_jax(corpus, skip):
    """The batches, after an index-only skip of ``skip`` batches too, bitwise
    JAX's thread-pool loader's (its native backend is not asked for; the
    port's "auto" takes its own native path)."""
    root, csv_path, _, _ = corpus
    kw = dict(csv_path=csv_path, root_folder=root, patch_size=(32, 32), max_num_patchs=30,
              use_data_aug=True, seed=5)
    ours = list(batched_loader(PatchDataset(**kw), 4, skip_batches=skip))
    theirs = list(jax_loader(JaxPatchDataset(**kw), 4, skip_batches=skip, backend="python"))
    assert len(ours) == len(theirs) == 30 // 4 - skip
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    if skip:
        replay = list(batched_loader(PatchDataset(**kw), 4))[skip:]
        for a, b in zip(ours, replay):
            np.testing.assert_array_equal(a[0], b[0])


def test_arrays_in_place_of_files(corpus):
    """``images`` hands the images over: the items are those read from the
    files, and no file is read (the paths do not exist)."""
    root, csv_path, _, _ = corpus
    kw = dict(csv_path=csv_path, patch_size=(32, 32), max_num_patchs=12, use_data_aug=True)
    from_files = PatchDataset(root_folder=root, **kw)
    in_memory = PatchDataset(root_folder="/nonexistent", images=_images(root, csv_path), **kw)
    for i in range(len(from_files)):
        for a, b in zip(from_files[i], in_memory[i]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", range(8))
def test_dihedral_modes_match_jax(mode):
    img = np.random.RandomState(mode).rand(6, 10, 3).astype(np.float32)
    np.testing.assert_array_equal(augment.dihedral_augment(img, mode),
                                  jax_augment.dihedral_augment(img, mode))


def test_augment_draw_and_colour_match_jax():
    """The mode draw (randint(0, 7): mode 7 never drawn) and the YCbCr pair."""
    a, b = np.random.RandomState(4), np.random.RandomState(4)
    draws = [augment.sample_augment_mode(a) for _ in range(200)]
    assert draws == [jax_augment.sample_augment_mode(b) for _ in range(200)]
    assert 7 not in draws
    rgb = np.random.RandomState(5).rand(4, 5, 3)
    np.testing.assert_array_equal(color.rgb2ycbcr(rgb), jax_color.rgb2ycbcr(rgb))
    ycc = jax_color.rgb2ycbcr(rgb)
    np.testing.assert_array_equal(color.ycbcr2rgb(ycc), jax_color.ycbcr2rgb(ycc))


def test_device_prefetch_on_the_cpu_makes_no_copy():
    """On the CPU the tensors are the numpy arrays' memory: no pinned copy,
    no device copy; order and count kept, ``size`` batches in flight."""
    batches = [(np.full((2, 4, 4, 3), i, np.float32), np.zeros((2, 4, 4, 3), np.float32))
               for i in range(5)]
    out = list(device_prefetch(iter(batches), "cpu", size=3))
    assert len(out) == 5
    for (n, c), (tn, tc) in zip(batches, out):
        assert isinstance(tn, torch.Tensor) and tn.device.type == "cpu"
        assert not tn.is_pinned()
        assert tn.data_ptr() == n.__array_interface__["data"][0]
        np.testing.assert_array_equal(tc.numpy(), c)


def test_native_backend_is_refused():
    """A dataset without ``native_compatible`` (a list of pairs): "native"
    raises, "auto" stacks its items."""
    pairs = [(np.zeros(1), np.ones(1))]
    with pytest.raises(RuntimeError, match="not native_compatible"):
        next(batched_loader(pairs, 1, backend="native"))
    noisy, clean = next(batched_loader(pairs, 1, backend="auto"))
    assert noisy.shape == clean.shape == (1, 1) and clean[0, 0] == 1


def test_synthetic_train_set_is_the_convergence_draw():
    """The 24 train images of ``scripts/run_convergence_tpu.py``'s
    ``build_corpus`` (one RandomState(42), sides 420-519, drawn with JAX's
    ``make_synthetic_image``), then the val set from the same stream."""
    rng = np.random.RandomState(42)
    train = synthetic_train_set()
    assert len(train) == 24
    for img in train:
        h, w = int(rng.randint(420, 520)), int(rng.randint(420, 520))
        np.testing.assert_array_equal(img, jax_make_image(rng, h, w))
    for img in synthetic_val_set():
        np.testing.assert_array_equal(img, jax_make_image(rng, 384, 512))
