"""The port's native (C++) batch path (``irdu_tpu_torch.data.native``) on the
CPU: its RNG against numpy itself, ``PatchDataset.get_batch`` against JAX's
``PatchDataset.__getitem__`` bitwise (JAX's items are pure numpy; JAX's own
native library is never imported or built here), the loader's "native"
backend against its "python" one with a resume skip, two builds racing
into one directory, and the refusal when no compiler is there.

The images are arrays handed to both datasets (the port's ``images=``,
JAX's image cache), so no file is read."""

from __future__ import annotations

import ctypes
import csv
import os
import threading

import numpy as np
import pytest

from irdu_tpu.data.dataset import PatchDataset as JaxPatchDataset
from irdu_tpu_torch.data import native
from irdu_tpu_torch.data.dataset import PatchDataset
from irdu_tpu_torch.data.loader import batched_loader
from irdu_tpu_torch.data.synthetic import make_synthetic_image

VARY = ([1.0, 10.0, 15.0, 20.0, 25.0], [0.1, 0.1, 0.1, 0.1, 0.6])
LAMBDA = {"none": 25.0, "addictive_noise": 25.0, "addictive_noise_scale": 25.0,
          "vary_addictive_noise": VARY}
# (h, w) of each corpus: "main" has a big image (tiled 512/96) and crops
# inside every tile; "small" has tiles below the patch, so items are padded
# symmetrically, one of them wider than its source (20 rows padded to 64)
SIZES = {"main": [(90, 130), (150, 101), (850, 830), (120, 120)],
         "small": [(40, 50), (20, 30), (70, 45)]}


def _corpus(root, name):
    """The CSV of corpus ``name`` under ``root``, and {CSV path: uint8 image}."""
    rs = np.random.RandomState(11)
    images = {f"{name}{i}.png": make_synthetic_image(rs, h, w)
              for i, (h, w) in enumerate(SIZES[name])}
    csv_path = os.path.join(root, f"{name}.csv")
    with open(csv_path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["index", "path", "height", "width", "nchannels"])
        for i, (path, im) in enumerate(images.items()):
            w.writerow([i, path, im.shape[0], im.shape[1], 3])
    return csv_path, images


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native_corpus"))
    return root, {name: _corpus(root, name) for name in SIZES}


def _datasets(corpora, corpus="main", **kw):
    """The port's and JAX's dataset on the same corpus and settings."""
    root, by_name = corpora
    csv_path, images = by_name[corpus]
    kw = dict(dict(patch_size=(64, 64), max_num_patchs=12, seed=2204), **kw)
    ours = PatchDataset(csv_path, root, images=images, **kw)
    theirs = JaxPatchDataset(csv_path, root, **kw)
    theirs._cache = {os.path.join(root, k): v for k, v in images.items()}
    assert ours._patches == theirs._patches
    return ours, theirs


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_rng_probe_matches_numpy(kind):
    """Each kind of draw from RandomState(MT19937(SeedSequence((seed, idx))))
    against numpy itself: raw u32 (past a state refill), randint(0, 7),
    normals (polar method, cached pairs), random_sample, choice."""
    probs = [0.1, 0.2, 0.3, 0.4]
    for seed, idx in [(2204, 0), (2204, 123), (0, 0), (2**40 + 12345, 7)]:
        rs = np.random.RandomState(np.random.MT19937(np.random.SeedSequence((seed, idx))))
        if kind == 0:
            mt = np.random.MT19937(np.random.SeedSequence((seed, idx)))
            want = np.random.Generator(mt).integers(0, 2**32, 1400, dtype=np.uint32)
            got = native.rng_probe(seed, idx, 0, 1400)
        elif kind == 1:
            want, got = [rs.randint(0, 7) for _ in range(100)], native.rng_probe(seed, idx, 1, 100)
        elif kind == 2:
            want, got = rs.normal(0, 1, 3001), native.rng_probe(seed, idx, 2, 3001)
        elif kind == 3:
            want, got = rs.random_sample(500), native.rng_probe(seed, idx, 3, 500)
        else:
            want = [rs.choice(4, p=probs) for _ in range(100)]
            got = native.rng_probe(seed, idx, 4, 100, probs)
        assert np.array_equal(np.asarray(want, np.float64), got), (seed, idx)


BATCH_CASES = {
    **{f"{mode}-aug{int(aug)}": dict(dist_mode=mode, lambda_noise=LAMBDA[mode], use_data_aug=aug)
       for mode in LAMBDA for aug in (False, True)},
    "padded": dict(corpus="small", use_data_aug=True, lambda_noise=25.0),
    "not16-square-aug": dict(patch_size=(40, 40), use_data_aug=True, lambda_noise=25.0),
    "not16-oblong": dict(patch_size=(40, 56), use_data_aug=False,
                         dist_mode="vary_addictive_noise", lambda_noise=VARY),
    "resize-clipped": dict(sampling="resize", dist_mode="addictive_noise", lambda_noise=50.0,
                           use_data_aug=True),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_get_batch_is_jax_items_bitwise(corpora, case):
    """``get_batch`` over every item (3 threads) against JAX's
    ``__getitem__`` items stacked, bitwise, with the /16 floor's shape; after
    a reroll too (another item seed)."""
    ours, theirs = _datasets(corpora, **BATCH_CASES[case])
    assert ours.native_compatible()
    for reroll in (None, 77):
        if reroll is not None:
            ours.reroll(reroll)
            theirs.reroll(reroll)
        idx = list(range(len(ours)))
        noisy, clean = ours.get_batch(idx, num_threads=3)
        items = [theirs[i] for i in idx]
        ph, pw = ours.patch_size
        assert noisy.shape == clean.shape == (len(idx), ph // 16 * 16, pw // 16 * 16, 3)
        assert noisy.dtype == clean.dtype == np.float32
        assert np.array_equal(clean, np.stack([c for _, c in items]))
        assert np.array_equal(noisy, np.stack([n for n, _ in items]))
    if BATCH_CASES[case].get("dist_mode") != "none":
        assert not np.array_equal(noisy, clean)
    if case == "resize-clipped":
        assert noisy.min() >= 0.0 and noisy.max() <= 1.0
    if case == "padded":
        assert all(r["padding"] for r in ours._patches)


def test_native_loader_equals_python_with_skip(corpora):
    """``batched_loader`` on the native backend gives the python backend's
    batches bitwise, from the start and after ``skip_batches`` (a resume),
    and "auto" takes the native path on a compatible dataset."""
    ours, _ = _datasets(corpora, dist_mode="vary_addictive_noise", lambda_noise=VARY,
                        use_data_aug=True, max_num_patchs=14)

    def run(backend, skip=0):
        return list(batched_loader(ours, 3, backend=backend, skip_batches=skip, num_workers=2))

    python, nat = run("python"), run("native")
    assert len(python) == len(nat) == 4
    for (a, b), (c, d) in zip(python, nat):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    resumed = run("native", skip=2)
    assert len(resumed) == 2
    for (a, b), (c, d) in zip(python[2:], resumed):
        assert np.array_equal(a, c) and np.array_equal(b, d)

    calls = []
    get_batch = ours.get_batch
    ours.get_batch = lambda idx, num_threads=0: calls.append(list(idx)) or get_batch(
        idx, num_threads)
    auto = run("auto", skip=1)
    assert calls == [[3, 4, 5], [6, 7, 8], [9, 10, 11]]
    assert all(np.array_equal(a, c) for (a, _), (c, _) in zip(python[1:], auto))


def test_incompatible_dataset_takes_python_or_raises(corpora):
    """Augmenting an oblong patch (the dihedral modes need a square) is not
    native-compatible: "auto" gives the thread pool's batches (of one item:
    a rotated item has another shape), "native" raises."""
    ours, theirs = _datasets(corpora, patch_size=(40, 56), use_data_aug=True)
    assert not ours.native_compatible()
    auto = list(batched_loader(ours, 1, backend="auto"))
    assert len(auto) == 12 and {a.shape[1:3] for a, _ in auto} == {(32, 48), (48, 32)}
    for i, (noisy, clean) in enumerate(auto):
        assert np.array_equal(noisy[0], theirs[i][0]) and np.array_equal(clean[0], theirs[i][1])
    with pytest.raises(RuntimeError, match="not native_compatible"):
        next(batched_loader(ours, 1, backend="native"))


def test_two_builds_at_once_end_with_one_library(tmp_path, monkeypatch):
    """Two threads build into one fresh directory at the same moment: each
    compiles to a name of its own and renames it into place, so both return
    the one path, no temporary file is left, and the library loads and
    draws numpy's normals."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    barrier = threading.Barrier(2)
    paths, errors = [], []

    def go():
        barrier.wait()
        try:
            paths.append(native.build())
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=go) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(paths) == 2 and paths[0] == paths[1]
    assert paths[0] == native.library_path()
    assert os.listdir(tmp_path) == [os.path.basename(paths[0])]
    lib = native._bind(ctypes.CDLL(paths[0]))
    out = np.empty(7, np.float64)
    lib.irdu_rng_probe(5, 6, 2, 7, None, 0, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    rs = np.random.RandomState(np.random.MT19937(np.random.SeedSequence((5, 6))))
    assert np.array_equal(out, rs.normal(0, 1, 7))


def test_native_backend_raises_without_a_compiler(corpora, tmp_path, monkeypatch):
    """With ``CXX`` naming a missing binary and a fresh build directory the
    library cannot be built: ``available()`` is False, ``load_error()`` names
    the compiler, "native" raises with it and "auto" takes the thread pool."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "fresh"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    ours, theirs = _datasets(corpora)
    assert not native.available()
    assert "no-such-compiler" in native.load_error()
    assert not ours.native_compatible()
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        next(batched_loader(ours, 4, backend="native"))
    noisy, _ = next(batched_loader(ours, 4, backend="auto"))
    assert np.array_equal(noisy, np.stack([theirs[i][0] for i in range(4)]))
    assert not os.path.exists(str(tmp_path / "fresh")) or not os.listdir(tmp_path / "fresh")
