"""The port's PNG reader and writer (``irdu_tpu_torch/data/png.py``) against
PIL, which the JAX scripts read the natural-image set with: the committed
PNGs, seeded images with each scanline filter written by hand, what the
reader refuses, and a write-then-read round trip."""

from __future__ import annotations

import glob
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from irdu_tpu_torch.data import png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = sorted(glob.glob(os.path.join(REPO, "artifacts", "natural_eval", "*", "*.png")))


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filtered(img, kinds):
    """The scanlines of uint8 ``img`` (H, W[, C]), row y with filter
    kinds[y % len(kinds)], written out from the PNG spec's definitions."""
    h = img.shape[0]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(int)
    out = bytearray()
    for y in range(h):
        kind = kinds[y % len(kinds)]
        out.append(kind)
        for i, v in enumerate(rows[y]):
            a = rows[y, i - bpp] if i >= bpp else 0
            b = rows[y - 1, i] if y else 0
            c = rows[y - 1, i - bpp] if y and i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((v - pred) & 0xFF)
    return bytes(out)


def _png_bytes(img, kinds=(0,), idat_pieces=1, depth=8, colour=None, interlace=0):
    h, w = img.shape[:2]
    colour = (0 if img.ndim == 2 else 2) if colour is None else colour
    data = zlib.compress(_filtered(img, kinds))
    step = -(-len(data) // idat_pieces)
    idats = b"".join(_chunk(b"IDAT", data[k:k + step]) for k in range(0, len(data), step))
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return png.SIGNATURE + _chunk(b"IHDR", header) + idats + _chunk(b"IEND", b"")


def _seeded(shape, seed):
    """Smooth gradients plus noise, so that every filter has work to do."""
    rng = np.random.RandomState(seed)
    h, w = shape[:2]
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 5)
    if len(shape) == 3:
        base = base[:, :, None] + np.arange(shape[2]) * 40
    return ((base + rng.randint(0, 60, shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("path", COMMITTED, ids=os.path.basename)
def test_committed_pngs_read_as_pil_does(path):
    assert len(COMMITTED) == 8
    ref = Image.open(path)
    ours = png.read_png(path)
    assert ours.dtype == np.uint8 and np.array_equal(ours, np.asarray(ref))
    assert np.array_equal(png.read_rgb(path), np.asarray(ref.convert("RGB")))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_each_filter_type_reads_as_pil_does(kind, tmp_path):
    for shape in ((9, 13, 3), (7, 11)):
        img = _seeded(shape, seed=kind)
        path = str(tmp_path / f"f{kind}_{len(shape)}.png")
        with open(path, "wb") as fh:
            fh.write(_png_bytes(img, kinds=(kind,)))
        assert np.array_equal(png.read_png(path), img)
        assert np.array_equal(png.read_png(path), np.asarray(Image.open(path)))


def test_mixed_filters_over_several_idat_chunks(tmp_path):
    img = _seeded((23, 17, 3), seed=5)
    path = str(tmp_path / "mixed.png")
    with open(path, "wb") as fh:
        fh.write(_png_bytes(img, kinds=(4, 1, 0, 3, 2), idat_pieces=5))
    assert np.array_equal(png.read_png(path), img)
    assert np.array_equal(png.read_png(path), np.asarray(Image.open(path)))


@pytest.mark.parametrize("case,words", [
    ("16-bit", "bit depth 16"), ("palette", "palette"), ("rgba", "alpha"),
    ("adam7", "Adam7"), ("not_png", "not a PNG")])
def test_unsupported_pngs_raise(case, words, tmp_path):
    path = str(tmp_path / f"{case}.png")
    img = _seeded((6, 5, 3), seed=1)
    if case == "16-bit":
        Image.fromarray(img[:, :, 0].astype(np.uint16) * 257).save(path)
    elif case == "palette":
        Image.fromarray(img).convert("P").save(path)
    elif case == "rgba":
        Image.fromarray(np.dstack([img, img[:, :, :1]])).save(path)
    else:
        with open(path, "wb") as fh:
            fh.write(_png_bytes(img, interlace=1) if case == "adam7" else b"GIF89a")
    with pytest.raises(ValueError, match=words):
        png.read_png(path)


@pytest.mark.parametrize("shape", [(31, 45, 3), (12, 9)])
def test_write_then_read_is_bitwise(shape, tmp_path):
    img = _seeded(shape, seed=7)
    path = str(tmp_path / "out.png")
    png.write_png(path, img)
    assert np.array_equal(png.read_png(path), img)
    assert np.array_equal(np.asarray(Image.open(path)), img)
