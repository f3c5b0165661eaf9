"""PNG on ``zlib`` and numpy: what the eval and the CLI read and write, with
no PIL (the card's machine has none).

Reads 8-bit, non-interlaced PNGs of colour type 0 (grey) and 2 (RGB), filter
types 0-4 per scanline, the image data in any number of IDAT chunks; the
array equals ``np.asarray(PIL.Image.open(p))`` (H×W for grey, H×W×3 for RGB)
bitwise. Anything else (other bit depths, palettes, alpha, Adam7) raises
ValueError naming what it is. Writes 8-bit grey or RGB, every scanline with
filter 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # colour type → samples a pixel
_COLOUR_NAMES = {3: "palette (colour type 3)", 4: "grey with alpha (colour type 4)",
                 6: "RGB with alpha (colour type 6)"}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length  # length, type, body, CRC


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec §9): ``raw`` holds h rows of a
    filter byte then ``stride`` bytes; ``bpp`` bytes a pixel. None, Sub and
    Up are vectorized; Average and Paeth, where each byte depends on the one
    ``bpp`` before it, run byte by byte on Python ints."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):
            ln, up, c = line.tolist(), prev.tolist(), [0] * stride
            for i in range(stride):
                a = c[i - bpp] if i >= bpp else 0
                if kind == 3:
                    c[i] = (ln[i] + ((a + up[i]) >> 1)) & 0xFF
                    continue
                b, d = up[i], up[i - bpp] if i >= bpp else 0
                p = a + b - d
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - d)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else d
                c[i] = (ln[i] + pred) & 0xFF
            cur = np.asarray(c, np.int64)
        else:
            raise ValueError(f"PNG filter type {kind} is not one of 0-4")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """The image at ``path`` as uint8, (H, W) grey or (H, W, 3) RGB."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth} is not supported (8-bit only)")
    if colour not in _CHANNELS:
        name = _COLOUR_NAMES.get(colour, f"colour type {colour}")
        raise ValueError(f"{path}: {name} is not supported (grey or RGB only)")
    if interlace:
        raise ValueError(f"{path}: Adam7 interlacing is not supported")
    if compression or filtering:
        raise ValueError(f"{path}: unknown compression or filter method")
    ch = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * ch + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {w}x{h}")
    pixels = _unfilter(raw, h, w * ch, ch)
    return pixels.reshape(h, w) if ch == 1 else pixels.reshape(h, w, ch)


def read_rgb(path: str) -> np.ndarray:
    """The image as (H, W, 3) uint8: ``PIL.Image.open(path).convert("RGB")``
    (a grey image repeated over the three channels)."""
    img = read_png(path)
    return np.repeat(img[:, :, None], 3, axis=2) if img.ndim == 2 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W) grey or (H, W, 3) RGB array, filter 0 rows."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 (H, W) or (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
                 + _chunk(b"IEND", b""))
