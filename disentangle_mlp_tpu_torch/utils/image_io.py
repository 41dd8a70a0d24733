"""Image saving: single images and grids, as PNG files
(disentangle_mlp_tpu/utils/image_io.py, the reference's torchvision
``save_image`` usage in utils/utils.py:6-32).

``normalize=True`` rescales each saved array from its own [min, max] to
[0, 255]; grids are rows of ``nrow`` with 2-pixel padding. PNGs are
written by :func:`write_png`, a small encoder on the standard library's
``zlib`` (8-bit grey or RGB, filter 0, no interlace), so the files need no
imaging package, and read by :func:`read_png` (8-bit, every colour type and
row filter, no interlace), which serves PNG folder trees and FID
statistics of a directory of PNG files.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2}  # channels → PNG colour type (grey, RGB)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write an HW or HWC (C = 1 or 3) uint8 array as a PNG file."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f"write_png: uint8 array needed, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in _COLOR_TYPES:
        raise ValueError(f"write_png: HW, HW1 or HW3 array needed, got shape "
                         f"{arr.shape}")
    h, w, c = arr.shape
    # each scanline: filter byte 0, then the row's samples
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG file as an (H, W, 3) uint8 RGB array."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, name: str
              ) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of ``h``
    rows of ``stride`` bytes; ``bpp`` bytes a pixel."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{name}: PNG image data holds {len(raw)} bytes, "
                         f"expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum along each byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: left to right
            cur = np.zeros(stride, np.int64)
            up = prior.astype(np.int64)
            ln = line.astype(np.int64)
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (ln[i] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"{name}: unknown PNG row filter {kind}")
        out[y] = cur
        prior = cur
    return out


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes → (H, W, 3) uint8 RGB, as PIL's ``convert("RGB")`` gives
    it: grey replicated, palette looked up (its transparency dropped),
    alpha dropped. 8-bit colour types 0, 2, 3, 4 and 6, non-interlaced;
    anything else, or a damaged file, raises ValueError naming ``name``."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{name}: PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    else:
        raise ValueError(f"{name}: PNG file ends before its IEND chunk")
    if header is None:
        raise ValueError(f"{name}: PNG file without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{name}: PNG of bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} is not read (8-bit "
                         f"colour types 0, 2, 3, 4, 6 without interlace)")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: PNG image data: {e}") from e
    px = _unfilter(raw, h, w * channels, channels, name).reshape(
        h, w, channels)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)  # indices past the palette: black
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _to_uint8(img: np.ndarray, normalize: bool = True) -> np.ndarray:
    """HWC float → HWC uint8. With normalize, rescale from the array's own
    range (torchvision save_image(normalize=True) semantics)."""
    img = np.asarray(img, np.float32)
    if normalize:
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / max(hi - lo, 1e-5)
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_image(img, path: str, normalize: bool = True) -> None:
    """Save one HWC image (any float range)."""
    write_png(path, _to_uint8(np.asarray(img), normalize))


def make_grid(batch: np.ndarray, nrow: int = 8, padding: int = 2,
              normalize: bool = True) -> np.ndarray:
    """NHWC batch → one HWC grid image (torchvision make_grid layout)."""
    batch = np.asarray(batch, np.float32)
    n, h, w, c = batch.shape
    if normalize:
        lo, hi = float(batch.min()), float(batch.max())
        batch = (batch - lo) / max(hi - lo, 1e-5)
    ncol = min(nrow, n)
    nrows = math.ceil(n / ncol)
    grid = np.zeros(
        (nrows * (h + padding) + padding, ncol * (w + padding) + padding, c),
        np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = padding + r * (h + padding)
        x0 = padding + col * (w + padding)
        grid[y0:y0 + h, x0:x0 + w] = batch[i]
    return grid


def save_image_grid(batch, path: str, nrow: int = 8,
                    normalize: bool = True) -> None:
    grid = make_grid(np.asarray(batch), nrow=nrow, normalize=normalize)
    write_png(path, np.clip(grid * 255.0 + 0.5, 0, 255).astype(np.uint8))
