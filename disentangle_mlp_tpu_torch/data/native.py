"""Image decode and the PIL-exact resize of the port's data feed: the
port's counterpart of ``disentangle_mlp_tpu/data/native.py`` and of the
resize in ``native/preprocess.cpp``.

- **JPEG decode, picked by the device** and by nothing else. On a CUDA
  device, nvJPEG on the card (``csrc/nvjpeg_decode.cu``, backend
  ``NVJPEG_BACKEND_DEFAULT``): only the compressed bytes cross PCIe. It
  hands over the components' planes as its IDCT leaves them, and
  :func:`ycc_to_rgb` upsamples and converts them on the card with
  libjpeg's own integer arithmetic (jdsample.c's upsampling, jdcolor.c's
  tables), so the card's RGB differs from libjpeg's only by the IDCT's
  rounding. That covers every chroma subsampling libjpeg writes: 4:4:4,
  4:2:2, 4:2:0, 4:4:0 and 4:1:1 (:data:`_PLANE_FACTORS`). CMYK and YCCK
  files come out as their four planes and :func:`cmyk_to_rgb` converts
  them as the host decoder and PIL do (YCCK through libjpeg's YCC→CMYK
  step first, then Adobe's inverted CMYK through PIL's ``cmyk2rgb``).
  Greyscale files take nvJPEG's own output (grey to RGB is a copy). On the
  CPU, libjpeg (``csrc/jpeg_host.cpp``), the decode's plain version, which
  gives the JAX package's native decode byte for byte, and PIL's for CMYK.
  A failed decode raises ValueError naming the file; it is never retried
  on another decoder, and nothing is skipped. A JPEG without its
  end-of-image marker is refused as truncated (libjpeg would fill the
  missing part with grey).
- **PNG decode** on the host (``utils/image_io.decode_png``), the images
  then moved to the device.
- **The resize**: PIL's antialiased bilinear filter, its tables built
  exactly as ``build_filter`` builds them (``native/preprocess.cpp:39-71``:
  float64 triangle weights over ``[xmin, xmax)``, stored as float32, each
  divided by the float32 of their float64 sum), applied to each group of
  images of one size as two float32 products ``Wy @ img @ Wxᵀ`` on the
  images' device, with TF32 off (a TF32 product moves results by about
  0.25 grey levels at 255 and flips roundings). The result is snapped to
  uint8 by the JAX package's own float32 sequence: ``x = acc·k − 1`` with
  ``k = 2/255``, then ``rint((x + 1)·127.5)`` clipped
  (``preprocess.cpp:121-123``, ``pipeline.py:199-206``), so ties round as
  they do there. Against the JAX package's sequential sums the products
  differ in summation order only: within 1 grey level, nearly all pixels
  exact.

Counters: ``card_decoded`` counts the images nvJPEG decoded,
``card_single`` those of them it decoded one at a time (files its batched
decoder does not take).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import threading
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..utils import runtime
from ..utils.image_io import PNG_SIGNATURE, decode_png

NVJPEG_BACKEND = ("DEFAULT", 0)  # nvjpegBackend_t NVJPEG_BACKEND_DEFAULT
# nvjpegOutputFormat_t
_NVJPEG_UNCHANGED, _NVJPEG_YUV, _NVJPEG_RGBI = 0, 1, 5
_PLANES = 4  # NVJPEG_MAX_COMPONENT: planes (and dims) a file at the binding
# (horizontal, vertical) subsamplings of a component that _upsample takes:
# 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1
_PLANE_FACTORS = ((1, 1), (2, 1), (2, 2), (1, 2), (4, 1))
JPEG_MAGIC = b"\xff\xd8"
JPEG_EOI = b"\xff\xd9"
# the float32 constant of the JAX package's u8 → [-1, 1] step
K_U8 = np.float32(2.0) / np.float32(255.0)

card_decoded = 0
card_single = 0
_count_lock = threading.Lock()

_NVJPEG_STATUS = {1: "not initialized", 2: "invalid parameter",
                  3: "bad JPEG", 4: "JPEG not supported",
                  5: "allocator failure", 6: "execution failed",
                  7: "architecture mismatch", 8: "internal error",
                  9: "implementation not supported",
                  10: "incomplete bitstream"}
_HOST_STATUS = {1: "libjpeg could not decode it",
                2: "corrupt or truncated data",
                3: "its size changed between header and decode"}


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def read_files(paths: Sequence[str]) -> List[bytes]:
    """The files' bytes (the host's part of a decode: the data feed calls
    it ahead, on its read thread). One thread: a pool of four read a batch
    no faster on the machine with the card (chip_smoke.py ``[data]
    tree``)."""
    return [_read(p) for p in paths]


def _ptrs(datas: Sequence[bytes]):
    n = len(datas)
    ptrs = (ctypes.c_char_p * n)(*datas)
    lens = (ctypes.c_uint64 * n)(*[len(d) for d in datas])
    return ptrs, lens


def _i32(n: int):
    return (ctypes.c_int32 * n)()


# --------------------------------------------------------------------------
# libjpeg on the host (the plain version)
# --------------------------------------------------------------------------

def _host_lib():
    from ..ops import _build

    lib = _build.load("jpeg_host")
    if lib.dmt_jpeg_host_decode.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int32
        lib.dmt_jpeg_host_info.argtypes = [vp, vp, i32, vp, vp, vp, vp]
        lib.dmt_jpeg_host_info.restype = None
        lib.dmt_jpeg_host_decode.argtypes = [vp, vp, i32, vp, vp, vp, vp,
                                             i32]
        lib.dmt_jpeg_host_decode.restype = None
    return lib


def _decode_jpeg_host(datas, names, num_threads: int) -> List[torch.Tensor]:
    lib = _host_lib()
    n = len(datas)
    ptrs, lens = _ptrs(datas)
    h, w, c, st = _i32(n), _i32(n), _i32(n), _i32(n)
    lib.dmt_jpeg_host_info(ptrs, lens, n, h, w, c, st)
    for i in range(n):
        if st[i]:
            raise ValueError(f"{names[i]}: libjpeg could not read the JPEG "
                             f"header")
    sizes = [h[i] * w[i] * 3 for i in range(n)]
    buf = torch.empty(sum(sizes), dtype=torch.uint8)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    outs = (ctypes.c_void_p * n)(*[buf.data_ptr() + int(o) for o in offs])
    lib.dmt_jpeg_host_decode(ptrs, lens, n, h, w, outs, st,
                             max(1, num_threads))
    for i in range(n):
        if st[i]:
            raise ValueError(f"{names[i]}: JPEG decode failed "
                             f"({_HOST_STATUS.get(st[i], st[i])})")
    return [buf[int(o):int(o) + s].view(h[i], w[i], 3)
            for i, (o, s) in enumerate(zip(offs, sizes))]


# --------------------------------------------------------------------------
# nvJPEG on the card
# --------------------------------------------------------------------------

def _card_lib():
    from ..ops import _build

    lib = _build.load("nvjpeg_decode")
    if lib.dmt_nvjpeg_decode.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int32
        lib.dmt_nvjpeg_open.argtypes = [i32]
        lib.dmt_nvjpeg_version.argtypes = [vp, vp, vp]
        lib.dmt_nvjpeg_info.argtypes = [vp, vp, i32, vp, vp, vp, vp]
        lib.dmt_nvjpeg_decode.argtypes = [vp, vp, i32, i32, vp, vp, vp, vp,
                                          vp]
        for fn in (lib.dmt_nvjpeg_open, lib.dmt_nvjpeg_version,
                   lib.dmt_nvjpeg_info, lib.dmt_nvjpeg_decode):
            fn.restype = ctypes.c_int
        rc = lib.dmt_nvjpeg_open(NVJPEG_BACKEND[1])
        if rc:
            raise RuntimeError(f"nvJPEG initialisation failed: "
                               f"{_status(rc)}")
    return lib


def _status(rc: int) -> str:
    if rc >= 1000:
        return f"CUDA error {rc - 1000}"
    return f"nvJPEG status {rc} ({_NVJPEG_STATUS.get(rc, '?')})"


def adobe_transform(data: bytes):
    """The transform byte of a JPEG's Adobe APP14 marker (0 CMYK or RGB, 1
    YCbCr, 2 YCCK), or None without one: how libjpeg tells a CMYK file from
    a YCCK one (jdapimin.c: 4 components with transform 0 are CMYK, any
    other transform YCCK, no marker CMYK)."""
    i = 2
    while i + 4 <= len(data) and data[i] == 0xFF:
        marker = data[i + 1]
        if marker == 0xDA:  # start of scan: the header is over
            break
        seg = int.from_bytes(data[i + 2:i + 4], "big")
        body = data[i + 4:i + 2 + seg]
        if marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            return body[11]
        i += 2 + seg
    return None


def _decode_jpeg_card(datas, names, device) -> List[torch.Tensor]:
    """nvJPEG on the card. Colour files come out as the IDCT's planes
    (three through NVJPEG_OUTPUT_YUV, the four of CMYK and YCCK through
    NVJPEG_OUTPUT_UNCHANGED) and go through :func:`ycc_to_rgb` or
    :func:`cmyk_to_rgb`, libjpeg's and PIL's own arithmetic; greyscale
    files, and colour files of a subsampling _upsample does not take, as
    nvJPEG's interleaved RGB."""
    global card_decoded, card_single
    lib = _card_lib()
    n = len(datas)
    ptrs, lens = _ptrs(datas)
    dims, c, css, st = _i32(2 * _PLANES * n), _i32(n), _i32(n), _i32(n)
    rc = lib.dmt_nvjpeg_info(ptrs, lens, n, dims, c, css, st)
    if rc:
        raise RuntimeError(f"nvJPEG: {_status(rc)}")
    # per file: its output format and its planes' (height, width)
    fmts, shapes, sizes = [], [], []
    for i in range(n):
        if st[i]:
            raise ValueError(f"{names[i]}: nvJPEG could not read the JPEG "
                             f"header ({_status(st[i])})")
        d = dims[2 * _PLANES * i:2 * _PLANES * (i + 1)]
        comps = [(d[2 * p], d[2 * p + 1]) for p in range(c[i])]
        hh, ww = comps[0]
        if c[i] == 4:
            # full-size planes, whatever the sampling: the component's
            # rows are read at its own size from a pitch of the width
            hh, ww = max(h for h, _ in comps), max(w for _, w in comps)
            fmts.append(_NVJPEG_UNCHANGED)
            shapes.append(comps)
            sizes.append(4 * hh * ww)
        elif c[i] == 3 and all(chroma_factors(hh, ww, h, w) in _PLANE_FACTORS
                               for h, w in comps[1:]):
            fmts.append(_NVJPEG_YUV)
            shapes.append(comps)
            sizes.append(sum(h * w for h, w in comps))
        elif c[i] in (1, 3):
            fmts.append(_NVJPEG_RGBI)
            shapes.append([(hh, ww)])
            sizes.append(3 * hh * ww)
        else:
            raise ValueError(f"{names[i]}: a JPEG of {c[i]} components is "
                             f"not decoded")
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    base = buf.data_ptr()
    stream = torch.cuda.current_stream(device).cuda_stream
    views: Dict[int, tuple] = {}
    single = 0
    for fmt in (_NVJPEG_YUV, _NVJPEG_UNCHANGED, _NVJPEG_RGBI):
        group = [i for i in range(n) if fmts[i] == fmt]
        if not group:
            continue
        outs = (ctypes.c_void_p * (_PLANES * len(group)))()
        pitches = _i32(_PLANES * len(group))
        for j, i in enumerate(group):
            o = int(offs[i])
            if fmt == _NVJPEG_RGBI:
                (h, w), = shapes[i]
                outs[_PLANES * j] = base + o
                pitches[_PLANES * j] = 3 * w
                views[i] = (buf[o:o + 3 * h * w].view(h, w, 3),)
                continue
            planes = []
            full = sizes[i] // 4
            ww = max(w for _, w in shapes[i])
            for p, (h, w) in enumerate(shapes[i]):
                if fmt == _NVJPEG_UNCHANGED:
                    start, pitch = o + p * full, ww
                else:
                    start, pitch = o, w
                    o += h * w
                outs[_PLANES * j + p] = base + start
                pitches[_PLANES * j + p] = pitch
                planes.append(buf[start:start + (h - 1) * pitch + w]
                              .as_strided((h, w), (pitch, 1)))
            views[i] = tuple(planes)
        gd = [datas[i] for i in group]
        gptrs, glens = _ptrs(gd)
        n_single, failed = ctypes.c_int32(0), ctypes.c_int32(-1)
        rc = lib.dmt_nvjpeg_decode(gptrs, glens, len(group), fmt, outs,
                                   pitches, stream, ctypes.byref(n_single),
                                   ctypes.byref(failed))
        if rc:
            where = names[group[failed.value]] if failed.value >= 0 else \
                f"one of {[names[i] for i in group]}"
            raise ValueError(f"{where}: JPEG decode on the card failed "
                             f"({_status(rc)})")
        single += n_single.value
    out: List = [None] * n
    by_shape: Dict[tuple, List[int]] = {}
    for i in range(n):
        if fmts[i] == _NVJPEG_RGBI:
            out[i] = views[i][0]
            continue
        ycck = fmts[i] == _NVJPEG_UNCHANGED and adobe_transform(datas[i]) \
            not in (None, 0)
        by_shape.setdefault((fmts[i], ycck, tuple(shapes[i])), []).append(i)
    for (fmt, ycck, _), idx in by_shape.items():
        planes = [torch.stack([views[i][p] for i in idx])
                  for p in range(len(views[idx[0]]))]
        rgb = ycc_to_rgb(*planes) if fmt == _NVJPEG_YUV else \
            cmyk_to_rgb(planes, ycck)
        for k, i in enumerate(idx):
            out[i] = rgb[k]
    with _count_lock:
        card_decoded += n
        card_single += single
    return out


def decoder_info(device) -> Dict[str, str]:
    """Which JPEG decoder serves ``device``: nvJPEG (its version and
    backend) on CUDA, libjpeg on the CPU. Builds and opens it."""
    if torch.device(device).type == "cuda":
        lib = _card_lib()
        v = _i32(3)
        rc = lib.dmt_nvjpeg_version(ctypes.byref(v, 0), ctypes.byref(v, 4),
                                    ctypes.byref(v, 8))
        if rc:
            raise RuntimeError(f"nvJPEG version: {_status(rc)}")
        return {"decoder": "nvjpeg", "version": f"{v[0]}.{v[1]}.{v[2]}",
                "backend": f"NVJPEG_BACKEND_{NVJPEG_BACKEND[0]}"}
    _host_lib()
    return {"decoder": "libjpeg", "version": "system", "backend": "host"}


# --------------------------------------------------------------------------
# libjpeg's colour path, on any device
# --------------------------------------------------------------------------

def _fix(x: float) -> int:  # libjpeg's FIX(): 16-bit fixed point
    return int(x * 65536 + 0.5)


def _ycc_tables() -> np.ndarray:
    """libjpeg's build_ycc_rgb_table (jdcolor.c): Cr→R, Cb→B rounded to
    integers, Cr→G and Cb→G (with ONE_HALF) in 16-bit fixed point."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    return np.stack([(_fix(1.40200) * x + half) >> 16,
                     (_fix(1.77200) * x + half) >> 16,
                     -_fix(0.71414) * x,
                     -_fix(0.34414) * x + half])


YCC_TABLES = _ycc_tables()


def _fancy_h2(s: torch.Tensor, bias_even: int, bias_odd: int,
              shift: int) -> torch.Tensor:
    """libjpeg's fancy horizontal 2× upsampling of the last axis:
    (3·nearer + further + bias) >> shift, the edge column as its own
    neighbour."""
    left = torch.cat([s[..., :1], s[..., :-1]], -1)
    right = torch.cat([s[..., 1:], s[..., -1:]], -1)
    even = (3 * s + left + bias_even) >> shift
    odd = (3 * s + right + bias_odd) >> shift
    return torch.stack([even, odd], -1).flatten(-2)


def _upsample(c: torch.Tensor, hf: int, vf: int) -> torch.Tensor:
    """libjpeg-turbo's upsampling (jdsample.c) of (G, h, w) components by
    (hf, vf) ∈ :data:`_PLANE_FACTORS`, in int32: fancy (triangle) filters
    for 2:1 horizontal, 2:1 both ways and 2:1 vertical, and plain
    replication for 4:1 horizontal (int_upsample: libjpeg has no fancy
    filter for it)."""
    c = c.to(torch.int32)
    if (hf, vf) == (1, 1):
        return c
    if (hf, vf) == (2, 1):  # h2v1_fancy_upsample
        return _fancy_h2(c, 1, 2, 2)
    if (hf, vf) == (4, 1):  # int_upsample
        return c.repeat_interleave(4, dim=-1)
    # the vertical pass of h2v2 and h1v2: 3·nearer row + further row, the
    # edge rows their own neighbours
    above = torch.cat([c[:, :1], c[:, :-1]], 1)
    below = torch.cat([c[:, 1:], c[:, -1:]], 1)
    if (hf, vf) == (1, 2):  # h1v2_fancy_upsample
        return torch.stack([(3 * c + above + 1) >> 2,
                            (3 * c + below + 2) >> 2], 2).flatten(1, 2)
    if (hf, vf) != (2, 2):
        raise ValueError(f"no upsampling for {hf}x{vf} (takes "
                         f"{_PLANE_FACTORS})")
    s = torch.stack([3 * c + above, 3 * c + below], 2).flatten(1, 2)
    return _fancy_h2(s, 8, 7, 4)  # h2v2_fancy_upsample


def chroma_factors(h: int, w: int, ch: int, cw: int) -> tuple:
    """The (horizontal, vertical) subsampling of a (ch, cw) plane of an
    (h, w) image: the least factor f of 1, 2, 4 with ceil(size / f) equal
    to the plane's size (libjpeg's downsampled_width), or the rounded ratio
    where none fits."""
    def factor(full: int, part: int) -> int:
        return next((f for f in (1, 2, 4) if -(-full // f) == part),
                    round(full / part))

    return factor(w, cw), factor(h, ch)


def _upsample_to(c: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    """(G, h, w) plane → (G, hh, ww) int32 through :func:`_upsample`."""
    hf, vf = chroma_factors(hh, ww, c.shape[1], c.shape[2])
    if (hf, vf) not in _PLANE_FACTORS:
        raise ValueError(f"chroma subsampling {hf}x{vf} is not taken "
                         f"({_PLANE_FACTORS})")
    return _upsample(c, hf, vf)[:, :hh, :ww]


def _ycc_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
             ) -> torch.Tensor:
    """Full-size int planes → (G, H, W, 3) int64 RGB by ycc_rgb_convert's
    fixed-point tables (jdcolor.c), range-limited."""
    tab = torch.from_numpy(YCC_TABLES).to(y.device)
    cbu, cru, yi = cb.long(), cr.long(), y.long()
    r = yi + tab[0][cru]
    gg = yi + ((tab[3][cbu] + tab[2][cru]) >> 16)
    b = yi + tab[1][cbu]
    return torch.stack([r, gg, b], -1).clamp_(0, 255)


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
               ) -> torch.Tensor:
    """(G, H, W) luma and (G, h, w) chroma planes, uint8, as a JPEG's IDCT
    leaves them → (G, H, W, 3) uint8 RGB by libjpeg's own path: upsampling
    (jdsample.c), then ycc_rgb_convert's fixed-point tables (jdcolor.c),
    range-limited. With libjpeg's planes this is libjpeg's decode exactly
    (tests/test_torch_port_data.py); the card feeds it nvJPEG's planes."""
    _, hh, ww = y.shape
    return _ycc_rgb(y, _upsample_to(cb, hh, ww),
                    _upsample_to(cr, hh, ww)).to(torch.uint8)


def cmyk_to_rgb(planes: Sequence[torch.Tensor], ycck: bool) -> torch.Tensor:
    """The four (G, h_i, w_i) uint8 planes of a CMYK or YCCK JPEG → (G, H,
    W, 3) uint8 RGB, as csrc/jpeg_host.cpp and PIL convert them: each plane
    upsampled to the image's size as libjpeg does; a YCCK file's first three
    through ycck_cmyk_convert (jdcolor.c: C = 255 − R of the YCC→RGB
    tables, likewise M and Y; K kept); then the CMYK read inverted
    (Adobe's convention, PIL's "CMYK;I") and converted by PIL's cmyk2rgb:
    v = CLIP8(nk − MULDIV255(255 − raw, nk)), nk the raw K."""
    hh = max(p.shape[1] for p in planes)
    ww = max(p.shape[2] for p in planes)
    up = [_upsample_to(p, hh, ww).long() for p in planes]
    raw = 255 - _ycc_rgb(*up[:3]) if ycck else torch.stack(up[:3], -1)
    nk = up[3].unsqueeze(-1)
    tmp = (255 - raw) * nk + 128
    return (nk - (((tmp >> 8) + tmp) >> 8)).clamp_(0, 255).to(torch.uint8)


# --------------------------------------------------------------------------
# decode by file type
# --------------------------------------------------------------------------

def decode(datas: Sequence[bytes], names: Sequence[str], device,
           num_threads: int = 0) -> List[torch.Tensor]:
    """Files in memory → (H, W, 3) uint8 RGB tensors on ``device`` at their
    native size: JPEGs through the device's decoder, PNGs through
    ``decode_png`` on the host. ``names`` name the files in errors."""
    device = torch.device(device)
    out: List = [None] * len(datas)
    jpegs = []
    for i, d in enumerate(datas):
        if d[:2] == JPEG_MAGIC:
            if JPEG_EOI not in d[-32:]:
                raise ValueError(f"{names[i]}: truncated JPEG (no "
                                 f"end-of-image marker)")
            jpegs.append(i)
        elif d[:8] == PNG_SIGNATURE:
            out[i] = torch.from_numpy(decode_png(d, names[i])).to(device)
        else:
            raise ValueError(f"{names[i]}: neither a JPEG nor a PNG file "
                             f"(the port's decoders read those two)")
    if jpegs:
        jd = [datas[i] for i in jpegs]
        jn = [names[i] for i in jpegs]
        imgs = (_decode_jpeg_card(jd, jn, device) if device.type == "cuda"
                else _decode_jpeg_host(jd, jn,
                                       num_threads or (os.cpu_count() or 1)))
        for i, img in zip(jpegs, imgs):
            out[i] = img
    return out


# --------------------------------------------------------------------------
# the resize
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def filter_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 weights of PIL's antialiased bilinear
    filter, built as ``build_filter`` (native/preprocess.cpp:39-71) builds
    its table: row i holds output i's taps at their source columns."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        t = np.abs((np.arange(xmin, xmax) + 0.5 - center) / filterscale)
        w = np.where(t < 1.0, 1.0 - t, 0.0)  # float64
        total = w.sum()
        w32 = w.astype(np.float32)
        if total > 0.0:
            w32 = w32 / np.float32(total)
        m[i, xmin:xmax] = w32
    return m


@functools.lru_cache(maxsize=64)
def _weights(in_size: int, out_size: int, device: torch.device
             ) -> torch.Tensor:
    return torch.from_numpy(filter_matrix(in_size, out_size)).to(device)


@contextlib.contextmanager
def _tf32_off():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def snap_u8(acc: torch.Tensor) -> torch.Tensor:
    """Resized float32 pixels in [0, 255] → uint8, by the JAX package's
    float32 sequence (x = acc·k − 1, then rint((x + 1)·127.5), clipped)."""
    x = acc * float(K_U8) - 1.0
    return torch.round((x + 1.0) * 127.5).clamp_(0, 255).to(torch.uint8)


def resize_u8(images: Sequence[torch.Tensor], out_size: int) -> torch.Tensor:
    """(H, W, C) uint8 images of any sizes, all on one device →
    (N, out_size, out_size, C) uint8 on that device, resized with PIL's
    antialiased bilinear filter, one pair of products per size."""
    if not images:
        raise ValueError("resize_u8: no images")
    device = images[0].device
    c = images[0].shape[2]
    out = torch.empty((len(images), out_size, out_size, c), dtype=torch.uint8,
                      device=device)
    groups: Dict[tuple, List[int]] = {}
    for i, im in enumerate(images):
        if im.dim() != 3 or im.shape[2] != c or im.dtype != torch.uint8:
            raise ValueError(f"resize_u8: image {i} is {im.dtype} "
                             f"{tuple(im.shape)}, expected uint8 (H, W, {c})")
        groups.setdefault(tuple(im.shape[:2]), []).append(i)
    with _tf32_off():
        for (h, w), idx in groups.items():
            x = torch.stack([images[i] for i in idx]).permute(0, 3, 1, 2)
            x = x.float()  # (G, C, H, W)
            t = torch.matmul(x, _weights(w, out_size, device).t())
            acc = torch.matmul(_weights(h, out_size, device), t)
            y = snap_u8(acc).permute(0, 2, 3, 1)
            if len(idx) == len(images):
                out.copy_(y)
            else:
                out[torch.as_tensor(idx, device=device)] = y
    return out


def decode_resize(datas: Sequence[bytes], names: Sequence[str],
                  out_size: int, device, num_threads: int = 0
                  ) -> torch.Tensor:
    """Files in memory → (N, out_size, out_size, 3) uint8 on ``device``:
    :func:`decode`, then :func:`resize_u8`; spans ``dmt.feed.decode`` with
    ``.nvjpeg`` (the decoder: nvJPEG on the card, libjpeg on the CPU) and
    ``.resize`` inside."""
    with runtime.span("dmt.feed.decode"):
        with runtime.span("dmt.feed.decode.nvjpeg"):
            images = decode(datas, names, device, num_threads)
        with runtime.span("dmt.feed.decode.resize"):
            return resize_u8(images, out_size)
