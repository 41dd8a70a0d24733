"""The port's real-image data feed (disentangle_mlp_tpu_torch: data/native.py,
data/pipeline.py, utils/image_io.read_png, eval/fid.statistics_from_dir,
the trainer on an image folder) against the JAX package's, on the CPU.

Tolerances, and why:

- The resize: the port applies PIL's antialiased bilinear table as two
  float32 products, the JAX package's native resize sums the same float32
  weights in sequence; only the summation order differs, so after the same
  float32 snap to uint8 a pixel moves by at most 1 grey level, and at
  least 99.9 % of pixels are exact (RESIZE_MAX_DIFF, RESIZE_EXACT).
- The host JPEG decode is libjpeg with the JAX package's settings, so the
  decoded pixels are equal byte for byte; the folder source's uint8
  batches inherit the resize's bar, and its float batches are those uint8
  values normalized, within 2/255 + 1 ulp.
- MNIST at 28×28 is not resized: equal. At 32 the port's float filter
  meets PIL's fixed-point bilinear (which rounds between its passes):
  within 1 grey level.
- The uint8 feed normalizes with the host path's float32 operations one by
  one: equal to the float path within 1 ulp.
- Statistics of a directory: pool3 of two frameworks on one Inception tree
  (rtol 2e-3, atol 2e-4, tests/test_torch_port_inception.py) carried
  through μ and Σ, as tests/test_torch_port_fid.py holds the dataset
  statistics builder.

The committed fixture (disentangle_mlp_tpu_torch/data/fixtures/) holds 16
CelebA-sized JPEGs made with PIL, the JAX package's 64×64 ``load_batch_u8``
of them and PIL's full-resolution decode of four; the card's decoder is
held against it (chip_smoke.py ``[data] fixture``, and the ``cuda`` cases
of tests/test_torch_port_data_cuda.py). It is written by
:func:`write_fixture`, and its colour-space and subsampling files (CMYK,
YCCK, 4:4:0, 4:1:1, with their host decodes) by
:func:`write_color_fixture`:

    JAX_PLATFORMS=cpu python -m tests.test_torch_port_data --write-fixture
    JAX_PLATFORMS=cpu python -m tests.test_torch_port_data \
        --write-color-fixture
"""

import gc
import gzip
import io
import struct
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from disentangle_mlp_tpu.config import Config as JaxConfig
from disentangle_mlp_tpu.data import native as jax_native
from disentangle_mlp_tpu.data import pipeline as jax_pl
from disentangle_mlp_tpu.eval import fid as jax_fid
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.data import native
from disentangle_mlp_tpu_torch.data import pipeline as pl
from disentangle_mlp_tpu_torch.eval import fid as port_fid
from disentangle_mlp_tpu_torch.utils import image_io
from tests.test_torch_port_data_cuda import (COLOR_FIXTURE, FIXTURE,
                                            color_fixture, fixture_paths)

RESIZE_MAX_DIFF = 1
RESIZE_EXACT = 0.999
PM1_STEP = 2.0 / 255.0


# --------------------------------------------------------------------------
# images written with PIL
# --------------------------------------------------------------------------

def _lf_image(i: int, size=(178, 218)) -> Image.Image:
    """The SyntheticSource low-frequency basis rendered at 64×64 and
    upsampled, as benchmarks/gen_jpeg_tree.py --basis lf makes it."""
    src = jax_pl.SyntheticSource(size=i + 1, img_size=64, seed=0)
    x = src._materialize(np.array([i]))[0]
    small = ((x + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    return Image.fromarray(small).resize(size, Image.BILINEAR)


def _sharp_image(i: int, size=(178, 218), block: int = 8) -> Image.Image:
    """8×-downsampled noise upsampled (gen_jpeg_tree.py --basis block8):
    sharper colour edges than the low-frequency basis."""
    rng = np.random.default_rng(i)
    small = rng.integers(0, 256, size=(size[1] // block, size[0] // block, 3),
                         dtype=np.uint8)
    return Image.fromarray(small).resize(size, Image.BILINEAR)


def write_fixture(out: Path = FIXTURE) -> None:
    """The committed fixture: 12 low-frequency and 2 sharper baseline 4:2:0
    JPEGs, one greyscale and one progressive, at 178×218 (quality 90), under
    ``jpeg/c0/``; ``expected.npz`` with the JAX package's
    ``ImageFolderSource.load_batch_u8`` of all 16 at 64×64 (``names``,
    ``u8_64``) and PIL's full-resolution decode of four (``full_names``,
    ``full``)."""
    d = out / "jpeg" / "c0"
    d.mkdir(parents=True, exist_ok=True)
    for f in d.glob("*.jpg"):
        f.unlink()
    for i in range(12):
        _lf_image(i).save(d / f"lf_{i:02d}.jpg", quality=90)
    for i in range(2):
        _sharp_image(i).save(d / f"sharp_{i:02d}.jpg", quality=90)
    _lf_image(12).convert("L").save(d / "grey.jpg", quality=90)
    _lf_image(13).save(d / "progressive.jpg", quality=90, progressive=True)
    names, u8 = _jax_fixture_u8(out)
    full_names = ["grey.jpg", "lf_00.jpg", "progressive.jpg", "sharp_00.jpg"]
    full = np.stack([np.asarray(Image.open(d / n).convert("RGB"))
                     for n in full_names])
    np.savez_compressed(out / "expected.npz", names=np.array(names), u8_64=u8,
                        full_names=np.array(full_names), full=full)


# J_COLOR_SPACE of libjpeg, and sampling factors (h, v) per component
JCS_YCBCR, JCS_CMYK, JCS_YCCK = 3, 4, 5
COLOR_FILES = {  # name: (libjpeg colour space, factors); cmyk.jpg is PIL's
    "ycck.jpg": (JCS_YCCK, (2, 2, 1, 1, 1, 1, 1, 1)),
    "s440.jpg": (JCS_YCBCR, (1, 2, 1, 1, 1, 1)),
    "s411.jpg": (JCS_YCBCR, (4, 1, 1, 1, 1, 1)),
}
COLOR_SIZE = (101, 77)  # (width, height): odd, so every plane has an edge


def host_encode(pixels: np.ndarray, jpeg_space: int, factors,
                quality: int = 90) -> bytes:
    """A JPEG of (H, W, 3) RGB or (H, W, 4) CMYK uint8 pixels in libjpeg's
    ``jpeg_space`` with the given sampling factors, written by
    csrc/jpeg_host.cpp's dmt_jpeg_host_encode (libjpeg)."""
    import ctypes

    lib = native._host_lib()
    enc, free = lib.dmt_jpeg_host_encode, lib.dmt_jpeg_host_free
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    enc.argtypes = [vp, i32, i32, i32, i32, vp, i32, vp, vp]
    enc.restype = i32
    free.argtypes, free.restype = [vp], None
    px = np.ascontiguousarray(pixels, np.uint8)
    f = (ctypes.c_int32 * len(factors))(*factors)
    out, n = ctypes.c_void_p(), ctypes.c_uint64()
    assert enc(px.ctypes.data, px.shape[0], px.shape[1], px.shape[2],
               jpeg_space, f, quality, ctypes.byref(out),
               ctypes.byref(n)) == 0
    try:
        return ctypes.string_at(out, n.value)
    finally:
        free(out)


def _cmyk_pixels(size=COLOR_SIZE) -> np.ndarray:
    """Smooth CMYK with every ink, black included, varying across the
    image (PIL's RGB→CMYK leaves K at 0)."""
    rgb = np.asarray(_sharp_image(3, size, block=4)).astype(np.int32)
    k = np.asarray(_sharp_image(4, size, block=8))[..., :1].astype(np.int32)
    return np.concatenate([255 - rgb, k // 2], -1).astype(np.uint8)


def write_color_fixture(out: Path = FIXTURE) -> None:
    """The colour-space and subsampling files under ``jpeg_color/``: a
    CMYK file written by PIL (Adobe's inverted CMYK), and with libjpeg a
    YCCK file of the same inks (4:2:0 on Y, Cb, Cr and K) and 4:4:0 and
    4:1:1 files of an RGB image; ``expected_color.npz`` with their host
    decodes (``names``, ``full``), which for the CMYK pair equal PIL's."""
    out.joinpath("jpeg_color").mkdir(parents=True, exist_ok=True)
    cmyk = _cmyk_pixels()
    Image.fromarray(cmyk, "CMYK").save(COLOR_FIXTURE / "cmyk.jpg",
                                       quality=90)
    rgb = np.asarray(_sharp_image(5, COLOR_SIZE, block=2))
    for name, (space, factors) in COLOR_FILES.items():
        # libjpeg takes CMYK as stored: inverted, as PIL writes it
        px = 255 - cmyk if space == JCS_YCCK else rgb
        (COLOR_FIXTURE / name).write_bytes(host_encode(px, space, factors))
    names = ["cmyk.jpg", *COLOR_FILES]
    paths = [str(COLOR_FIXTURE / n) for n in names]
    full = np.stack([d.numpy() for d in native.decode(
        native.read_files(paths), paths, "cpu")])
    np.savez_compressed(out / "expected_color.npz", names=np.array(names),
                        full=full)


def _jax_fixture_u8(root: Path):
    src = jax_pl.ImageFolderSource(str(root / "jpeg"), img_size=64,
                                   cache="off")
    names = [Path(p).name for p, _ in src.samples]
    return names, src.load_batch_u8(np.arange(len(src)))[0]


def _jpeg_tree(tmp_path, n_per_class=3):
    """Two classes of JPEGs written with PIL: low-frequency and sharper
    RGB at two sizes (4:2:0, 4:4:4), a greyscale and a progressive file."""
    root = tmp_path / "jpeg_tree"
    for c, cls in enumerate(["a", "b"]):
        (root / cls).mkdir(parents=True)
        for i in range(n_per_class):
            k = 10 * c + i
            img = _lf_image(k, (53, 61)) if i % 2 else _sharp_image(k,
                                                                    (53, 61))
            img.save(root / cls / f"{i}.jpg", quality=85,
                     subsampling=2 if i % 2 else 0)
    _lf_image(30, (40, 36)).convert("L").save(root / "a" / "grey.jpg")
    _lf_image(31, (40, 36)).save(root / "b" / "prog.jpg", progressive=True)
    return str(root)


def _png_tree(tmp_path, n_per_class=3):
    """Two classes of PNGs written with PIL in every colour type."""
    root = tmp_path / "png_tree"
    modes = ["RGB", "L", "P", "LA", "RGBA"]
    for c, cls in enumerate(["a", "b"]):
        (root / cls).mkdir(parents=True)
        for i in range(n_per_class):
            base = _sharp_image(20 * c + i, (45, 38), block=4)
            mode = modes[(3 * c + i) % len(modes)]
            if mode == "P":
                img = base.quantize(50)
            elif mode in ("LA", "RGBA"):
                img = base.convert(mode)
            else:
                img = base.convert(mode)
            img.save(root / cls / f"{i}.png")
    return str(root)


def _u8_close(got: np.ndarray, want: np.ndarray, max_diff=RESIZE_MAX_DIFF,
              exact=RESIZE_EXACT):
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= max_diff, d.max()
    assert (d == 0).mean() >= exact, (d == 0).mean()


# --------------------------------------------------------------------------
# read_png
# --------------------------------------------------------------------------

def _filtered_png(arr: np.ndarray, ctype: int, palette=None) -> bytes:
    """A PNG whose row y uses filter y % 5 (None, Sub, Up, Average, Paeth),
    encoded here so that every filter is exercised."""
    h, w = arr.shape[:2]
    bpp = 1 if arr.ndim == 2 else arr.shape[2]
    rows = arr.reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    prior = np.zeros(w * bpp, np.int64)
    for y in range(h):
        kind, cur = y % 5, rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - prior
        elif kind == 3:
            f = cur - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
            f = cur - pred
        out.append(kind)
        out += (f & 0xFF).astype(np.uint8).tobytes()
        prior = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    png = image_io.PNG_SIGNATURE + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        png += chunk(b"PLTE", palette.tobytes())
    return png + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND",
                                                                   b"")


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
def test_port_read_png_matches_pil_for_every_color_type_and_filter(
        tmp_path, mode):
    rng = np.random.default_rng(1)
    rgba = np.cumsum(rng.integers(0, 40, (17, 23, 4)), axis=1).astype(
        np.uint8)
    ctype = {"L": 0, "RGB": 2, "P": 3, "LA": 4, "RGBA": 6}[mode]
    arr = {"L": rgba[..., 0], "RGB": rgba[..., :3], "P": rgba[..., 0] % 40,
           "LA": rgba[..., :2], "RGBA": rgba}[mode]
    palette = rng.integers(0, 256, (40, 3)).astype(np.uint8) \
        if mode == "P" else None
    files = {"filters": _filtered_png(arr, ctype, palette)}
    pil = Image.fromarray(arr, "L" if mode == "P" else mode)
    if mode == "P":
        pil = pil.convert("P")
        pil.putpalette(palette.reshape(-1).tolist())
    buf = io.BytesIO()
    pil.save(buf, "PNG", optimize=True)  # PIL's own filter choice
    files["pil"] = buf.getvalue()
    for name, data in files.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        got = image_io.read_png(str(path))
        want = np.asarray(Image.open(path).convert("RGB"))
        assert got.dtype == np.uint8 and got.shape == want.shape + () \
            and got.shape[2] == 3
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3])
def test_port_read_png_round_trips_write_png(tmp_path, channels):
    rng = np.random.default_rng(channels)
    arr = rng.integers(0, 256, (9, 14, channels), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    image_io.write_png(path, arr)
    np.testing.assert_array_equal(image_io.read_png(path),
                                  np.repeat(arr, 3 // channels, axis=2))


def test_port_read_png_refuses_what_it_cannot_read(tmp_path):
    rng = np.random.default_rng(0)
    good = tmp_path / "good.png"
    image_io.write_png(str(good), rng.integers(0, 256, (6, 5, 3),
                                               dtype=np.uint8))
    data = good.read_bytes()
    bad = {"truncated.png": data[:len(data) - 20],
           "crc.png": data[:40] + bytes([data[40] ^ 1]) + data[41:],
           "notpng.png": b"GIF89a" + data[6:]}
    for bits, interlace, name in ((16, 0, "deep.png"), (8, 1, "adam7.png")):
        ihdr = struct.pack(">IIBBBBB", 5, 6, bits, 2, 0, 0, interlace)
        body = b"IHDR" + ihdr
        bad[name] = (data[:8] + struct.pack(">I", 13) + body
                     + struct.pack(">I", zlib.crc32(body)) + data[33:])
    for name, content in bad.items():
        (tmp_path / name).write_bytes(content)
        with pytest.raises(ValueError, match=name):
            image_io.read_png(str(tmp_path / name))


# --------------------------------------------------------------------------
# the resize and the host decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h, w, out", [(218, 178, 64), (64, 64, 64),
                                       (37, 53, 64), (28, 28, 64)])
def test_port_resize_matches_jax_native_resize(h, w, out):
    """Seeded random uint8 images through the port's resize and through
    the JAX package's native resize + _pm1_to_u8. The difference from the
    PIL path (_decode_resize) is reported, not gated: PIL rounds between
    its two passes."""
    rng = np.random.default_rng(h * w)
    imgs = rng.integers(0, 256, (6, h, w, 3), dtype=np.uint8)
    got = native.resize_u8(list(torch.from_numpy(imgs)), out).numpy()
    want = jax_pl.ImageFolderSource._pm1_to_u8(
        jax_native.resize_normalize_batch(list(imgs), out))
    _u8_close(got, want)
    pil = np.stack([np.asarray(Image.fromarray(im).resize(
        (out, out), Image.BILINEAR)) for im in imgs])
    d = np.abs(got.astype(int) - pil)
    print(f"[resize] {h}x{w}->{out}: vs PIL max {d.max()}, exact "
          f"{(d == 0).mean():.4f}")


def test_port_resize_groups_mixed_sizes_and_keeps_order():
    rng = np.random.default_rng(3)
    imgs = [torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
            for s in [(20, 30, 3), (31, 17, 3), (20, 30, 3), (9, 9, 3)]]
    got = native.resize_u8(imgs, 12)
    for i, im in enumerate(imgs):
        assert torch.equal(got[i], native.resize_u8([im], 12)[0])
    with pytest.raises(ValueError, match="image 1"):
        native.resize_u8([imgs[0], imgs[1][..., :1]], 12)


def test_port_host_jpeg_decode_equals_pil_byte_for_byte(tmp_path):
    """libjpeg with the JAX package's settings (JCS_RGB, default IDCT and
    upsampling) equals PIL's decode, greyscale, progressive, 4:4:4 and
    CMYK files included."""
    root = Path(_jpeg_tree(tmp_path))
    img = _sharp_image(5, (33, 47))
    img.convert("CMYK").save(root / "a" / "cmyk.jpg")
    paths = sorted(str(p) for p in root.rglob("*.jpg"))
    got = native.decode(native.read_files(paths), paths, "cpu")
    for p, g in zip(paths, got):
        want = np.asarray(Image.open(p).convert("RGB"))
        np.testing.assert_array_equal(g.numpy(), want, err_msg=p)


def _libjpeg_planes(data: bytes):
    """libjpeg's component planes before upsampling (raw_data_out),
    through csrc/jpeg_host.cpp's dmt_jpeg_host_planes."""
    import ctypes

    fn = native._host_lib().dmt_jpeg_host_planes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int32
    nc, dims = ctypes.c_int32(), (ctypes.c_int32 * 8)()
    assert fn(data, len(data), ctypes.byref(nc), dims, None) == 0
    outs = [np.empty((dims[2 * i], dims[2 * i + 1]), np.uint8)
            for i in range(nc.value)]
    ptrs = (ctypes.c_void_p * 4)(*[o.ctypes.data for o in outs])
    assert fn(data, len(data), ctypes.byref(nc), dims, ptrs) == 0
    return [torch.from_numpy(o)[None] for o in outs]


@pytest.mark.parametrize("size, subsampling, progressive", [
    ((178, 218), 2, False), ((178, 218), 2, True), ((178, 218), 1, False),
    ((178, 218), 0, False), ((37, 53), 2, False), ((37, 53), 1, False),
    ((9, 7), 2, False)])
def test_port_ycc_to_rgb_is_libjpegs_color_path(size, subsampling,
                                                progressive):
    """The card's colour path (fancy upsampling and jdcolor.c's tables in
    torch) on libjpeg's own planes gives libjpeg's RGB decode exactly, at
    4:2:0, 4:2:2 and 4:4:4, odd sizes and a progressive file included."""
    buf = io.BytesIO()
    _sharp_image(size[0], size, block=2).save(
        buf, "JPEG", quality=90, subsampling=subsampling,
        progressive=progressive)
    data = buf.getvalue()
    y, cb, cr = _libjpeg_planes(data)
    got = native.ycc_to_rgb(y, cb, cr)[0].numpy()
    np.testing.assert_array_equal(got, native.decode([data], ["x"], "cpu")[0])


def _small_440_411():
    """4:4:0 and 4:1:1 files at odd sizes, down to a 3-sample plane."""
    out = {}
    for size in ((37, 53), (9, 7)):
        rgb = np.asarray(_sharp_image(size[0], size, block=2))
        for name in ("s440.jpg", "s411.jpg"):
            space, factors = COLOR_FILES[name]
            out[f"{name[:-4]} {size}"] = host_encode(rgb, space, factors)
    return out


@pytest.mark.parametrize("name", ["cmyk.jpg", *COLOR_FILES, "s440 (37, 53)",
                                  "s440 (9, 7)", "s411 (37, 53)",
                                  "s411 (9, 7)"])
def test_port_card_color_path_is_libjpegs_on_every_sampling_and_cmyk(name):
    """ycc_to_rgb at 4:4:0 and 4:1:1 and cmyk_to_rgb on CMYK and YCCK,
    fed libjpeg's own planes, give the host decode exactly (libjpeg's, and
    PIL's for CMYK: the fixture guard below)."""
    if name.endswith(".jpg"):
        data = (COLOR_FIXTURE / name).read_bytes()
    else:
        data = _small_440_411()[name]
    planes = _libjpeg_planes(data)
    if len(planes) == 4:
        got = native.cmyk_to_rgb(planes, native.adobe_transform(data) == 2)
    else:
        got = native.ycc_to_rgb(*planes)
    np.testing.assert_array_equal(got[0].numpy(),
                                  native.decode([data], [name], "cpu")[0])


def test_port_damaged_jpeg_raises_with_its_name(tmp_path):
    """A truncated or corrupt file raises naming the file, on the CPU path
    (the card's: tests/test_torch_port_data_cuda.py); never a grey fill."""
    buf = io.BytesIO()
    _lf_image(0).save(buf, "JPEG", quality=90)
    data = buf.getvalue()
    cases = {"cut.jpg": data[:len(data) // 2],
             "cut_then_eoi.jpg": data[:len(data) // 2] + b"\xff\xd9",
             "not_an_image.jpg": b"hello world"}
    for name, content in cases.items():
        path = str(tmp_path / name)
        Path(path).write_bytes(content)
        with pytest.raises(ValueError, match=name):
            native.decode(native.read_files([path]), [path], "cpu")


def test_port_decoder_is_picked_by_the_device():
    assert native.decoder_info("cpu")["decoder"] == "libjpeg"
    assert float(native.K_U8) == float(np.float32(2.0 / 255.0))


# --------------------------------------------------------------------------
# the folder source
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["jpeg", "png"])
@pytest.mark.parametrize("cache", ["on", "off"])
def test_port_image_folder_source_matches_jax(tmp_path, kind, cache):
    root = (_jpeg_tree if kind == "jpeg" else _png_tree)(tmp_path)
    js = jax_pl.ImageFolderSource(root, img_size=32, num_workers=2,
                                  cache="off")
    ts = pl.ImageFolderSource(root, img_size=32, num_workers=2, cache=cache,
                              device="cpu")
    assert ts.samples == js.samples and ts.class_to_idx == js.class_to_idx
    idx = np.random.default_rng(2).permutation(len(ts))
    xu, yu = ts.load_batch_u8(idx)
    xj, yj = js.load_batch_u8(idx)
    assert xu.device.type == "cpu" and xu.dtype == torch.uint8
    _u8_close(xu.numpy(), xj)
    np.testing.assert_array_equal(yu, yj)
    xf, yf = ts.load_batch(idx)
    xjf, yjf = js.load_batch(idx)
    assert xf.dtype == np.float32 and xf.shape == xjf.shape
    np.testing.assert_allclose(xf, xjf, rtol=0, atol=PM1_STEP + 1.2e-7)
    np.testing.assert_array_equal(yf, yjf)


def test_port_decode_cache_serves_later_epochs(tmp_path, monkeypatch):
    """Epochs 2+ come from the uint8 cache (no decode) and equal the
    uncached path; a cold cache touched with a subset decodes only it;
    "auto" respects the size gate (tests/test_pipeline.py's cache test)."""
    root = _png_tree(tmp_path)
    off = pl.ImageFolderSource(root, img_size=32, cache="off", device="cpu")
    assert off._cache is None
    x_off, y_off = off.load_batch(np.arange(6))

    on = pl.ImageFolderSource(root, img_size=32, cache="on", device="cpu")
    calls = []
    real = on._decode_u8
    on._decode_u8 = lambda idx, datas=None: (
        calls.append(np.asarray(idx).tolist()), real(idx, datas))[1]
    x1, y1 = on.load_batch(np.arange(6))
    x2, _ = on.load_batch(np.arange(6))
    x3, _ = on.load_batch(np.array([4, 1]))
    assert calls == [[0, 1, 2, 3, 4, 5]], "later epochs must not decode"
    assert on.decoded == 6 and on._cache.device.type == "cpu"
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(x3, x1[[4, 1]])
    np.testing.assert_array_equal(x1, x_off)
    np.testing.assert_array_equal(y1, y_off)

    on2 = pl.ImageFolderSource(root, img_size=32, cache="on", device="cpu")
    on2.load_batch(np.array([2, 5]))
    assert on2._cached.sum() == 2 and on2.decoded == 2
    xa, _ = on2.load_batch(np.arange(6))
    assert on2.decoded == 6
    np.testing.assert_array_equal(xa, x_off)

    monkeypatch.setattr(pl, "_DECODE_CACHE_LIMIT", 10)
    assert pl.ImageFolderSource(root, img_size=32, device="cpu")._cache \
        is None
    monkeypatch.setattr(pl, "_DECODE_CACHE_LIMIT", 10 ** 9)
    assert pl.ImageFolderSource(root, img_size=32, device="cpu")._cache \
        is not None


def test_port_cache_flag_validated_and_train_only(tmp_path):
    root = _png_tree(tmp_path)
    with pytest.raises(ValueError, match="auto/on/off"):
        pl.ImageFolderSource(root, img_size=32, cache="On", device="cpu")
    cfg = Config(name="t", cache_decoded="on", img_size=32,
                 batch_size_train=4, batch_size_val=4, batch_size_test=2,
                 image_root_train=root, image_root_val=root,
                 image_root_test=root, save_path=str(tmp_path / "%"),
                 log_path=str(tmp_path / "%/log")).finalize()
    train, val, test = pl.get_data_loader(cfg, device="cpu")
    assert train.source._cache is not None
    assert val.source._cache is None and test.source._cache is None


def test_port_decode_cache_budget_is_global(tmp_path, monkeypatch):
    root = tmp_path / "imgs" / "cls"
    root.mkdir(parents=True)
    for i in range(4):
        Image.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(
            root / f"{i}.jpg")
    gc.collect()  # release the claims of dead sources
    per_source = 4 * 8 * 8 * 3
    baseline = pl._decode_cache_live_bytes
    monkeypatch.setattr(pl, "_DECODE_CACHE_LIMIT",
                        baseline + int(per_source * 1.5))
    a = pl.ImageFolderSource(str(root.parent), img_size=8, device="cpu")
    b = pl.ImageFolderSource(str(root.parent), img_size=8, device="cpu")
    assert a._cache is not None, "the first source fits the budget"
    assert b._cache is None, "the second must not exceed it"
    assert pl._decode_cache_live_bytes == baseline + per_source
    c = pl.ImageFolderSource(str(root.parent), img_size=8, cache="on",
                             device="cpu")
    assert c._cache is not None  # 'on' is honoured past the budget
    del a, b, c
    gc.collect()
    assert pl._decode_cache_live_bytes == baseline


def test_port_cache_warmup_fills_epoch_order(tmp_path):
    """The warmer decodes the next epoch's order into the cache; the
    warmed epoch equals an uncached loader's and decodes nothing."""
    root = _png_tree(tmp_path)
    src = pl.ImageFolderSource(root, img_size=32, cache="on", device="cpu")
    loader = pl.DataLoader(src, batch_size=2, shuffle=True, seed=3,
                           device="cpu")
    t = loader.start_cache_warmup()
    assert t is not None
    t.join(60)
    assert not t.is_alive() and src._cached.all()
    assert src.start_cache_warmup() is not None
    src._warm_thread.join(60)
    ref = pl.DataLoader(pl.ImageFolderSource(root, img_size=32, cache="off",
                                             device="cpu"),
                        batch_size=2, shuffle=True, seed=3, device="cpu")
    before = src.decoded
    for (x, y), (xr, yr) in zip(loader, ref):
        assert torch.equal(x, xr) and torch.equal(y, yr)
    assert src.decoded == before, "a warmed epoch must not decode"


def test_port_cache_warmup_noops(tmp_path, monkeypatch):
    root = _png_tree(tmp_path)
    off = pl.ImageFolderSource(root, img_size=32, cache="off", device="cpu")
    assert pl.DataLoader(off, 2, device="cpu").start_cache_warmup() is None
    synth = pl.SyntheticSource(size=8, img_size=8)
    assert pl.DataLoader(synth, 2, device="cpu").start_cache_warmup() is None
    on = pl.ImageFolderSource(root, img_size=32, cache="on", device="cpu")
    monkeypatch.setenv("DMT_DECODE_WARMUP", "0")
    assert pl.DataLoader(on, 2, device="cpu").start_cache_warmup() is None


# --------------------------------------------------------------------------
# the loader
# --------------------------------------------------------------------------

def _mnist_files(root: Path, n: int = 10, gz: bool = False, seed: int = 0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    root.mkdir(parents=True, exist_ok=True)
    opener, sfx = (gzip.open, ".gz") if gz else (open, "")
    with opener(root / f"train-images-idx3-ubyte{sfx}", "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 3) + struct.pack(">3I", n, 28, 28)
                + imgs.tobytes())
    with opener(root / f"train-labels-idx1-ubyte{sfx}", "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 1) + struct.pack(">I", n)
                + labels.tobytes())
    return imgs, labels


@pytest.mark.parametrize("dataset", ["celebA", "birds", "mnist"])
def test_port_u8_feed_matches_float_path(tmp_path, dataset):
    """The loader's uint8 feed (normalize on the device) against the
    source's float path, per dataset normalization. The folder source's
    float path is the same float32 operations: within 1 ulp. MNIST's float
    path is the reference's (u/255 − mean)/std, which the feed's affine
    composes in another order, as the JAX package's feed does: within 2
    ulps of the largest value."""
    if dataset == "mnist":
        _mnist_files(tmp_path / "mnist")
        src = pl.MNISTSource(str(tmp_path / "mnist"), img_size=32)
    else:
        src = pl.ImageFolderSource(_jpeg_tree(tmp_path), img_size=32,
                                   cache="off", device="cpu",
                                   normalize=pl.NORMALIZE[dataset])
    loader = pl.DataLoader(src, batch_size=4, shuffle=False, device="cpu")
    for i, (x, y) in enumerate(loader):
        want, yw = src.load_batch(np.arange(4 * i, 4 * i + 4))
        assert x.dtype == torch.float32 and y.dtype == torch.int32
        ulps = 2 if dataset == "mnist" else 1
        np.testing.assert_allclose(
            x.numpy(), want, rtol=0,
            atol=ulps * np.spacing(np.abs(want).max()))
        np.testing.assert_array_equal(y.numpy(), yw)


def test_port_loader_epochs_equal_jax_loader(tmp_path):
    """Two shuffled epochs of a PNG tree through both packages' loaders:
    the same permutation (labels and images), images within the resize's
    bar."""
    root = _png_tree(tmp_path)
    jl = jax_pl.DataLoader(jax_pl.ImageFolderSource(root, img_size=32,
                                                    cache="on"),
                           batch_size=2, shuffle=True, seed=7,
                           process_index=0, process_count=1)
    tl = pl.DataLoader(pl.ImageFolderSource(root, img_size=32, cache="on",
                                            device="cpu"),
                       batch_size=2, shuffle=True, seed=7, device="cpu")
    for _ in range(2):
        np.testing.assert_array_equal(tl._epoch_indices(),
                                      jl._epoch_indices())
        for (xt, yt), (xj, yj) in zip(tl, jl):
            np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
            np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                                       atol=PM1_STEP + 1.2e-7)


def test_port_abandoned_iterator_ends_its_thread(tmp_path):
    src = pl.SyntheticSource(size=64, img_size=8)
    loader = pl.DataLoader(src, batch_size=2, device="cpu", prefetch=1)
    before = set(threading.enumerate())
    it = iter(loader)
    next(it)
    readers = [t for t in threading.enumerate()
               if t.name == "dmt-read" and t not in before]
    assert len(readers) == 1
    del it
    gc.collect()
    for t in readers:
        t.join(10)
        assert not t.is_alive()


def test_port_loader_raises_the_readers_error(tmp_path):
    root = Path(_jpeg_tree(tmp_path))
    bad = root / "a" / "0.jpg"
    bad.write_bytes(bad.read_bytes()[:100])
    src = pl.ImageFolderSource(str(root), img_size=16, cache="off",
                               device="cpu")
    with pytest.raises(ValueError, match="0.jpg"):
        for _ in pl.DataLoader(src, batch_size=2, device="cpu"):
            pass


@pytest.mark.parametrize("img_size, gz", [(28, False), (28, True),
                                          (32, False), (32, True)])
def test_port_mnist_source_matches_jax(tmp_path, img_size, gz):
    imgs, labels = _mnist_files(tmp_path, n=12, gz=gz)
    assert pl.find_mnist_files(str(tmp_path)) == \
        jax_pl.find_mnist_files(str(tmp_path))
    ts = pl.MNISTSource(str(tmp_path), img_size=img_size)
    js = jax_pl.MNISTSource(str(tmp_path), img_size=img_size)
    idx = np.array([5, 0, 11, 3])
    xu, yu = ts.load_batch_u8(idx)
    xj, yj = js.load_batch_u8(idx)
    np.testing.assert_array_equal(yu, yj)
    assert xu.shape == xj.shape == (4, img_size, img_size, 1)
    if img_size == 28:
        np.testing.assert_array_equal(xu, xj)
    else:
        d = np.abs(xu.astype(int) - xj.astype(int))
        assert d.max() <= 1, d.max()
    xf, _ = ts.load_batch(idx)
    xjf, _ = js.load_batch(idx)
    np.testing.assert_allclose(xf, xjf, rtol=0,
                               atol=(0 if img_size == 28 else 1 / 255)
                               / js.STD + 1e-6)


@pytest.mark.parametrize("dataset, real", [("celebA", True),
                                           ("celebA", False),
                                           ("birds", True), ("birds", False),
                                           ("mnist", True), ("mnist", False)])
def test_port_get_data_loader_contract_matches_jax(tmp_path, dataset, real):
    """Which loaders exist, their sources, sizes, batch counts and first
    batch, against the JAX package's get_data_loader."""
    if dataset == "mnist":
        root = tmp_path / "mnist"
        _mnist_files(root, n=12)
        root = str(root)
    else:
        root = _png_tree(tmp_path)
    kw = dict(name="d", dataset=dataset, img_size=32, batch_size_train=4,
              batch_size_val=4, batch_size_test=2, synthetic_data=not real,
              synthetic_train_size=8, seed=5, input_channels=1
              if dataset == "mnist" else 3,
              image_root_train=root, image_root_val=str(tmp_path / "none"),
              image_root_test=str(tmp_path / "none"),
              save_path=str(tmp_path / "%"), log_path=str(tmp_path / "%/l"))
    jls = jax_pl.get_data_loader(JaxConfig(**kw).finalize(make_dirs=False))
    tls = pl.get_data_loader(Config(**kw).finalize(make_dirs=False),
                             device="cpu")
    assert [j is None for j in jls] == [t is None for t in tls]
    for j, t in zip(jls, tls):
        if j is None:
            continue
        assert type(t.source).__name__ == type(j.source).__name__
        assert len(t) == len(j) and t.dataset_size == j.dataset_size
        assert t.shuffle == j.shuffle and t.batch_size == j.batch_size
        (xt, yt), (xj, yj) = next(iter(t)), next(iter(j))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        assert xt.shape == xj.shape and xt.device.type == "cpu"
        tol = 0 if not real else (1 / 255 / 0.3081 if dataset == "mnist"
                                  else PM1_STEP / 0.224)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                                   atol=tol + 1e-6)
    assert pl.uses_real_mnist(Config(**kw)) == jax_pl.uses_real_mnist(
        JaxConfig(**kw))


# --------------------------------------------------------------------------
# FID statistics of a directory
# --------------------------------------------------------------------------

@pytest.fixture
def shared_inception(monkeypatch):
    from tests.test_torch_port_fid import share_inception

    share_inception(monkeypatch)
    yield
    monkeypatch.undo()
    jax_fid._jitted_features_cached.cache_clear()


def test_port_statistics_from_dir_matches_jax(tmp_path, shared_inception):
    """6 images at 32×32, 3 JPEGs and 3 PNGs, through both packages'
    statistics_from_dir with one Inception tree, in batches of 4 (a full
    and a tail batch); get_fid of the directory against itself is ~0."""
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(3):
        _lf_image(i, (32, 32)).save(d / f"{i}.jpg", quality=90)
        _sharp_image(i, (32, 32), block=4).save(d / f"{i}.png")
    mu, sigma = port_fid.statistics_from_dir(str(d), batch_size=4,
                                             device="cpu")
    mu_j, sigma_j = jax_fid.statistics_from_dir(str(d), batch_size=4)
    assert mu.shape == (2048,) and sigma.shape == (2048, 2048)
    np.testing.assert_allclose(mu, mu_j, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(sigma, sigma_j, rtol=0,
                               atol=5e-3 * np.abs(sigma_j).max())
    m2, s2 = port_fid._handle_path(str(d), device="cpu")
    np.testing.assert_array_equal(m2, mu)
    # equal statistics leave the square roots of Σ's rounding-level
    # eigenvalues (rank ≤ 5 of 2048): chip_smoke.py's self-FID bar
    fid = port_fid.get_fid(str(d), str(d), device="cpu")
    assert abs(fid) < 1e-4 * np.trace(sigma)
    with pytest.raises(FileNotFoundError, match="no \\*.jpg"):
        port_fid.statistics_from_dir(str(tmp_path), device="cpu")


# --------------------------------------------------------------------------
# the committed fixture
# --------------------------------------------------------------------------

def test_port_fixture_expectations_equal_jax_on_the_committed_files():
    """Guard: expected.npz still holds what the JAX package and PIL give
    on the committed JPEGs."""
    with np.load(FIXTURE / "expected.npz") as f:
        names, u8 = list(f["names"]), f["u8_64"]
        full_names, full = list(f["full_names"]), f["full"]
    got_names, got = _jax_fixture_u8(FIXTURE)
    assert got_names == names and len(names) == 16
    np.testing.assert_array_equal(got, u8)
    for n, want in zip(full_names, full):
        pil = np.asarray(Image.open(FIXTURE / "jpeg" / "c0" / n).convert(
            "RGB"))
        np.testing.assert_array_equal(pil, want)
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert size < 1 << 20, size


def test_port_fixture_host_path_matches_expectations():
    """The CPU path on the fixture: libjpeg equals PIL's full-resolution
    decode, and the 64×64 batch meets the resize's bar against the JAX
    package's (the card's path: tests/test_torch_port_data_cuda.py)."""
    paths, u8, full_paths, full = fixture_paths()
    got = native.decode_resize(native.read_files(paths), paths, 64, "cpu")
    _u8_close(got.numpy(), u8)
    dec = native.decode(native.read_files(full_paths), full_paths, "cpu")
    for g, want in zip(dec, full):
        np.testing.assert_array_equal(g.numpy(), want)


def test_port_color_fixture_is_what_it_claims():
    """Guard: the colour files have the colour spaces and samplings their
    names say, expected_color.npz holds their host decodes, and for the
    CMYK pair those equal PIL's."""
    paths, full = color_fixture()
    names = [Path(p).name for p in paths]
    assert names == ["cmyk.jpg", *COLOR_FILES]
    dec = native.decode(native.read_files(paths), paths, "cpu")
    for name, p, g, want in zip(names, paths, dec, full):
        np.testing.assert_array_equal(g.numpy(), want, err_msg=name)
        data = Path(p).read_bytes()
        shapes = [tuple(pl.shape[1:]) for pl in _libjpeg_planes(data)]
        h, w = COLOR_SIZE[1], COLOR_SIZE[0]
        if name.startswith("cmyk") or name.startswith("ycck"):
            np.testing.assert_array_equal(
                want, np.asarray(Image.open(p).convert("RGB")), err_msg=name)
            assert native.adobe_transform(data) == (0 if name == "cmyk.jpg"
                                                    else 2)
            sub = (1, 1) if name == "cmyk.jpg" else (2, 2)
            assert shapes == [(h, w)] + [(-(-h // sub[1]), -(-w // sub[0]))
                                         ] * 3, name
        else:
            hf, vf = (1, 2) if name == "s440.jpg" else (4, 1)
            assert shapes == [(h, w)] + [(-(-h // vf), -(-w // hf))] * 2
            assert native.chroma_factors(h, w, *shapes[1]) == (hf, vf)


# --------------------------------------------------------------------------
# the trainer on an image folder
# --------------------------------------------------------------------------

def test_port_trainer_trains_on_a_png_tree_with_directory_fid(
        tmp_path, monkeypatch, capsys, shared_inception):
    """The trainer CLI at toy width on a PNG tree, 2 epochs, FID against a
    directory of images: every batch the model is fed equals the JAX
    loader's on the same tree, the losses and FIDs are finite, and epoch 2
    reads only the cache."""
    from disentangle_mlp_tpu_torch.cli import train as cli_train
    from disentangle_mlp_tpu_torch.train import vaegan
    from tests.test_torch_port_loop import TOY_FLAGS

    root = _png_tree(tmp_path, n_per_class=4)
    stats_dir = tmp_path / "stats_imgs"
    stats_dir.mkdir()
    for i in range(4):
        _sharp_image(i, (32, 32), block=4).save(stats_dir / f"{i}.png")
    fed = []
    real_step = vaegan.VAEGANExperiment.train_step

    def step(self, x, *a, **k):
        fed.append(x.clone().numpy())
        return real_step(self, x, *a, **k)

    monkeypatch.setattr(vaegan.VAEGANExperiment, "train_step", step)
    sources = []
    real_init = pl.ImageFolderSource.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        sources.append(self)

    monkeypatch.setattr(pl.ImageFolderSource, "__init__", init)
    out = cli_train.main([
        "--model", "betavaegan", "--name", "folder", "--device", "cpu",
        "--image_root_train", root, "--synthetic_data", "False",
        "--batch_size_train", "4", "--epochs", "2", "--seed", "4",
        "--calc_fid", "True", "--n_samples", "4", "--fid_save_samples",
        "False", "--fid_path_pretrained", str(stats_dir),
        "--checkpoint_every", "0", "--save_path", str(tmp_path / "%"),
        "--log_path", str(tmp_path / "%" / "log"), *TOY_FLAGS])
    (src,) = sources
    assert src.decoded == len(src) == 8 and src._cached.all()
    jl = jax_pl.DataLoader(jax_pl.ImageFolderSource(root, img_size=32,
                                                    cache="off"),
                           batch_size=4, shuffle=True, seed=4,
                           process_index=0, process_count=1)
    want = [np.asarray(x) for _ in range(2) for x, _ in jl]
    assert len(fed) == len(want) == 4
    for got, w in zip(fed, want):
        np.testing.assert_allclose(got, w, rtol=0, atol=PM1_STEP + 1.2e-7)
    assert all(np.isfinite(out[k]) for k in ("Avg Eec Loss", "Avg Dis Loss"))
    assert isinstance(out["FID"], float) and np.isfinite(out["FID"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("====> Epoch:")]
    assert len(lines) == 2 and "N/A" not in "".join(lines)


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixture"]:
        write_fixture()
        print(f"wrote {FIXTURE}")
    elif sys.argv[1:] == ["--write-color-fixture"]:
        write_color_fixture()
        print(f"wrote {COLOR_FIXTURE}")
    else:
        sys.exit("usage: python -m tests.test_torch_port_data "
                 "--write-fixture | --write-color-fixture")
