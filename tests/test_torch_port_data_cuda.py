"""The card's JPEG path (nvJPEG through data/native.py) on the committed
fixture, and its errors. These tests need a CUDA GPU and skip without
one; they import neither PIL nor the JAX package, so they run on the
machine with the card:

    python -m pytest tests/test_torch_port_data_cuda.py -m cuda -q

The fixture (disentangle_mlp_tpu_torch/data/fixtures/, written by
tests/test_torch_port_data.py) holds 16 CelebA-sized JPEGs and the JAX
package's 64×64 ``load_batch_u8`` of them, and PIL's full-resolution
decode of four; and a CMYK, a YCCK, a 4:4:0 and a 4:1:1 file with their
host decodes. The card upsamples and converts nvJPEG's planes with
libjpeg's own arithmetic (data/native.py::ycc_to_rgb, cmyk_to_rgb), so
only the IDCT's rounding differs from libjpeg's: max |Δ| ≤ 6 grey levels
at full resolution; at 64×64 mean |Δ| ≤ 1 and max |Δ| ≤ 8 (chip_smoke.py
holds the same bars).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from disentangle_mlp_tpu_torch.data import native

FIXTURE = (Path(__file__).resolve().parent.parent / "disentangle_mlp_tpu_torch"
           / "data" / "fixtures")


# CMYK (written by PIL), YCCK, 4:4:0 and 4:1:1 (written by libjpeg) files
# and their host decodes (libjpeg; PIL's own for the CMYK pair)
COLOR_FIXTURE = FIXTURE / "jpeg_color"


def color_fixture():
    """(paths of the colour-space and subsampling files, their host
    decodes at full resolution)."""
    with np.load(FIXTURE / "expected_color.npz") as f:
        names, full = list(f["names"]), f["full"]
    return [str(COLOR_FIXTURE / n) for n in names], full


def fixture_paths():
    """(paths, their 64×64 uint8 from the JAX package, paths of the four
    full-resolution decodes, PIL's decodes of those)."""
    with np.load(FIXTURE / "expected.npz") as f:
        names, u8 = list(f["names"]), f["u8_64"]
        full_names, full = list(f["full_names"]), f["full"]
    d = FIXTURE / "jpeg" / "c0"
    return ([str(d / n) for n in names], u8,
            [str(d / n) for n in full_names], full)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
def test_port_fixture_card_decode_matches_expectations(card):
    paths, u8, full_paths, full = fixture_paths()
    got = native.decode_resize(native.read_files(paths), paths, 64, "cuda")
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    d = np.abs(got.cpu().numpy().astype(int) - u8)
    assert d.mean() <= 1.0 and d.max() <= 8, (d.mean(), d.max())
    dec = native.decode(native.read_files(full_paths), full_paths, "cuda")
    for p, g, want in zip(full_paths, dec, full):
        assert g.shape == want.shape, p
        assert np.abs(g.cpu().numpy().astype(int) - want).max() <= 6, p


@pytest.mark.cuda
def test_port_damaged_jpeg_raises_with_its_name_on_the_card(card):
    """A damaged file among good ones raises naming that file: a
    truncated one (no end-of-image marker) and one whose header nvJPEG
    cannot read."""
    paths, _, _, _ = fixture_paths()
    data = native.read_files(paths[:3])
    rng = np.random.default_rng(0)
    cases = {"cut.jpg": data[1][:len(data[1]) // 2],
             "headless.jpg": (b"\xff\xd8" + rng.integers(
                 0, 255, 4000, dtype=np.uint8).tobytes() + b"\xff\xd9")}
    for name, content in cases.items():
        with pytest.raises(ValueError, match=name):
            native.decode([data[0], content, data[2]],
                          [paths[0], name, paths[2]], "cuda")
            torch.cuda.synchronize()


@pytest.mark.cuda
def test_port_color_fixture_card_decode_matches_the_host(card):
    """CMYK, YCCK, 4:4:0 and 4:1:1 files decode on the card within the
    full-resolution bar of the host decode (PIL's for CMYK and YCCK)."""
    paths, full = color_fixture()
    dec = native.decode(native.read_files(paths), paths, "cuda")
    for p, g, want in zip(paths, dec, full):
        assert g.shape == want.shape and g.dtype == torch.uint8, p
        assert np.abs(g.cpu().numpy().astype(int) - want).max() <= 6, p
