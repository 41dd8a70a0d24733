"""The port's asset bootstrap (disentangle_mlp_tpu_torch/cli/fetch_assets.py)
against the JAX package's: the same six cases as tests/test_fetch_assets.py
(offline plan and exit 1, digest refusal, already present, the .gz suffix
through verification, a partial MNIST install planned again, the idx
structural check), and the two commands' offline plans line for line.
Nothing here reaches the network: downloads go through a patched
``urlretrieve`` or a ``file://`` URL."""

import gzip
import hashlib
import os
import struct
import urllib.request

import numpy as np
import pytest

from disentangle_mlp_tpu.cli import fetch_assets as jax_fa
from disentangle_mlp_tpu.eval import inception as jax_inception
from disentangle_mlp_tpu_torch.cli import fetch_assets as fa
from disentangle_mlp_tpu_torch.data import pipeline as pl
from disentangle_mlp_tpu_torch.eval import inception


def _write_gz_labels(path, n):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, 1))
        f.write(struct.pack(">I", n))
        f.write(np.zeros(n, np.uint8).tobytes())


def test_port_tables_equal_jax():
    assert fa.FID_WEIGHTS == jax_fa.FID_WEIGHTS
    assert fa.MNIST_FILES == jax_fa.MNIST_FILES


def test_port_offline_mode_prints_plan_and_exits_nonzero(tmp_path, capsys,
                                                         monkeypatch):
    # WEIGHT_SEARCH_PATHS reads the environment at import: patch the
    # lookup, or this passes vacuously where real weights are installed
    monkeypatch.setattr(inception, "find_fid_weights", lambda: None)
    with pytest.raises(SystemExit) as e:
        fa.main(["--dest", str(tmp_path), "--mnist"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "--allow_network" in out
    assert "pt_inception-2015-12-05-6726825d.pth" in out
    assert "t10k-images-idx3-ubyte.gz" in out
    assert "CelebA" in out  # consent-gated: never fetched
    assert not list(tmp_path.iterdir())  # nothing touched the disk


def test_port_download_verifies_digest(tmp_path, monkeypatch):
    payload_ok = b"fake weights"
    prefix = hashlib.sha256(payload_ok).hexdigest()[:8]

    def fake_retrieve(url, tmp):
        with open(tmp, "wb") as f:
            f.write(payload_ok)

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_retrieve)
    dest = str(tmp_path / "w.pth")
    fa._download("http://example.invalid/w.pth", dest, prefix)
    assert open(dest, "rb").read() == payload_ok

    # wrong digest: refuse and leave no file behind
    bad_dest = str(tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="digest mismatch"):
        fa._download("http://example.invalid/bad.pth", bad_dest, "00000000")
    assert not os.path.exists(bad_dest)
    assert not list(tmp_path.glob("tmp*"))  # temp file removed


def test_port_download_of_a_file_url(tmp_path):
    """A ``file://`` URL goes through the real ``urlretrieve``: installed
    with its true digest prefix, refused with another."""
    src = tmp_path / "src.bin"
    src.write_bytes(b"\x01\x02payload")
    prefix = hashlib.sha256(src.read_bytes()).hexdigest()[:8]
    dest = tmp_path / "out" / "w.pth"
    fa._download(src.as_uri(), str(dest), prefix)
    assert dest.read_bytes() == src.read_bytes()
    with pytest.raises(RuntimeError, match="digest mismatch"):
        fa._download(src.as_uri(), str(tmp_path / "out" / "x.pth"),
                     "ffffffff")
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["w.pth"]


def test_port_already_present_fetches_nothing(tmp_path, capsys, monkeypatch):
    w = tmp_path / "pt_inception-2015-12-05-6726825d.pth"
    w.write_bytes(b"x")
    monkeypatch.setattr(inception, "find_fid_weights", lambda: str(w))
    fa.main(["--dest", str(tmp_path)])
    out = capsys.readouterr().out
    assert "already present" in out and "nothing to fetch" in out


def test_port_download_keeps_gz_suffix_through_verification(tmp_path,
                                                             monkeypatch):
    """The temp file ``_verify_idx`` reads keeps the destination's .gz
    suffix: ``_read_idx`` opens by suffix, so a suffixless temp would
    refuse every valid gzipped download."""
    monkeypatch.setattr(urllib.request, "urlretrieve",
                        lambda url, tmp: _write_gz_labels(tmp, 10000))
    dest = str(tmp_path / "t10k-labels-idx1-ubyte.gz")
    fa._download("http://example.invalid/t10k-labels-idx1-ubyte.gz", dest,
                 verify=lambda p: fa._verify_idx(p, (10000,)))
    assert pl._read_idx(dest).shape == (10000,)


def test_port_partial_mnist_install_replans_only_missing(tmp_path, capsys,
                                                         monkeypatch):
    """With only the train pair installed, a rerun plans the t10k pair
    instead of reporting the set complete."""
    monkeypatch.setattr(inception, "find_fid_weights", lambda: "present")
    mdest = tmp_path / "mnist"
    mdest.mkdir()
    (mdest / "train-images-idx3-ubyte.gz").write_bytes(b"x")
    (mdest / "train-labels-idx1-ubyte.gz").write_bytes(b"x")
    with pytest.raises(SystemExit):  # offline mode prints the plan
        fa.main(["--dest", str(tmp_path), "--mnist",
                 "--mnist_dest", str(mdest)])
    out = capsys.readouterr().out
    assert "t10k-images-idx3-ubyte.gz" in out
    assert "t10k-labels-idx1-ubyte.gz" in out
    assert "train-images-idx3-ubyte.gz" not in out

    missing = fa._mnist_missing(str(mdest))
    assert [m["file"] for m in missing] == [
        "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"]
    assert missing == jax_fa._mnist_missing(str(mdest))


def test_port_verify_idx_structural_check(tmp_path):
    """The canonical shape passes; a truncated or foreign file is refused,
    with the JAX command's exception types."""
    good = str(tmp_path / "t10k-labels-idx1-ubyte.gz")
    _write_gz_labels(good, 10000)
    fa._verify_idx(good, (10000,))

    bad = str(tmp_path / "truncated.gz")
    _write_gz_labels(bad, 9999)
    for mod in (fa, jax_fa):
        with pytest.raises(RuntimeError, match="idx shape"):
            mod._verify_idx(bad, (10000,))

    notidx = str(tmp_path / "notidx.gz")
    with gzip.open(notidx, "wb") as f:
        f.write(b"junkjunkjunk")
    for mod in (fa, jax_fa):
        with pytest.raises(ValueError):
            mod._verify_idx(notidx, (10000,))


@pytest.mark.parametrize("mnist", ["none", "default", "custom", "partial"])
def test_port_offline_plan_equals_jax_line_for_line(tmp_path, capsys,
                                                    monkeypatch, mnist):
    """Both commands, offline, with no weights found: the same plan, line
    for line, and exit 1, writing nothing under ``--dest``."""
    monkeypatch.setattr(inception, "find_fid_weights", lambda: None)
    monkeypatch.setattr(jax_inception, "find_fid_weights", lambda: None)
    dest = tmp_path / "dest"
    argv = ["--dest", str(dest)]
    if mnist != "none":
        argv.append("--mnist")
    if mnist in ("custom", "partial"):
        mdest = tmp_path / "m"
        argv += ["--mnist_dest", str(mdest)]
        if mnist == "partial":
            mdest.mkdir()
            for name in ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"):
                (mdest / name).write_bytes(b"x")
    outs = []
    for mod in (jax_fa, fa):
        with pytest.raises(SystemExit) as e:
            mod.main(argv)
        assert e.value.code == 1
        outs.append(capsys.readouterr().out.splitlines())
    assert outs[0] == outs[1]
    n_mnist = {"none": 0, "default": 4, "custom": 4, "partial": 2}[mnist]
    assert sum("    -> " in ln for ln in outs[1]) == 1 + n_mnist
    assert not dest.exists()
