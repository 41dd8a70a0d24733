"""The port's FID stack (disentangle_mlp_tpu_torch/eval/fid.py, eval/samples.py
and utils/image_io.py) against the JAX package's, on the CPU: the host
float64 Fréchet math, the uint8 quantize of the sample files, the PNG files
themselves, the stats-file errors and the dataset-statistics builder.

The Fréchet functions are the same float64 numpy arithmetic in both
packages, so they agree to rounding: rtol 1e-10. Activations come from two
frameworks' Inception forwards on one parameter tree (rtol 2e-3, atol 2e-4,
tests/test_torch_port_inception.py), and the statistics built from them
agree to that tolerance carried through the mean and the covariance.
"""

import functools
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from disentangle_mlp_tpu.eval import fid as jax_fid
from disentangle_mlp_tpu.eval import samples as jax_samples
from disentangle_mlp_tpu.utils import image_io as jax_image_io
from disentangle_mlp_tpu_torch.eval import fid as port_fid
from disentangle_mlp_tpu_torch.eval import samples as port_samples
from disentangle_mlp_tpu_torch.eval.inception import init_random_params
from disentangle_mlp_tpu_torch.utils import image_io as port_image_io
from disentangle_mlp_tpu_torch.utils.params import inception_from_jax

RTOL = 1e-10
# a small feature dimension for the Fréchet tests, so that both the n < d
# (sample subspace) and the n ≥ d (full statistics) paths run in
# milliseconds
D = 24


@functools.lru_cache(maxsize=1)
def inception_params():
    """One Inception tree for both packages (the port's seeded fallback)."""
    return init_random_params(seed=0)


def share_inception(monkeypatch, params=None):
    """Make both packages' FID extract pool3 with the same parameter tree:
    the JAX package's jitted extractor is rebuilt around it (its cache is
    cleared here; the caller clears it again when done) and the port's
    model is built from it."""
    params = params or inception_params()
    jax_fid._jitted_features_cached.cache_clear()
    monkeypatch.setattr(jax_fid, "get_params_cached", lambda: (params, False))
    model = inception_from_jax(params)
    monkeypatch.setattr(port_fid, "_inception", lambda device: model)


@pytest.fixture
def shared_inception(monkeypatch):
    share_inception(monkeypatch)
    yield
    monkeypatch.undo()
    jax_fid._jitted_features_cached.cache_clear()


def _acts(n, d=D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) @ rng.normal(size=(d, d)) / d
            + rng.uniform(0, 1, size=d)).astype(np.float32)


def _ref_stats(d=D, seed=9):
    return jax_fid.activation_statistics(_acts(3 * d, d, seed))


def test_port_activation_statistics_and_sqrt_psd_match_jax():
    acts = _acts(50)
    for got, want in zip(port_fid.activation_statistics(acts),
                         jax_fid.activation_statistics(acts)):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    _, sigma = _ref_stats()
    np.testing.assert_allclose(port_fid._sqrt_psd(sigma),
                               jax_fid._sqrt_psd(sigma), rtol=RTOL,
                               atol=1e-14)


@pytest.mark.parametrize("eps", [0.0, 1e-6])
def test_port_frechet_distance_matches_jax(eps):
    m1, s1 = jax_fid.activation_statistics(_acts(60, seed=1))
    m2, s2 = _ref_stats()
    want = jax_fid.frechet_distance(m1, s1, m2, s2, eps=eps)
    assert want > 0
    np.testing.assert_allclose(port_fid.frechet_distance(m1, s1, m2, s2,
                                                         eps=eps),
                               want, rtol=RTOL)
    with pytest.raises(ValueError, match="different dimensions"):
        port_fid.frechet_distance(m1, s1, m2[:-1], s2[:-1, :-1])


def test_port_frechet_distance_from_samples_matches_jax():
    acts = _acts(10, seed=2)
    m2, s2 = _ref_stats()
    np.testing.assert_allclose(
        port_fid.frechet_distance_from_samples(acts, m2, s2),
        jax_fid.frechet_distance_from_samples(acts, m2, s2), rtol=RTOL)


@pytest.mark.parametrize("n, with_sqrt", [(10, False), (3 * D, False),
                                          (3 * D, True)],
                         ids=["n<d", "n>=d", "n>=d-sqrt_sigma2"])
def test_port_frechet_from_acts_matches_jax(monkeypatch, n, with_sqrt):
    """Both branches of frechet_from_acts (the feature dimension lowered to
    D in both packages), the full-statistics one with and without a
    precomputed √Σ₂."""
    monkeypatch.setattr(jax_fid, "FEATURE_DIM", D)
    monkeypatch.setattr(port_fid, "FEATURE_DIM", D)
    acts = _acts(n, seed=3)
    m2, s2 = _ref_stats()
    sqrt2 = jax_fid._sqrt_psd(s2) if with_sqrt else None
    want = jax_fid.frechet_from_acts(acts, m2, s2, sqrt_sigma2=sqrt2)
    got = port_fid.frechet_from_acts(acts, m2, s2, sqrt_sigma2=sqrt2)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # every path computes the same distance
    np.testing.assert_allclose(
        got, port_fid.frechet_distance(*port_fid.activation_statistics(acts),
                                       m2, s2), rtol=1e-6)


def test_port_cached_sqrt_sigma2_memoizes_on_file_identity(tmp_path):
    path = str(tmp_path / "stats.npz")
    m2, s2 = _ref_stats()
    np.savez(path, mu=m2, sigma=s2)
    first = port_fid.cached_sqrt_sigma2(path, s2)
    np.testing.assert_allclose(first, jax_fid.cached_sqrt_sigma2(path, s2),
                               rtol=RTOL, atol=1e-14)
    assert port_fid.cached_sqrt_sigma2(path, s2 * 4.0) is first  # same file
    assert port_fid.cached_sqrt_sigma2(str(tmp_path), s2) is None


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_port_normalized_u8_within_one_step_of_jax(kind):
    batch = np.random.default_rng(1).uniform(
        -1.2, 1.1, size=(4, 16, 16, 3)).astype(np.float32)
    if kind == "numpy":
        got = port_fid.normalized_u8(batch)
        want = jax_fid.normalized_u8(batch)
    else:
        got = port_fid.normalized_u8(torch.from_numpy(batch)).numpy()
        want = np.asarray(jax_fid.normalized_u8(jnp.asarray(batch)))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _pixels(path):
    with Image.open(path) as im:
        return im.mode, np.asarray(im)


@pytest.mark.parametrize("channels", [3, 1])
def test_port_png_files_equal_jax_files_pixel_for_pixel(tmp_path, channels):
    """save_image, save_image_grid and the per-sample files, written by the
    port's zlib encoder and by the JAX package through PIL, decode to the
    same pixels and mode."""
    rng = np.random.default_rng(4)
    batch = rng.uniform(-1, 1, size=(5, 9, 7, channels)).astype(np.float32)
    u8 = port_fid.normalized_u8(batch)
    for pkg, image_io, samples in (("port", port_image_io, port_samples),
                                   ("jax", jax_image_io, jax_samples)):
        out = tmp_path / pkg
        out.mkdir()
        image_io.save_image(batch[0], str(out / "one.png"))
        image_io.save_image_grid(batch, str(out / "grid.png"), nrow=2)
        samples.write_sample_files(u8, 3, str(out))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 2 + len(batch)
    for name in names:
        got, want = _pixels(tmp_path / "port" / name), \
            _pixels(tmp_path / "jax" / name)
        assert got[0] == want[0] == ("RGB" if channels == 3 else "L"), name
        np.testing.assert_array_equal(got[1], want[1], err_msg=name)


def test_port_write_png_refuses_what_it_cannot_encode(tmp_path):
    with pytest.raises(TypeError, match="uint8"):
        port_image_io.write_png(str(tmp_path / "a.png"),
                                np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="HW3"):
        port_image_io.write_png(str(tmp_path / "a.png"),
                                np.zeros((4, 4, 4), np.uint8))


def test_port_stats_file_errors(tmp_path):
    no_mu = str(tmp_path / "no_mu.npz")
    np.savez(no_mu, sigma=np.eye(3))
    with pytest.raises(port_fid.StatsFileError, match="mu/sigma"):
        port_fid.load_stats_npz(no_mu)
    bad_zip = tmp_path / "truncated.npz"
    np.savez(bad_zip, mu=np.zeros(3), sigma=np.eye(3))
    bad_zip.write_bytes(bad_zip.read_bytes()[:40])
    with pytest.raises(port_fid.ASSET_ERRORS):
        port_fid._handle_path(str(bad_zip))
    with pytest.raises(FileNotFoundError):
        port_fid._handle_path(str(tmp_path / "missing.npz"))
    assert ([e.__name__ for e in port_fid.ASSET_ERRORS]
            == [e.__name__ for e in jax_fid.ASSET_ERRORS])
    good = str(tmp_path / "good.npz")
    np.savez(good, mu=np.arange(3.0), sigma=np.eye(3))
    mu, sigma = port_fid._handle_path(good)
    np.testing.assert_array_equal(mu, np.arange(3.0))
    # a directory is read as images (statistics_from_dir): one without any
    # is a missing asset, as for the JAX package
    with pytest.raises(FileNotFoundError, match="no \\*.jpg/\\*.png"):
        port_fid._handle_path(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        jax_fid._handle_path(str(tmp_path))


def test_port_compute_dataset_statistics_matches_jax(tmp_path,
                                                     shared_inception):
    """A toy loader of [-1, 1] batches (2 × 3 images, cut at 5) through
    both packages' builders with one Inception tree; the .npz holds the
    returned statistics."""
    rng = np.random.default_rng(5)
    batches = [rng.uniform(-1, 1, size=(3, 16, 16, 3)).astype(np.float32)
               for _ in range(2)]
    y = np.zeros(3, np.int32)
    path = str(tmp_path / "port.npz")
    mu, sigma = port_fid.compute_dataset_statistics(
        [(torch.from_numpy(b), torch.from_numpy(y)) for b in batches],
        path, max_images=5)
    mu_j, sigma_j = jax_fid.compute_dataset_statistics(
        [(b, y) for b in batches], max_images=5)
    assert mu.shape == (2048,) and sigma.shape == (2048, 2048)
    np.testing.assert_allclose(mu, mu_j, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(sigma, sigma_j, rtol=0,
                               atol=5e-3 * np.abs(sigma_j).max())
    saved_mu, saved_sigma = port_fid.load_stats_npz(path)
    np.testing.assert_array_equal(saved_mu, mu)
    np.testing.assert_array_equal(saved_sigma, sigma)


def test_port_sample_and_reconstruction_dumpers_match_jax(tmp_path):
    """generate_samples, gen_reconstructions and gen_fid_reconstructions
    write the JAX package's file names with its pixels, given the same
    decoder outputs (the callable ignores its input's values, so the two
    packages' latent draws do not matter)."""
    rng = np.random.default_rng(6)
    batch = rng.uniform(-1, 1, size=(6, 10, 10, 3)).astype(np.float32)
    orig = rng.uniform(-1, 1, size=(6, 10, 10, 3)).astype(np.float32)
    for pkg, samples, wrap in (("port", port_samples, torch.from_numpy),
                               ("jax", jax_samples, np.asarray)):
        out = tmp_path / pkg
        out.mkdir()
        fn = lambda _, b=wrap(batch): b  # noqa: E731
        kw = {"device": "cpu"} if pkg == "port" else {}
        samples.generate_samples(fn, 2, 6, 4, str(out), nrow=4, **kw)
        dl = [(wrap(orig), wrap(np.zeros(6, np.int32)))]
        samples.gen_reconstructions(fn, dl, 2, str(out), nrow=3,
                                    path_for_originals=str(out))
        samples.gen_fid_reconstructions(fn, dl, 2, str(out))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert {"sample_2.png", "recon_2.png", "original_2.png",
            "recon_5_2.png"} <= set(names)
    for name in names:
        np.testing.assert_array_equal(_pixels(tmp_path / "port" / name)[1],
                                      _pixels(tmp_path / "jax" / name)[1],
                                      err_msg=name)


def test_port_sample_latents_are_seeded():
    a = port_samples._sample_latents(3, 5, 7, device="cpu")
    assert a.shape == (5, 7) and a.dtype == torch.float32
    assert torch.equal(a, port_samples._sample_latents(3, 5, 7, "cpu"))
    assert not torch.equal(a, port_samples._sample_latents(4, 5, 7, "cpu"))


def test_port_stats_cli_writes_the_npz_the_trainer_reads(tmp_path,
                                                         shared_inception):
    from disentangle_mlp_tpu_torch.cli import stats as cli_stats

    out = str(tmp_path / "stats.npz")
    cli_stats.main(["--name", "stats", "--device", "cpu",
                    "--synthetic_data", "True", "--synthetic_train_size",
                    "6", "--batch_size_train", "3", "--img_size", "16",
                    "--max_images", "4", "--stats_out", out,
                    "--save_path", str(tmp_path / "%"),
                    "--log_path", str(tmp_path / "%" / "log")])
    mu, sigma = port_fid.load_stats_npz(out)
    assert mu.shape == (2048,) and sigma.shape == (2048, 2048)
    assert np.isfinite(sigma).all() and np.allclose(sigma, sigma.T)
