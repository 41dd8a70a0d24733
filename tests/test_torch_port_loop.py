"""The port's data feed, trainer CLI, checkpoints, per-epoch FID and import
isolation (disentangle_mlp_tpu_torch: data/pipeline.py, train/loop.py,
cli/train.py, utils/checkpoint.py, the FID path through eval/), on the CPU
at toy width."""

import functools
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disentangle_mlp_tpu.config import Config as JaxConfig
from disentangle_mlp_tpu.data.pipeline import \
    get_data_loader as jax_get_data_loader
from disentangle_mlp_tpu.eval import fid as jax_fid
from disentangle_mlp_tpu.eval.samples import \
    _sample_latents as jax_sample_latents
from disentangle_mlp_tpu.models.vae import VAE as JaxVAE
from disentangle_mlp_tpu.train import loop as jax_loop
from disentangle_mlp_tpu_torch.cli import profile_step
from disentangle_mlp_tpu_torch.cli import train as cli_train
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.data.pipeline import get_data_loader
from disentangle_mlp_tpu_torch.train import loop
from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
from disentangle_mlp_tpu_torch.utils.params import from_jax, to_numpy_tree
from tests.test_torch_compat import (DEC_CH, DISC_CH, FEAT_DIM, HEAD, IMG,
                                     N_HIDDEN, N_Z, RS)
from tests.test_torch_port_fid import share_inception

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_FLAGS = ["--n_hidden", str(N_HIDDEN), "--n_z", *map(str, N_Z),
             "--representation_size", str(RS), "--head_width", str(HEAD),
             "--decoder_channels", *map(str, DEC_CH),
             "--disc_channels", *map(str, DISC_CH),
             "--disc_feature_dim", str(FEAT_DIM), "--img_size", str(IMG)]


def _argv(tmp_path, *extra):
    return ["--model", "betavaegan", "--name", "port_cli", "--device", "cpu",
            "--calc_fid", "False", "--synthetic_data", "True",
            "--synthetic_train_size", "8", "--batch_size_train", "4",
            "--save_path", str(tmp_path / "%"),
            "--log_path", str(tmp_path / "%" / "log"), *TOY_FLAGS, *extra]


def test_port_synthetic_batches_equal_jax_loader_bit_for_bit():
    kw = dict(name="port_data", synthetic_data=True, synthetic_train_size=40,
              batch_size_train=8, batch_size_val=8, batch_size_test=5,
              img_size=16, seed=3)
    jl = jax_get_data_loader(JaxConfig(**kw))
    tl = get_data_loader(Config(**kw), device="cpu")
    for j, t in zip(jl, tl):
        assert len(j) == len(t) and j.dataset_size == t.dataset_size
        for _ in range(2):  # two epochs: the per-epoch reshuffle
            batches = list(zip(j, t))
            assert len(batches) == len(t)
            for (xj, yj), (xt, yt) in batches:
                assert xt.dtype == torch.float32 and xt.shape == xj.shape
                np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
                np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_port_trainer_cli_writes_epoch_line_and_reference_log(tmp_path,
                                                              capsys):
    out = cli_train.main(_argv(tmp_path, "--epochs", "1"))
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("====> Epoch: 0 ")]
    assert len(line) == 1
    assert "Avg Encoder Loss" in line[0] and "FID: N/A" in line[0]
    assert "img/s" in line[0]
    assert np.isfinite(out["Avg Eec Loss"]) and out["images_per_sec"] > 0
    assert set(out["step_metrics"]) == {"recon_enc", "recon_dec", "dis",
                                        "D_x", "kld", "sim"}
    (log_file,) = glob.glob(str(tmp_path / "port_cli" / "log" / "log_*.json"))
    with open(log_file) as f:
        log = json.load(f)
    assert set(log["meta_data"]) == {"file", "datetime", "args"}
    assert log["meta_data"]["args"]["name"] == "port_cli"
    (rec,) = log["output"]
    assert list(rec) == ["Epoch", "Avg Eec Loss", "Avg Dnc Loss",
                         "Avg Dis Loss", "FID"]
    assert rec["Epoch"] == 0 and rec["FID"] == "N/A"
    assert os.path.isfile(tmp_path / "port_cli" / "models" / "model_1")


def test_port_checkpoint_rotation_and_resume(tmp_path, capsys):
    cli_train.main(_argv(tmp_path, "--epochs", "2", "--keep_checkpoints",
                         "1", "--freeze_mode", "intent"))
    models = tmp_path / "port_cli" / "models"
    assert sorted(os.listdir(models)) == ["model_2"]
    capsys.readouterr()
    cli_train.main(_argv(tmp_path, "--epochs", "3", "--freeze_mode",
                         "intent", "--load_path", str(models / "model_2")))
    epochs = [ln.split()[2] for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("====> Epoch:")]
    assert epochs == ["2"]  # resumed after the two saved epochs


@pytest.mark.parametrize("extra, error, match", [
    (["--calc_fid", "True", "--fid_path_pretrained", "stats_dir"],
     NotImplementedError, "not yet ported"),
    (["--model", "gan"], NotImplementedError, "not yet ported"),
    (["--load_path", "a", "b"], NotImplementedError, "not yet ported"),
    (["--mesh_shape", "2"], NotImplementedError, "not yet ported"),
])
def test_port_trainer_refuses_unported_paths(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        cli_train.main(_argv(tmp_path, *extra))


def test_port_trainer_defaults_to_cuda_and_never_falls_back(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="cuda"):
        cli_train.main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        loop.resolve_device("cuda")
    assert loop.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("name, category", [
    ("void (anonymous namespace)::fused_linear_kernel<float, float>",
     "fused_linear"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "convolution"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "matmul"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float>>",
     "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, add>", "elementwise"),
    ("void at::native::(anonymous)::multi_tensor_apply_kernel<foo>",
     "optimizer"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy/memset"),
    ("some_other_kernel", "other"),
])
def test_port_profile_step_kernel_categories(name, category):
    assert profile_step.categorize(name) == category


def test_port_profile_step_needs_a_gpu(monkeypatch):
    """The step profiler measures a device; without one it refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_step.main(["--name", "prof", "--calc_fid", "False"])


def test_port_imports_no_jax():
    """Every module of the port imports without JAX, flax, optax, the JAX
    package or PIL (a subprocess: this test process has them loaded
    already)."""
    code = r"""
import importlib, pkgutil, sys
import disentangle_mlp_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
             or m == "disentangle_mlp_tpu" or m.startswith("disentangle_mlp_tpu.")
             or m.split(".")[0] == "PIL")
print(len(names), bad)
sys.exit(1 if bad or len(names) < 29 else 0)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# ---------------------------------------------------------------------------
# per-epoch FID in the training loop
# ---------------------------------------------------------------------------

N_SAMPLES = 8
# The two packages' FIDs of one decoded batch: the decodes agree to float32
# rounding, the pool3 activations to the Inception parity tolerance
# (rtol 2e-3, atol 2e-4), and the score, dominated by the reference
# statistics' trace and mean, moves far less than that.
FID_RTOL = 1e-3


def _stats_npz(tmp_path):
    """Small but valid reference statistics (diagonal Σ); n_samples 8 <
    2048 keeps the score on the sample-subspace path."""
    path = tmp_path / "stats.npz"
    rng = np.random.default_rng(0)
    np.savez(path, mu=rng.normal(size=2048),
             sigma=np.diag(rng.uniform(0.5, 1.5, size=2048)))
    return str(path)


def _toy_kwargs(tmp_path, name, **kw):
    base = dict(name=name, n_hidden=N_HIDDEN, n_z=list(N_Z),
                representation_size=RS, head_width=HEAD,
                decoder_channels=list(DEC_CH), disc_channels=list(DISC_CH),
                disc_feature_dim=FEAT_DIM, img_size=IMG, dtype="float32",
                calc_fid=True, n_samples=N_SAMPLES,
                save_path=str(tmp_path / "%"),
                log_path=str(tmp_path / "%" / "log"))
    base.update(kw)
    return base


def _bn_buffers(exp):
    return {k: v.clone() for k, v in exp.vae.state_dict().items()
            if "running" in k}


def test_port_maybe_fid_matches_jax_on_carried_params(tmp_path, monkeypatch):
    """One toy-width float32 VAE in both packages (a JAX init carried into
    the port), one Inception tree in both, the JAX package's seeded latents
    injected into the port: the two _maybe_fid scores agree to FID_RTOL and
    both write n_samples PNG files. The JAX decode is the experiment's
    (train/vaegan.py ``eg_decode``): BatchNorm in train mode, batch
    statistics discarded."""
    share_inception(monkeypatch)
    try:
        kw = _toy_kwargs(tmp_path, "fid_parity",
                         fid_path_pretrained=_stats_npz(tmp_path))
        jcfg = JaxConfig(**kw).finalize()
        jvae = JaxVAE(n_hidden=N_HIDDEN, n_z=N_Z, representation_size=RS,
                      head_width=HEAD, decoder_channels=DEC_CH)
        # jitted: one compile instead of eager op-by-op initialisation
        variables = jax.jit(functools.partial(jvae.init, train=True))(
            {"params": jax.random.key(0), "reparam": jax.random.key(1)},
            jnp.zeros((2, IMG, IMG, 3)))

        def jax_decode(z):
            out, _ = jvae.apply(dict(variables), z, train=True,
                                method=JaxVAE.decode,
                                mutable=["batch_stats"])
            return out

        cfg = Config(**kw).finalize()
        port = VAEGANExperiment(cfg, "cpu")
        from_jax(port.vae, to_numpy_tree(variables["params"]),
                 to_numpy_tree(variables["batch_stats"]))

        epoch = 1
        jdir, tdir = tmp_path / "jax_samples", tmp_path / "port_samples"
        jdir.mkdir()
        tdir.mkdir()
        want = jax_loop._maybe_fid(jcfg, jax_decode, epoch, str(jdir))
        z = torch.from_numpy(np.array(jax_sample_latents(
            cfg.seed + epoch, N_SAMPLES, N_HIDDEN)))
        got = loop._maybe_fid(cfg, port.decode, epoch, str(tdir),
                              device="cpu", z=z)
    finally:
        jax_fid._jitted_features_cached.cache_clear()
    assert isinstance(got, float) and isinstance(want, float)
    np.testing.assert_allclose(got, want, rtol=FID_RTOL)
    for d in (jdir, tdir):
        assert len(glob.glob(str(d / f"sample_*_{epoch}.png"))) == N_SAMPLES


@pytest.mark.parametrize("fid_async", [True, False])
def test_port_trainer_logs_fid_every_epoch(tmp_path, monkeypatch, capsys,
                                           fid_async):
    """--calc_fid True through the trainer CLI, FID scored asynchronously
    and inline: a float FID in every epoch's record, the records in epoch
    order, n_samples PNG files per epoch. Both modes score the same
    samples, so their records are identical but for the img/s rate."""
    monkeypatch.setattr(loop, "_FID_ASYNC", fid_async)
    stats = _stats_npz(tmp_path)
    records = {}
    for name in ("a", "b"):
        run = f"fid_{name}"
        cli_train.main([a if a != "port_cli" else run for a in _argv(
            tmp_path, "--epochs", "2", "--calc_fid", "True",
            "--n_samples", str(N_SAMPLES), "--fid_path_pretrained", stats,
            "--dtype", "float32")])
        (log_file,) = glob.glob(str(tmp_path / run / "log" / "log_*.json"))
        with open(log_file) as f:
            records[name] = json.load(f)["output"]
        recons = tmp_path / run / "fid_results" / "recons"
        for epoch in (0, 1):
            assert len(glob.glob(str(recons / f"sample_*_{epoch}.png"))) \
                == N_SAMPLES
        if name == "a":
            monkeypatch.setattr(loop, "_FID_ASYNC", not fid_async)
    assert [r["Epoch"] for r in records["a"]] == [0, 1]
    assert all(isinstance(r["FID"], float) and np.isfinite(r["FID"])
               for r in records["a"])
    assert records["a"] == records["b"]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("====> Epoch:")]
    assert len(lines) == 4 and all("FID: N/A" not in ln for ln in lines)


def test_port_trainer_missing_stats_logs_na(tmp_path, capsys):
    cli_train.main(_argv(tmp_path, "--epochs", "1", "--calc_fid", "True",
                         "--n_samples", str(N_SAMPLES),
                         "--fid_path_pretrained",
                         str(tmp_path / "missing.npz")))
    out = capsys.readouterr().out
    assert "[fid] skipped:" in out and "FID: N/A" in out
    (log_file,) = glob.glob(str(tmp_path / "port_cli" / "log" / "log_*.json"))
    with open(log_file) as f:
        assert json.load(f)["output"][0]["FID"] == "N/A"


def test_port_fid_programming_error_reraises(tmp_path, monkeypatch):
    """Only a missing or corrupt stats asset degrades to 'N/A': a fault in
    the FID stack re-raises, from resolve() when it arises in the worker."""
    from disentangle_mlp_tpu_torch.eval import fid as port_fid

    def boom(*args, **kwargs):
        raise ValueError("deliberate bug in the FID stack")

    monkeypatch.setattr(port_fid, "frechet_from_acts", boom)
    monkeypatch.setattr(port_fid, "get_activations",
                        lambda x: np.zeros((x.shape[0], 2048), np.float32))
    cfg = Config(**_toy_kwargs(tmp_path, "boom",
                               fid_path_pretrained=_stats_npz(tmp_path),
                               fid_save_samples=False)).finalize()
    exp = VAEGANExperiment(cfg, "cpu")
    resolve = loop._maybe_fid_async(cfg, exp.decode, 0, cfg.fid_path_recons,
                                    device="cpu")
    with pytest.raises(ValueError, match="deliberate bug"):
        resolve()
    with pytest.raises(ValueError, match="deliberate bug"):
        loop._maybe_fid(cfg, exp.decode, 0, cfg.fid_path_recons,
                        device="cpu")


def test_port_fid_decode_leaves_batchnorm_buffers_bit_identical(tmp_path):
    """decode() normalizes with the sample batch's own statistics (train
    mode) and puts the running statistics back, so sampling moves nothing
    a checkpoint saves."""
    cfg = Config(**_toy_kwargs(tmp_path, "bn")).finalize(make_dirs=False)
    exp = VAEGANExperiment(cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (4, IMG, IMG, 3)).astype(np.float32))
    exp.train_step(x)  # running statistics away from their init
    before = _bn_buffers(exp)
    assert before
    z = torch.from_numpy(np.random.default_rng(1).normal(
        size=(N_SAMPLES, N_HIDDEN)).astype(np.float32))
    out = exp.decode(z)
    assert tuple(out.shape) == (N_SAMPLES, IMG, IMG, 3)
    assert not out.requires_grad
    after = _bn_buffers(exp)
    assert all(torch.equal(after[k], before[k]) for k in before)
    # batch statistics, not the running ones: eval mode decodes otherwise
    with torch.no_grad():
        eval_out = exp.vae.decode(z, train=False)
    assert not torch.allclose(out, eval_out)
