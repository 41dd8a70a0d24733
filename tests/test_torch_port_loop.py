"""The port's data feed, trainer and evaluation CLIs, checkpoints,
per-epoch FID and import isolation (disentangle_mlp_tpu_torch:
data/pipeline.py, train/loop.py, cli/train.py, cli/evaluate.py,
utils/checkpoint.py, the FID path through eval/), on the CPU at toy
width."""

import functools
import glob
import json
import os
import re
import shutil
import subprocess
import sys
from types import SimpleNamespace

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
from disentangle_mlp_tpu_torch.cli import evaluate as cli_evaluate
from disentangle_mlp_tpu_torch.cli import profile_step
from disentangle_mlp_tpu_torch.cli import train as cli_train
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.data.pipeline import get_data_loader
from disentangle_mlp_tpu_torch.train import loop
from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
from disentangle_mlp_tpu_torch.utils import msgpack
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


def _argv(tmp_path, *extra, model="betavaegan", name="port_cli"):
    return ["--model", model, "--name", name, "--device", "cpu",
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
    (["--mesh_shape", "2"], NotImplementedError, "not yet ported"),
])
def test_port_trainer_refuses_unported_paths(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        cli_train.main(_argv(tmp_path, *extra))


@pytest.mark.parametrize("fails", [False, True])
def test_port_trainer_writes_a_profile_trace(tmp_path, monkeypatch, capsys,
                                             fails):
    """--profile_dir: the run's torch.profiler trace is written there, also
    when the run raises (the trace stopped in a finally, as the JAX
    package's cli/train.py does)."""
    profile = tmp_path / "profile"
    if fails:
        def boom(*args, **kwargs):
            raise RuntimeError("deliberate failure mid-run")

        monkeypatch.setattr(cli_train, "RUNNERS",
                            dict(cli_train.RUNNERS, betavaegan=boom))
        with pytest.raises(RuntimeError, match="deliberate failure"):
            cli_train.main(_argv(tmp_path, "--profile_dir", str(profile)))
    else:
        out = cli_train.main(_argv(tmp_path, "--epochs", "1",
                                   "--profile_dir", str(profile)))
        assert np.isfinite(out["Avg Eec Loss"])
    (trace,) = profile.glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert fails or any(n.startswith("aten::conv") for n in names)
    assert f"[profile] trace written to {trace}" in capsys.readouterr().out
    # the trace is stopped: a second run can trace again
    from disentangle_mlp_tpu_torch.utils import runtime
    assert runtime._profiler is None


def _family_argv(tmp_path, dataset, *extra):
    """The trainer CLI on a family at toy size: --model stays betavaegan,
    which the family datasets override, as in the JAX package."""
    return ["--model", "betavaegan", "--dataset", dataset, "--name", dataset,
            "--device", "cpu", "--n_hidden", "8", "--dtype", "float32",
            "--save_path", str(tmp_path / "%"),
            "--log_path", str(tmp_path / "%" / "log"), *extra]


def _family_log(tmp_path, dataset):
    (log_file,) = glob.glob(str(tmp_path / dataset / "log" / "log_*.json"))
    with open(log_file) as f:
        return json.load(f)["output"]


def test_port_trainer_trains_the_mnist_family_and_resumes(tmp_path, capsys):
    """--dataset mnist on MNIST's idx files: 2 epochs, the family's record
    keys and epoch line, FID 'N/A' with --calc_fid True, a checkpoint an
    epoch; one --load_path resumes after its epoch, two raise."""
    from tests.test_torch_port_data import _mnist_files

    data = tmp_path / "mnist"
    _mnist_files(data, 8)
    argv = _family_argv(tmp_path, "mnist", "--image_root_train", str(data),
                        "--input_channels", "1", "--img_size", "28",
                        "--batch_size_train", "4", "--calc_fid", "True",
                        "--fid_path_pretrained", _stats_npz(tmp_path))
    out = cli_train.main(argv + ["--epochs", "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("====> Epoch:")]
    assert len(lines) == 2
    assert re.fullmatch(r"====> Epoch: 1 Average loss: -?[\d.]+ \(recon "
                        r"[\d.]+\) FID: N/A \([\d.]+ img/s\)", lines[1])
    records = _family_log(tmp_path, "mnist")
    assert [list(r) for r in records] == [["Epoch", "Avg Loss",
                                           "Avg Recon Loss", "FID"]] * 2
    assert [r["FID"] for r in records] == ["N/A", "N/A"]
    assert np.isfinite(out["Avg Loss"]) and out["images_per_sec"] > 0
    assert set(out["step_metrics"]) == {"loss", "errD", "recon", "D_x"}
    models = tmp_path / "mnist" / "models"
    assert sorted(os.listdir(models)) == ["model_1", "model_2"]
    cli_train.main(argv + ["--epochs", "3", "--load_path",
                           str(models / "model_2")])
    epochs = [ln.split()[2] for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("====> Epoch:")]
    assert epochs == ["2"]
    with pytest.raises(ValueError, match="exactly one --load_path"):
        cli_train.main(argv + ["--load_path", str(models / "model_1"),
                               str(models / "model_2")])
    with pytest.raises(ValueError, match="--input_channels 1"):
        cli_train.main(argv + ["--input_channels", "3"])


def test_port_trainer_trains_the_birds_family_with_fid(tmp_path, capsys):
    """--dataset birds at 128×128: FID over the decoded samples against a
    stats file each epoch, finite, its sample PNGs written; a smaller
    --img_size is refused as the JAX package refuses it."""
    argv = _family_argv(tmp_path, "birds", "--img_size", "128",
                        "--synthetic_data", "True",
                        "--synthetic_train_size", "4",
                        "--batch_size_train", "2", "--calc_fid", "True",
                        "--n_samples", "3", "--checkpoint_every", "0",
                        "--fid_path_pretrained", _stats_npz(tmp_path))
    out = cli_train.main(argv + ["--epochs", "1"])
    assert isinstance(out["FID"], float) and np.isfinite(out["FID"])
    assert np.isfinite(out["Avg Recon Loss"])
    (line,) = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("====> Epoch:")]
    assert f"FID: {out['FID']}" in line
    (rec,) = _family_log(tmp_path, "birds")
    assert list(rec) == ["Epoch", "Avg Loss", "Avg Recon Loss", "FID"]
    pngs = glob.glob(str(tmp_path / "birds" / "fid_results" / "samples"
                         / "sample_*_0.png"))
    assert len(pngs) == 3
    with pytest.raises(ValueError, match="--img_size 128"):
        cli_train.main(argv + ["--epochs", "1", "--img_size", "64"])


def test_port_trainer_scores_fid_against_a_directory_of_images(tmp_path,
                                                               capsys):
    """--fid_path_pretrained naming a directory: its statistics are computed
    (eval/fid.py statistics_from_dir) and every epoch gets a finite FID;
    an empty directory degrades to 'N/A' like a missing .npz."""
    from disentangle_mlp_tpu_torch.utils.image_io import write_png

    stats = tmp_path / "stats_dir"
    stats.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        write_png(str(stats / f"{i}.png"),
                  rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8))
    out = cli_train.main(_argv(tmp_path, "--calc_fid", "True",
                               "--n_samples", "3",
                               "--fid_path_pretrained", str(stats),
                               "--checkpoint_every", "0"))
    assert isinstance(out["FID"], float) and np.isfinite(out["FID"])
    empty = tmp_path / "empty"
    empty.mkdir()
    out = cli_train.main(_argv(tmp_path, "--calc_fid", "True",
                               "--n_samples", "3", "--name", "e",
                               "--fid_path_pretrained", str(empty),
                               "--checkpoint_every", "0"))
    assert out["FID"] == "N/A"
    assert "[fid] skipped: no *.jpg/*.png" in capsys.readouterr().out


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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "msgpack")
             or m == "disentangle_mlp_tpu" or m.startswith("disentangle_mlp_tpu.")
             or m.split(".")[0] == "PIL")
print(len(names), bad)
sys.exit(1 if bad or len(names) < 48 else 0)
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


# ---------------------------------------------------------------------------
# the plain VAE and the DCGAN through the trainer, and the evaluation sweep
# ---------------------------------------------------------------------------

# log schema, checkpoint state names and the log_interval line's start of
# each experiment, as the JAX package writes them (train/loop.py)
EXPERIMENT_LOGS = {
    "vae": (["Epoch", "Avg Loss", "FID"], {"model"}, "Train Epoch: {e} [0/2]"),
    "gan": (["Epoch", "Avg Loss G", "Avg Loss E", "FID"], {"g", "d"},
            "[{e}/2][0/2] Loss_D: "),
}


@pytest.mark.parametrize("model", sorted(EXPERIMENT_LOGS))
def test_port_trainer_cli_trains_vae_and_gan(tmp_path, capsys, model):
    schema, state_names, progress = EXPERIMENT_LOGS[model]
    out = cli_train.main(_argv(tmp_path, "--epochs", "2", "--log_interval",
                               "1", model=model))
    lines = capsys.readouterr().out.splitlines()
    for e in (0, 1):
        assert any(ln.startswith(progress.format(e=e)) for ln in lines)
        assert len([ln for ln in lines
                    if ln.startswith(f"====> Epoch: {e} ")]) == 1
    (log_file,) = glob.glob(str(tmp_path / "port_cli" / "log" / "log_*.json"))
    with open(log_file) as f:
        records = json.load(f)["output"]
    assert [list(r) for r in records] == [schema, schema]
    assert [r["Epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r[k]) for r in records for k in schema[1:-1])
    assert out["sweep"] == [] and out["images_per_sec"] > 0
    assert all(np.isfinite(v) for v in out["step_metrics"].values())
    models = tmp_path / "port_cli" / "models"
    assert sorted(os.listdir(models)) == ["model_1", "model_2"]
    raw = msgpack.load(str(models / "model_2"))
    assert raw["epoch"] == 2 and set(raw["states"]) == state_names


def _jax_sweep_epochs(epochs, monkeypatch):
    """The epochs under which the JAX package's _eval_sweep files
    checkpoints saved at ``epochs``, with its loading and writing stubbed
    out."""
    paths = [f"m{i}" for i in range(len(epochs))]
    seen = []
    monkeypatch.setattr(jax_loop, "load_checkpoint",
                        lambda p, template: (epochs[paths.index(p)], template))
    monkeypatch.setattr(jax_loop, "generate_samples",
                        lambda fn, epoch, *a, **k: seen.append(epoch))
    cfg = SimpleNamespace(load_path=paths, calc_fid=False, test_recons=False,
                          test_samples=True, n_hidden=N_HIDDEN, seed=0,
                          test_results_path_samples="")
    jax_loop._eval_sweep(cfg, {}, None, None, None, assign=lambda s: None)
    return seen


@pytest.mark.parametrize("epochs", [[1, 1], [3, 3, 1, 5, 5, 9], [2, 7, 4]])
def test_port_sweep_epoch_rule_matches_jax(monkeypatch, epochs):
    previous, got = 0, []
    for e in epochs:
        previous = loop.sweep_epoch(e, previous)
        got.append(previous)
    assert got == _jax_sweep_epochs(epochs, monkeypatch)


@pytest.mark.parametrize("model", ["vae", "gan", "betavaegan"])
def test_port_evaluate_sweeps_two_checkpoints_of_one_epoch(
        tmp_path, capsys, monkeypatch, model):
    """cli/evaluate.py over two checkpoints both saved at epoch 1: FID,
    sample grids and (for the models that encode) reconstruction grids of
    each, filed under the de-collided epochs of the JAX package's rule."""
    stats = _stats_npz(tmp_path)
    cli_train.main(_argv(tmp_path, "--epochs", "1", model=model))
    first = tmp_path / "port_cli" / "models" / "model_1"
    second = tmp_path / "copy" / "model_1"
    second.parent.mkdir()
    shutil.copy(first, second)
    capsys.readouterr()
    out = cli_evaluate.main(_argv(
        tmp_path, "--calc_fid", "True", "--n_samples", str(N_SAMPLES),
        "--fid_path_pretrained", stats, "--test_recons", "True",
        "--test_samples", "True", "--load_path", str(first), str(second),
        model=model, name="port_eval"))
    want = _jax_sweep_epochs([1, 1], monkeypatch)
    assert [r["Epoch"] for r in out["sweep"]] == want == [1, 2]
    assert [r["path"] for r in out["sweep"]] == [str(first), str(second)]
    assert all(isinstance(r["FID"], float) and np.isfinite(r["FID"])
               for r in out["sweep"])
    printed = capsys.readouterr().out
    assert printed.count("Calculated FID:") == 2
    assert "====> Epoch:" not in printed  # nothing trained
    run = tmp_path / "port_eval"
    encodes = model != "gan"
    for e in want:
        assert os.path.isfile(run / "test_results" / "samples"
                              / f"sample_{e}.png")
        for d, name in (("recons", "recon"), ("originals", "original")):
            assert os.path.isfile(run / "test_results" / d
                                  / f"{name}_{e}.png") == encodes
        assert len(glob.glob(str(run / "fid_results" / "samples"
                                 / f"sample_*_{e}.png"))) == N_SAMPLES


@pytest.mark.parametrize("argv", [["--model", "vae"], ["--model", "gan"],
                                  ["evaluate"], ["bo"], ["reproduce"],
                                  ["convert"]])
def test_port_new_entry_points_default_to_cuda(tmp_path, monkeypatch, argv):
    """Without --device cpu the VAE, the GAN, the evaluation sweep, the β
    search, the reproduction and the checkpoint conversion ask for CUDA,
    and raise where it is missing."""
    from disentangle_mlp_tpu_torch.cli import bo, convert, reproduce

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = [a for a in _argv(tmp_path) if a not in ("--device", "cpu")]
    model = base.pop(base.index("--model") + 1)
    base.remove("--model")
    main, extra = {
        "evaluate": (cli_evaluate.main, ["--model", model]),
        "bo": (bo.main, ["--posterior_only", "False"]),
        "reproduce": (reproduce.main, ["--skip_train"]),
        "convert": (convert.main, ["--torch_checkpoint",
                                   str(tmp_path / "missing.tar")]),
    }.get(argv[0], (cli_train.main, argv))
    with pytest.raises(RuntimeError, match="cuda"):
        main(base + extra)


def test_port_evaluate_refuses_family_datasets(tmp_path):
    with pytest.raises(SystemExit, match="celebA-only"):
        cli_evaluate.main(_argv(tmp_path, "--dataset", "mnist",
                                "--load_path", "m"))
