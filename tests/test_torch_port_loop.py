"""The port's data feed, trainer CLI, checkpoints and import isolation
(disentangle_mlp_tpu_torch: data/pipeline.py, train/loop.py, cli/train.py,
utils/checkpoint.py), on the CPU at toy width."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from disentangle_mlp_tpu.config import Config as JaxConfig
from disentangle_mlp_tpu.data.pipeline import \
    get_data_loader as jax_get_data_loader
from disentangle_mlp_tpu_torch.cli import profile_step
from disentangle_mlp_tpu_torch.cli import train as cli_train
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.data.pipeline import get_data_loader
from disentangle_mlp_tpu_torch.train import loop
from tests.test_torch_compat import (DEC_CH, DISC_CH, FEAT_DIM, HEAD, IMG,
                                     N_HIDDEN, N_Z, RS)

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
    (["--calc_fid", "True"], NotImplementedError, "not yet ported"),
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
    """Every module of the port imports without JAX, flax, optax or the JAX
    package (a subprocess: this test process has them loaded already)."""
    code = r"""
import importlib, pkgutil, sys
import disentangle_mlp_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
             or m == "disentangle_mlp_tpu" or m.startswith("disentangle_mlp_tpu."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
