"""The port's reference-checkpoint conversion (disentangle_mlp_tpu_torch:
utils/torch_compat.py, cli/convert.py) against the JAX package's, on the
CPU at toy width. The reference's layouts are the torch modules of
tests/test_torch_compat.py (its exact state_dict key names), randomly
initialized and saved as the reference saves them:

- the converted trees equal the JAX package's exactly, for the VAE, the
  DCGAN and the β-VAE-GAN, ``module.`` prefixes included;
- the port's models on the converted weights give the reference modules'
  eval-mode outputs (atol 2e-3, rtol 1e-3, as the JAX package's test);
- ``cli.convert`` writes the bytes the JAX package's ``dmt-convert`` writes
  for the same ``.tar`` and flags (both freeze modes, bf16 moments);
- the port's trainer resumes from the result at its epoch.
"""

import functools

import numpy as np
import pytest
import torch

from disentangle_mlp_tpu.cli import convert as jax_cli_convert
from disentangle_mlp_tpu.config import Config as JaxConfig
from disentangle_mlp_tpu.utils import torch_compat as jax_compat
from disentangle_mlp_tpu_torch.cli import convert as cli_convert
from disentangle_mlp_tpu_torch.cli import train as cli_train
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.models.gan import DiscriminatorCeleba
from disentangle_mlp_tpu_torch.models.vae import VAE
from disentangle_mlp_tpu_torch.utils import torch_compat
from disentangle_mlp_tpu_torch.utils.params import from_jax
from tests.test_torch_compat import (DEC_CH, DISC_CH, FEAT_DIM, HEAD, IMG,
                                     N_HIDDEN, N_Z, RS, RefDisc, RefVAE,
                                     _randomize)
from tests.test_torch_port_loop import TOY_FLAGS

EPOCH = 3
TOL = {"atol": 2e-3, "rtol": 1e-3}
DECODER_KEYS = ("preprocess.", "deconv", "act")


def _toy_config(make=Config, **kw):
    return make(name="conv", n_hidden=N_HIDDEN, n_z=list(N_Z),
                representation_size=RS, head_width=HEAD,
                decoder_channels=list(DEC_CH), disc_channels=list(DISC_CH),
                disc_feature_dim=FEAT_DIM, img_size=IMG, dtype="float32",
                **kw)


@functools.lru_cache(maxsize=None)
def _reference_modules():
    vae, disc = RefVAE(), RefDisc()
    _randomize(vae, 21)
    _randomize(disc, 22)
    return vae, disc


def _prefixed(sd):
    return {f"module.{k}": v for k, v in sd.items()}


def _write_tar(tmp_path, model) -> str:
    """A reference checkpoint as the reference's scripts save it
    (new_vae.py:88-91, new_gan.py:169-174 with DataParallel's prefix,
    new_betavaegan.py:221-228)."""
    vae, disc = _reference_modules()
    vae_sd = vae.state_dict()
    if model == "vae":
        ckpt = {"VAE_model": vae_sd, "optimizer": {}}
    elif model == "gan":
        ckpt = {"netG": _prefixed({k: v for k, v in vae_sd.items()
                                   if k.startswith(DECODER_KEYS)}),
                "netD": _prefixed(disc.state_dict()),
                "optimizerG": {}, "optimizerD": {}}
    else:
        ckpt = {"encoder_decoder_model": vae_sd,
                "discriminator_model": _prefixed(disc.state_dict()),
                "encoder_decoder_optimizer": {},
                "discriminator_optimizer": {}}
    path = tmp_path / f"{model}_model_{EPOCH}.tar"
    torch.save(dict(ckpt, epoch=EPOCH), path)
    return str(path)


def _assert_trees_identical(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_trees_identical(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want and type(got) is type(want), path


@pytest.mark.parametrize("model", ["vae", "gan", "betavaegan"])
def test_port_converted_trees_equal_jax(tmp_path, model):
    tar = _write_tar(tmp_path, model)
    got = torch_compat.convert_reference_checkpoint(tar, model,
                                                    _toy_config())
    want = jax_compat.convert_reference_checkpoint(tar, model,
                                                   _toy_config(JaxConfig))
    _assert_trees_identical(got, want)
    assert got["epoch"] == EPOCH
    assert set(got) == {"epoch", *{"vae": ["model"], "gan": ["g", "d"],
                                   "betavaegan": ["eg", "d"]}[model]}


def test_port_models_on_converted_weights_match_the_reference(tmp_path):
    """The converted β-VAE-GAN trees in the port's float32 VAE and
    discriminator: encoder heads, decoder and discriminator in eval mode
    (running statistics) against the reference modules' .eval()."""
    ref_vae, ref_d = _reference_modules()
    out = torch_compat.convert_reference_checkpoint(
        _write_tar(tmp_path, "betavaegan"), "betavaegan", _toy_config())
    vae = VAE(n_hidden=N_HIDDEN, n_z=N_Z, representation_size=RS,
              head_width=HEAD, decoder_channels=DEC_CH, img_size=IMG)
    disc = DiscriminatorCeleba(channels=DISC_CH, feature_dim=FEAT_DIM,
                               img_size=IMG)
    from_jax(vae, out["eg"]["params"], out["eg"]["batch_stats"])
    from_jax(disc, out["d"]["params"], out["d"]["batch_stats"])
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, IMG, IMG, 3))
                         .astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(2, N_HIDDEN)).astype(np.float32))
    xt = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        pairs = [(vae.encode(x, train=False), ref_vae.encode(xt)),
                 ((vae.decode(z, train=False),),
                  (ref_vae.decode(z).permute(0, 2, 3, 1),)),
                 (disc(x, train=False), ref_d(xt))]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def _convert_argv(tar, out, model, *extra):
    return ["--model", model, "--torch_checkpoint", tar, "--output", out,
            "--name", "conv", *TOY_FLAGS, *extra]


@pytest.mark.parametrize("model, extra", [
    ("vae", []),
    ("gan", []),
    ("betavaegan", []),
    ("betavaegan", ["--freeze_mode", "intent"]),
    ("betavaegan", ["--optimizer_dtype", "bfloat16",
                    "--checkpoint_save_dtype", "bfloat16"]),
])
def test_port_cli_convert_writes_the_jax_bytes(tmp_path, capsys, model,
                                               extra):
    tar = _write_tar(tmp_path, model)
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cli_convert.main(_convert_argv(tar, got, model, "--device",
                                          "cpu", *extra)) == got
    jax_cli_convert.main(_convert_argv(tar, want, model, *extra))
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    assert capsys.readouterr().out.count(
        f"converted epoch-{EPOCH} checkpoint written to") == 2


def test_port_trainer_resumes_from_a_converted_checkpoint(tmp_path, capsys):
    """The converted file keeps the reference's epoch; the trainer resumes
    there and trains the next epoch, saving it."""
    tar = _write_tar(tmp_path, "betavaegan")
    out = str(tmp_path / "converted")
    cli_convert.main(_convert_argv(tar, out, "betavaegan", "--device",
                                   "cpu"))
    capsys.readouterr()
    result = cli_train.main([
        "--model", "betavaegan", "--name", "resumed", "--device", "cpu",
        "--load_path", out, "--epochs", str(EPOCH + 1), "--calc_fid",
        "False", "--synthetic_data", "True", "--synthetic_train_size", "8",
        "--batch_size_train", "4", "--dtype", "float32",
        "--save_path", str(tmp_path / "%"),
        "--log_path", str(tmp_path / "%/log"), *TOY_FLAGS])
    epochs = [ln.split()[2] for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("====> Epoch:")]
    assert epochs == [str(EPOCH)]
    assert np.isfinite(result["Avg Eec Loss"])
    assert (tmp_path / "resumed" / "models" / f"model_{EPOCH + 1}").is_file()
