"""The port's public API (disentangle_mlp_tpu_torch/__init__.py,
helper_functions.py, config.py ``EnvSetter``/``config_from_args``) against
the JAX package's: the same lazy top-level names, resolved to the port's
objects, with a cheap package import; the reference's ``from
helper_functions import *`` shim writing the files the JAX package writes;
the same Config from the same argv."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import disentangle_mlp_tpu as jax_pkg
import disentangle_mlp_tpu_torch as pkg
from disentangle_mlp_tpu import config as jax_config
from disentangle_mlp_tpu import helper_functions as jax_helpers
from disentangle_mlp_tpu_torch import config, helper_functions
from disentangle_mlp_tpu_torch.data import pipeline
from disentangle_mlp_tpu_torch.eval import fid, reproduce
from disentangle_mlp_tpu_torch.train import loop
from disentangle_mlp_tpu_torch.utils import logger
from tests.test_torch_port_loop import REPO

# the JAX package's lazy names (its __init__.py) and the port module each
# must resolve into
NAMES = {
    "Config": config, "EnvSetter": config, "config_from_args": config,
    "run_vae": loop, "run_gan": loop, "run_vaegan": loop,
    "run_family": loop, "RUNNERS": loop,
    "run_reproduction": reproduce,
    "get_fid": fid, "get_fid_from_samples": fid, "frechet_distance": fid,
    "get_data_loader": pipeline, "Logger": logger,
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_port_lazy_names_resolve_to_the_port(name):
    assert hasattr(jax_pkg, name)  # the JAX package has the same name
    assert getattr(pkg, name) is getattr(NAMES[name], name)


def test_port_lazy_api_is_usable_and_the_import_cheap():
    assert pkg.Config().n_hidden == 128
    assert set(pkg.RUNNERS) == {"vae", "gan", "betavaegan", "vaegan"}
    with pytest.raises(AttributeError):
        pkg.not_a_name  # noqa: B018
    code = ("import sys, disentangle_mlp_tpu_torch as p; "
            "print(p.__version__, 'torch' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [jax_pkg.__version__, "False"]


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGB"))


def test_port_helper_functions_shim_writes_the_jax_files(tmp_path):
    """The four names of the shim, fed the same images as the JAX
    package's: the same file names, the same pixels."""
    assert set(helper_functions.__all__) == set(jax_helpers.__all__)
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)

    def port_fn(z):
        return torch.from_numpy(images[:z.shape[0]])

    def jax_fn(z):
        return images[:np.asarray(z).shape[0]]

    loader = [(images, 1)]
    for side, fn, mod, kw in (("port", port_fn, helper_functions,
                               {"device": "cpu"}),
                              ("jax", jax_fn, jax_helpers, {})):
        d = tmp_path / side
        d.mkdir()
        mod.generate_fid_samples(fn, 3, 2, 16, str(d), **kw)
        mod.generate_samples(fn, 4, 2, 16, str(d), **kw)
        data = [(torch.from_numpy(x), y) for x, y in loader] \
            if side == "port" else loader
        mod.gen_reconstructions(lambda x: x, data, 5, str(d),
                                path_for_originals=str(d))
        mod.gen_fid_reconstructions(lambda x: x, data, 6, str(d))
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert {"sample_0_3.png", "sample_1_3.png", "sample_4.png",
            "recon_5.png", "original_5.png", "recon_0_6.png",
            "recon_1_6.png"} == set(files)
    for f in files:
        np.testing.assert_array_equal(_pixels(tmp_path / "port" / f),
                                      _pixels(tmp_path / "jax" / f),
                                      err_msg=f)


def _argv(tmp_path):
    return ["--name", "api", "--beta", "25", "--n_z", "8", "4", "4",
            "--calc_fid", "False", "--freeze_mode", "intent",
            "--save_path", str(tmp_path / "%"),
            "--log_path", str(tmp_path / "%/log")]


@pytest.mark.parametrize("make_dirs", [True, False])
def test_port_envsetter_and_config_from_args_equal_jax(tmp_path, make_dirs):
    argv = _argv(tmp_path)
    got = config.EnvSetter("d", argv=argv, make_dirs=make_dirs).get_parser()
    want = jax_config.EnvSetter("d", argv=argv,
                                make_dirs=make_dirs).get_parser()
    assert isinstance(got, config.Config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(config.config_from_args(
        argv, make_dirs=make_dirs)) == dataclasses.asdict(want)
    assert got.save_path == str(tmp_path / "api")
    assert got.beta == 25.0 and got.n_z == [8, 4, 4]
    assert (tmp_path / "api" / "fid_results" / "recons").is_dir() == \
        make_dirs
