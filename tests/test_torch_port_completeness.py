"""The port (disentangle_mlp_tpu_torch) does all that the JAX package does:

(a) every module of the JAX package has a counterpart at the same relative
    path, or in the map of moved modules below;
(b) every name in a JAX subpackage's ``__all__`` resolves in the matching
    port subpackage, under the port's own name where the JAX name is a
    flax or functional idiom;
(c) every ``--flag`` of a JAX CLI is accepted by the port's CLI of the
    same name (the port may add flags; today ``--device``);
(d) every ``dmt-X`` console script has a ``dmt-torch-X`` twin whose
    target imports and is callable;
(e) with ``jax``, ``flax``, ``optax`` and the JAX package blocked, every
    module of the port and ``chip_smoke.py`` import.

The JAX package is read from disk (paths, ``ast``) for (a), (b) and (d);
only (c) imports its CLIs."""

import argparse
import ast
import importlib
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

from disentangle_mlp_tpu_torch.models.nvae import FLAGS as NVAE_FLAGS

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "disentangle_mlp_tpu"
PORT_PKG = REPO / "disentangle_mlp_tpu_torch"

# JAX module (relative path) → the port's module, where the port's differs;
# None: no counterpart, with the reason
MOVED = {
    "ops/pallas/matmul_fused.py": "ops/fused_linear.py",
    "ops/pallas/image_ops.py": "ops/image_ops.py",
    "ops/pallas/__init__.py": None,  # the Pallas kernels' package; the
    # port's kernels live in ops/ beside their CUDA sources in csrc/
}

# JAX subpackage name → the port's name, where they differ; None: no
# counterpart, with the reason
RENAMED = {
    "models": {"TorchConv": "Conv", "TorchConvTranspose": "ConvTranspose",
               "TorchLinear": "Linear"},
    "train": {"create_vae_experiment": "VAEExperiment",
              "create_gan_experiment": "GANExperiment",
              "create_vaegan_experiment": "VAEGANExperiment",
              "make_adam": "Adam", "ModelState": "model_state",
              "init_model_state": "load_model_state"},
    # jax.sharding objects: the port shards with torch.distributed ranks,
    # one process a device, and places no array by a sharding
    "parallel": {"batch_sharding": None, "replicated_sharding": None},
}


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _all_names(init: Path):
    for node in ast.parse(init.read_text()).body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__"
                        for t in node.targets)):
            return ast.literal_eval(node.value)
    return None


def _subpackages():
    return sorted(p.parent.name for p in JAX_PKG.glob("*/__init__.py")
                  if _all_names(p) is not None)


def _clis():
    return sorted(p.stem for p in (JAX_PKG / "cli").glob("*.py")
                  if any(isinstance(n, ast.FunctionDef) and n.name == "main"
                         for n in ast.parse(p.read_text()).body))


def _scripts():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_jax_module_has_a_port_counterpart(rel):
    want = MOVED.get(rel, rel)
    if want is not None:
        assert (PORT_PKG / want).is_file(), f"no port module for {rel}"


def test_the_moved_modules_map_is_current():
    """Each entry of the map names a JAX module that exists, and the JAX
    module's own path is absent from the port (else the entry is stale)."""
    for rel, want in MOVED.items():
        assert (JAX_PKG / rel).is_file(), rel
        assert not (PORT_PKG / rel).exists(), rel


@pytest.mark.parametrize("sub", _subpackages())
def test_every_jax_subpackage_name_resolves_in_the_port(sub):
    names = _all_names(JAX_PKG / sub / "__init__.py")
    renamed = RENAMED.get(sub, {})
    assert set(renamed) <= set(names), "stale entries in the rename map"
    port = importlib.import_module(f"disentangle_mlp_tpu_torch.{sub}")
    want = [renamed.get(n, n) for n in names]
    want = [n for n in want if n is not None]
    missing = [n for n in want if not hasattr(port, n)]
    assert not missing, f"{sub}: {missing}"
    assert set(want) <= set(port.__all__)


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _flags(module: str, monkeypatch) -> set:
    """The ``--`` option strings of ``module.main``'s parser, taken at its
    ``parse_args`` call (nothing after it runs)."""
    def stop(self, *a, **k):
        raise _Parsed(self)

    mod = importlib.import_module(module)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as e:
        mod.main([])
    return {s for a in e.value.parser._actions for s in a.option_strings
            if s.startswith("--")}


@pytest.mark.parametrize("cli", _clis())
def test_every_jax_cli_flag_is_accepted_by_the_port(cli, monkeypatch):
    jax_flags = _flags(f"disentangle_mlp_tpu.cli.{cli}", monkeypatch)
    port_flags = _flags(f"disentangle_mlp_tpu_torch.cli.{cli}", monkeypatch)
    assert jax_flags, cli
    assert not jax_flags - port_flags, sorted(jax_flags - port_flags)
    # the port's own: --device, and NVAE's flags (a model the JAX package
    # does not have)
    assert port_flags - jax_flags <= {"--device"} | {
        f"--{n}" for n in NVAE_FLAGS}


@pytest.mark.parametrize("script", sorted(
    s for s in _scripts() if not s.startswith("dmt-torch-")))
def test_every_script_has_a_port_twin(script):
    scripts = _scripts()
    twin = "dmt-torch-" + script[len("dmt-"):]
    assert twin in scripts, twin
    jax_mod, jax_fn = scripts[script].split(":")
    mod, fn = scripts[twin].split(":")
    assert jax_mod.startswith("disentangle_mlp_tpu.")
    assert mod == "disentangle_mlp_tpu_torch." + jax_mod.split(".", 1)[1]
    assert fn == jax_fn
    assert callable(getattr(importlib.import_module(mod), fn))


BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "disentangle_mlp_tpu"):
    sys.modules[name] = None  # any import of these now raises
import disentangle_mlp_tpu_torch as pkg
names = [m.name
         for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax",
                                       "disentangle_mlp_tpu")
                and sys.modules[m] is not None)
print(len(names), leaked)
"""


def test_the_port_and_chip_smoke_import_without_jax():
    res = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n, leaked = res.stdout.split(maxsplit=1)
    assert int(n) >= len(list(PORT_PKG.rglob("*.py"))) - 1
    assert leaked.strip() == "[]"
