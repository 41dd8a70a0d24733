"""PyTorch port of disentangle_mlp_tpu for NVIDIA Hopper GPUs (see README).

The top-level names are those of the JAX package's ``__init__.py``,
resolved lazily to the port's objects, so ``import
disentangle_mlp_tpu_torch`` stays cheap (no torch import until a name is
used)."""

__version__ = "0.1.0"

# name → the port's module holding it
_LAZY = {
    "Config": "config", "EnvSetter": "config", "config_from_args": "config",
    "run_vae": "train.loop", "run_gan": "train.loop",
    "run_vaegan": "train.loop", "run_family": "train.loop",
    "RUNNERS": "train.loop",
    "run_reproduction": "eval.reproduce",
    "get_fid": "eval.fid", "get_fid_from_samples": "eval.fid",
    "frechet_distance": "eval.fid",
    "get_data_loader": "data.pipeline",
    "Logger": "utils.logger",
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
