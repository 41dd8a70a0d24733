"""The port's float32 precision policy (utils/runtime.py::float32_policy):
every entry point turns TF32 off for cuBLAS matmuls and cuDNN before it
builds a model, so a float32 run on the card computes float32, as the
port's float32 tolerances assume.

On the CPU: the policy leaves both switches off from both on; each CLI
(train, evaluate, stats, bo, reproduce, convert, profile_step) has set it
by the time its first model (an experiment or the FID Inception) is
constructed (the construction is intercepted and nothing is trained); and
the ranks ``parallel.spawn`` starts run under it.

On the card (``-m cuda``; this file imports no JAX): the MNIST family's
float32 step with the switches at PyTorch's defaults (cuDNN TF32 on) until
the trainer's entry point parses its flags, against the same steps on the
CPU within tests/test_torch_port_card_training.py's float32 card
tolerances. Under TF32 the card's convolutions round their operands to a
10-bit mantissa and the steps leave those tolerances.

The size of that difference is printed by this file's ``__main__`` on the
card: the MNIST family (batch 256) and the full-width β-VAE-GAN 'observed'
(float32, batch 32), 3 steps from one initialization with the same draws,
on the CPU, on the card with TF32 off and on the card under PyTorch's
default switches (the metrics' largest relative differences from the CPU
after steps 1 and 3, and each parameter's largest |Δ|), then the graphed
ms/step at batch 256 of both on the card, TF32 off and on:

    PYTHONPATH=. python tests/test_torch_port_precision.py
"""

import json
import time

import numpy as np
import pytest
import torch

from disentangle_mlp_tpu_torch.cli import (bo, convert, evaluate,
                                           profile_step, reproduce, stats,
                                           train)
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.eval import fid
from disentangle_mlp_tpu_torch.eval.inception import InceptionV3
from disentangle_mlp_tpu_torch.train.families import FamilyExperiment
from disentangle_mlp_tpu_torch.train.gan import GANExperiment
from disentangle_mlp_tpu_torch.train.vae import VAEExperiment
from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
from disentangle_mlp_tpu_torch.utils import runtime
# top-level names, as pytest puts tests/ on the path: the GPU machine has
# another package named ``tests`` installed
from test_torch_port_card_training import (CANCELLED_ATOL, METRIC_RTOL,
                                           PARAM_ATOL, STATS_ATOL, STEPS,
                                           _compare, _modules)

LR = 1e-3
# the card test's MNIST batch
MNIST_BATCH = 4
TOY_FLAGS = ["--n_hidden", "16", "--n_z", "8", "4", "4",
             "--representation_size", "4", "--head_width", "32",
             "--decoder_channels", "8", "8", "8", "--disc_channels", "4", "8",
             "8", "8", "--disc_feature_dim", "32", "--img_size", "32"]
MODELS = (VAEGANExperiment, VAEExperiment, GANExperiment, FamilyExperiment,
          InceptionV3)


def switches() -> tuple:
    """(cuBLAS matmul TF32, cuDNN TF32)."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def set_switches(matmul: bool, cudnn: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


@pytest.fixture
def saved_switches():
    prev = switches()
    yield
    set_switches(*prev)


def test_port_float32_policy_turns_tf32_off(saved_switches):
    set_switches(True, True)
    runtime.float32_policy()
    assert switches() == (False, False)
    runtime.float32_policy()
    assert switches() == (False, False)


class _Built(BaseException):
    """Raised where a model would be built; no CLI catches it."""


def _run_to_first_model(monkeypatch, call) -> tuple:
    """``call()`` from both switches on, stopped at the first model it
    constructs; returns the switches at that moment."""
    seen = []

    def intercept(self, *args, **kwargs):
        seen.append(switches())
        raise _Built(getattr(self, "__name__", type(self).__name__))

    for cls in MODELS:
        monkeypatch.setattr(cls, "__init__", intercept)
    # the FID Inception is built once a process and device: its getter
    monkeypatch.setattr(fid, "_inception",
                        lambda device: intercept(InceptionV3))
    set_switches(True, True)
    with pytest.raises(_Built):
        call()
    assert len(seen) == 1
    return seen[0]


def _cli_calls(tmp_path, monkeypatch) -> dict:
    paths = ["--save_path", str(tmp_path / "%"),
             "--log_path", str(tmp_path / "%" / "log")]
    base = ["--device", "cpu", "--synthetic_data", "True",
            "--synthetic_train_size", "8", "--batch_size_train", "4",
            *paths, *TOY_FLAGS]

    def converted(*args, **kwargs):
        return {"epoch": 0}

    def profile_main():
        # profile_step measures a card: let its checks pass here
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        profile_step.main(["--name", "p", "--model", "vae", *TOY_FLAGS])

    def convert_main():
        monkeypatch.setattr(convert, "convert_reference_checkpoint",
                            converted)
        convert.main(["--name", "c", "--device", "cpu", "--torch_checkpoint",
                      str(tmp_path / "ref.tar"), *TOY_FLAGS])

    return {
        "train": lambda: train.main(["--name", "t", "--calc_fid", "False",
                                     *base]),
        "evaluate": lambda: evaluate.main(["--name", "e", "--calc_fid",
                                           "True", *base]),
        "stats": lambda: stats.main(["--name", "s", "--max_images", "8",
                                     "--stats_out",
                                     str(tmp_path / "s.npz"), *base]),
        "bo": lambda: bo.main(["--name", "b", "--posterior_only", "False",
                               "--bo_iterations", "1", "--bo_epochs", "1",
                               "--checkpoint_every", "0", *base]),
        "reproduce": lambda: reproduce.main(
            ["--name", "r", "--stats_images", "8", "--calib_images", "8",
             "--epochs", "1", "--stats_out", str(tmp_path / "r.npz"),
             "--report_out", str(tmp_path / "r.json"), *base]),
        "convert": convert_main,
        "profile_step": profile_main,
    }


@pytest.mark.parametrize("cli", ["train", "evaluate", "stats", "bo",
                                 "reproduce", "convert", "profile_step"])
def test_port_cli_sets_the_float32_policy_before_its_first_model(
        cli, tmp_path, monkeypatch, saved_switches):
    call = _cli_calls(tmp_path, monkeypatch)[cli]
    assert _run_to_first_model(monkeypatch, call) == (False, False)


def _rank_switches(mesh) -> tuple:
    return switches()


def test_port_spawned_ranks_set_the_float32_policy(saved_switches):
    """A spawned rank starts from PyTorch's defaults (cuDNN TF32 on) and
    runs its function under the policy."""
    from disentangle_mlp_tpu_torch.parallel import make_mesh, spawn

    assert spawn(_rank_switches, make_mesh(2, device="cpu")) == [
        (False, False)] * 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _pytorch_defaults() -> None:
    """PyTorch's own switches: TF32 off for matmuls, on for cuDNN."""
    set_switches(False, True)


def mnist_case(batch: int):
    """The MNIST family's trainer flags, a batch and STEPS draws, from a
    seed."""
    argv = ["--name", "card_mnist", "--dataset", "mnist", "--img_size", "28",
            "--input_channels", "1", "--batch_size_train", str(batch),
            "--dtype", "float32", "--lr", str(LR), "--beta", "1.0"]
    rng = np.random.default_rng(0)
    x = (rng.uniform(0, 1, (batch, 28, 28, 1)) - 0.1307) / 0.3081
    z = 7 * 7 * 4
    draws = [{"labels": {"real": 0.9, "fake": 0.1},
              "z_prior": rng.normal(size=(batch, z)),
              "eps": rng.normal(size=(batch, z))} for _ in range(STEPS)]
    return argv, x, draws


def vaegan_case(batch: int):
    """The full-width β-VAE-GAN's, float32."""
    argv = ["--name", "card_bvg", "--model", "betavaegan",
            "--batch_size_train", str(batch), "--dtype", "float32",
            "--beta", "25", "--freeze_mode", "observed"]
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (batch, 64, 64, 3))
    draws = [{"labels": {"real": 0.9, "fake": 0.1},
              **{k: rng.normal(size=(batch, 128))
                 for k in ("noise", "eps_dec", "eps_enc")}}
             for _ in range(STEPS)]
    return argv, x, draws


def _steps(exp, x, draws) -> list:
    xt = torch.from_numpy(x.astype(np.float32)).to(exp.device)
    return [{k: v.item() for k, v in exp.train_step(xt, draws={
        k: (v if k == "labels" else np.asarray(v, np.float32))
        for k, v in d.items()}).items()} for d in draws]


def _build(argv, device):
    """The experiment the trainer would build from ``argv`` on
    ``device``, through its entry point's flag parsing."""
    _, dev, kwargs = train.parse("trainer", [*argv, "--device", device])
    cfg = Config(**kwargs)
    make = FamilyExperiment if cfg.dataset == "mnist" else VAEGANExperiment
    return make(cfg, dev)


@pytest.mark.cuda
def test_port_mnist_float32_step_through_the_entry_point_matches_the_cpu(
        card, saved_switches):
    """From PyTorch's default switches, the trainer's entry point leaves
    TF32 off, and the MNIST family's float32 steps on the card match the
    CPU's within the float32 card tolerances."""
    argv, x, draws = mnist_case(MNIST_BATCH)
    runs = {}
    for dev in ("cpu", "cuda"):
        _pytorch_defaults()
        exp = _build(argv, dev)
        assert switches() == (False, False)
        runs[dev] = (exp, _steps(exp, x, draws))
    _compare(runs, "mnist", METRIC_RTOL, PARAM_ATOL, CANCELLED_ATOL,
             STATS_ATOL)


# ---------------------------------------------------------------------------
# __main__: the size of the difference TF32 makes, on the card
# ---------------------------------------------------------------------------

def _differences(runs: dict, ref: str = "cpu") -> dict:
    """Each run's metrics' largest relative difference from ``ref`` after
    step 1 and after the last, and its leaves' largest |Δ| (parameters;
    running statistics)."""
    exp0, m0 = runs[ref]
    out = {}
    for key, (exp, m) in runs.items():
        if key == ref:
            continue
        rel = [{k: abs(a[k] / b[k] - 1.0) for k in b} for a, b in zip(m, m0)]
        leaves = {"params": 0.0, "stats": 0.0}
        for (name, p), (_, q) in zip(_modules(exp), _modules(exp0)):
            d = (p.detach().cpu().double() - q.detach().cpu().double()
                 ).abs().max().item()
            kind = "stats" if "running_" in name else "params"
            leaves[kind] = max(leaves[kind], d)
        out[key] = {"step1": rel[0], "step1_max": max(rel[0].values()),
                    f"step{len(m)}": rel[-1],
                    f"step{len(m)}_max": max(rel[-1].values()),
                    "leaves_max_abs": leaves}
    return out


def _graph_ms(exp, x, steps: int = 20) -> float:
    """ms/step of the trainer's one-step CUDA graph replays."""
    from disentangle_mlp_tpu_torch.train.scan import make_multi_step

    xs = torch.from_numpy(x.astype(np.float32)).cuda()[None]
    multi = make_multi_step(exp, 1)
    multi.capture(xs)
    for _ in range(4):
        multi(xs)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(steps):
        multi(xs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def measure(name: str, case, batch: int, time_batch: int = 0) -> dict:
    """The three runs of ``case(batch)`` and, unless ``time_batch`` is 0,
    the graphed ms/step at ``time_batch``, TF32 off and under PyTorch's
    defaults."""
    argv, x, draws = case(batch)
    runs, t0 = {}, time.perf_counter()
    for key, dev, defaults in (("cpu", "cpu", False),
                               ("card_tf32_off", "cuda", False),
                               ("card_pytorch_defaults", "cuda", True)):
        exp = _build(argv, dev)  # the policy: TF32 off
        if defaults:
            _pytorch_defaults()
        runs[key] = (exp, _steps(exp, x, draws))
    out = {"case": name, "batch": batch, "steps": STEPS,
           "seconds": time.perf_counter() - t0, **_differences(runs)}
    if not time_batch:
        return out
    argv, x, _ = case(time_batch)
    for key, defaults in (("ms_tf32_off", False),
                          ("ms_pytorch_defaults", True)):
        exp = _build(argv, "cuda")
        if defaults:
            _pytorch_defaults()
        out[key] = _graph_ms(exp, x)
        del exp
        torch.cuda.empty_cache()
    out["time_batch"] = time_batch
    return out


def main() -> None:
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; torch {torch.__version__}", flush=True)
    for name, case, batch, time_batch in (
            ("mnist", mnist_case, MNIST_BATCH, 0),
            ("mnist", mnist_case, 256, 256),
            ("betavaegan observed", vaegan_case, 32, 256)):
        print(json.dumps(measure(name, case, batch, time_batch)),
              flush=True)


if __name__ == "__main__":
    main()
