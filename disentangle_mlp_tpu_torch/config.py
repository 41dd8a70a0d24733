"""Config / flag system + run-directory bootstrap of the PyTorch port.

A copy of ``disentangle_mlp_tpu/config.py`` (``Config``, ``finalize``,
``build_arg_parser``) so the port's trainer has the identical flag surface,
``%`` path templating and output tree. The port imports nothing of the JAX
package, so it keeps its own copy, with the reference's ``EnvSetter`` and
``config_from_args``. ``--mesh_shape N`` trains data-parallel on N devices
(0 = every visible one; train/loop.py ``_setup_parallel``), one rank a
device; the device type is chosen by each CLI's own ``--device`` flag
(cli/train.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import warnings
from pathlib import Path
from typing import List, Optional, Sequence


def str2bool(v) -> bool:
    """Truthiness parser matching the reference (envsetter.py:49-50)."""
    if isinstance(v, bool):
        return v
    return str(v).lower() == "true"


@dataclasses.dataclass
class Config:
    """All run settings. Field names mirror the reference's argparse flags
    (envsetter.py:13-55) so checkpoints/logs/CLI remain drop-in compatible."""

    name: str = "run"
    seed: int = 999
    num_workers: int = 4
    log_interval: int = 10
    # Kept for CLI compatibility; ignored (the trainer's --device selects
    # the GPU).
    use_gpus: str = ""

    load_path: List[str] = dataclasses.field(default_factory=list)
    save_path: str = "./data/%"
    log_path: str = "./data/%/log"
    fid_path_pretrained: str = "/home/shared/evaluation/fid/fid_stats_celeba.npz"

    dataset: str = "celebA"
    image_root_train: str = "/home/shared/data/%/train"
    image_root_val: str = "/home/shared/data/%/val"
    image_root_test: str = "/home/shared/data/%/test"

    epochs: int = 30
    batch_size_train: int = 256
    batch_size_val: int = 256
    batch_size_test: int = 5
    n_samples: int = 1000
    n_z: List[int] = dataclasses.field(default_factory=lambda: [256, 8, 8])
    n_hidden: int = 128
    lr: float = 3e-4
    beta: float = 50.0

    input_channels: int = 3
    img_size: int = 64

    # Model width knobs — defaults are the reference architecture
    # (models/model.py:449-509, 388-408); tests shrink them to keep the
    # identical graph cheap on CPU.
    representation_size: int = 64
    head_width: int = 2048
    decoder_channels: List[int] = dataclasses.field(
        default_factory=lambda: [256, 128, 32])
    disc_channels: List[int] = dataclasses.field(
        default_factory=lambda: [32, 128, 256, 256])
    disc_feature_dim: int = 2048

    calc_fid: bool = True
    to_train: bool = True
    test_recons: bool = False
    test_samples: bool = False

    # --- additions over the reference's flags ----------------------------
    # 'observed' reproduces the reference's logged behaviour: the no-op
    # requires_grad freezing (new_betavaegan.py:131-143,169-180) means both
    # decoder- and encoder-phase updates step ALL VAE parameters. 'intent'
    # trains only the stated sub-network per phase with true torch-freeze
    # semantics (train/vaegan.py docstring).
    freeze_mode: str = "observed"
    # BatchNorm statistics groups. 1 (default) = global-batch statistics.
    # 2 emulates the published runs' torch
    # DataParallel semantics exactly: the 256-batch was split across two
    # K80s, each replica normalized its 128-image half with its OWN batch
    # statistics, and only replica 0's half updated the running stats
    # (new_betavaegan.py:42-44; models/layers.py _ManualBN). Strictest
    # 'observed'-fidelity knob for the β=25 FID ±2 target.
    bn_groups: int = 1
    # Compute dtype for model forward/backward ('bfloat16' or 'float32').
    # Params and optimizer state are always float32.
    dtype: str = "bfloat16"
    # Storage dtype for the Adam moments ('float32' = torch-exact default;
    # 'bfloat16' halves the optimizer state's memory traffic). Update math
    # stays float32 either way (train/common.py).
    # Opt-in perf mode; a documented semantic deviation when enabled.
    optimizer_dtype: str = "float32"
    # Data-parallel mesh size; 0 = all visible devices (one rank a device;
    # on the CPU, N ranks; more CUDA devices than are visible raises).
    mesh_shape: int = 0
    # Replace the image-folder dataset with a synthetic stream (for
    # benchmarking / machines without CelebA).
    synthetic_data: bool = False
    synthetic_train_size: int = 4096
    # Gaussian blur σ (pixels at img 64, scaled with resolution) of the
    # synthetic basis; <0 = the resolution-scaled default, 0 = the legacy
    # per-pixel white basis. The white basis destabilizes training —
    # recon gain is unreachable through a strided-conv encoder, Eec pins
    # at the predict-mean floor (round-4 study, ROUND4.md) — so 0 exists
    # only for the destabilization study harnesses.
    synthetic_basis_sigma: float = -1.0
    # torch.profiler trace directory of the trainer and the reproduction
    # (utils/runtime.py); empty = no trace.
    profile_dir: str = ""
    # Keep only the newest N checkpoints (0 = keep all, the reference's
    # behaviour; rotation was the intent of its scratch prototype,
    # experiments/test.py:343-345).
    keep_checkpoints: int = 0
    # Save a checkpoint every N epochs (1 = every epoch, the reference's
    # cadence — new_betavaegan.py:222-228; 0 = never). Sweeps that don't
    # need resume can turn them off.
    checkpoint_every: int = 1
    # Checkpoint storage dtype for the Adam moments ('float32' = exact,
    # 'bfloat16' = smaller), in the port's checkpoints as in the JAX
    # package's: cast on save, cast back to --optimizer_dtype on load
    # (utils/checkpoint.py).
    checkpoint_save_dtype: str = "float32"
    # Write the per-epoch FID sample PNGs (sample_{i}_{epoch}.png, the
    # reference's on-disk artifact — utils.py:21-26). True = parity.
    # False drops ONLY the files (the FID score is computed in memory
    # either way).
    fid_save_samples: bool = True
    # uint8 decode cache of a folder dataset's train stream, on the run's
    # device ("auto"/"on"/"off"; "auto" = when it fits the global
    # DMT_DECODE_CACHE_BYTES budget, default 4 GiB; data/pipeline.py).
    cache_decoded: str = "auto"
    # torchvision resnet18 checkpoint for the birds encoder (the reference
    # uses resnet18(pretrained=True), models/model.py:19); birds family
    # only, loaded when the file exists (models/resnet.py).
    resnet18_ckpt: str = ""

    # NVAE (--model nvae; models/nvae.py Arch): the flags of its widths and
    # latent groups, under its names, at the defaults of its CelebA 64x64
    # command (github.com/NVlabs/NVAE README; arXiv:2007.03898); its other
    # sizes and weight decays are constants of models/ and train/nvae.py.
    # Its normalizing flows (--num_nf) are not ported: the port runs NVAE's
    # --num_nf 0. Its published lr is 1e-2 (pass --lr 0.01). For NVAE
    # n_hidden is ignored: its FID draws are every latent group's ε.
    num_channels_enc: int = 64
    num_channels_dec: int = 64
    num_latent_scales: int = 3
    num_groups_per_scale: int = 20
    ada_groups: bool = True
    num_latent_per_group: int = 20

    # --- derived output paths (filled by finalize()) ---------------------
    model_path: str = ""
    results_path_recons: str = ""
    results_path_samples: str = ""
    test_results_path_recons: str = ""
    test_results_path_originals: str = ""
    test_results_path_samples: str = ""
    fid_path_samples: str = ""
    fid_path_recons: str = ""

    def finalize(self, make_dirs: bool = True) -> "Config":
        """Apply '%' templating and derive/create the output tree.

        Mirrors envsetter.py:60-64 (templating) and :68-95 (dir tree),
        fixing the missing ``fid_results/recons`` entry.
        """
        # argparse `choices` only protects the CLI; programmatic Configs
        # (dataclasses.replace in the β search, scripts, tests) must fail
        # HERE, not hours later at the first checkpoint save / train step.
        _allowed = {"dtype": ("bfloat16", "float32"),
                    "optimizer_dtype": ("float32", "bfloat16"),
                    "checkpoint_save_dtype": ("float32", "bfloat16"),
                    "freeze_mode": ("observed", "intent")}
        for field, allowed in _allowed.items():
            if getattr(self, field) not in allowed:
                raise ValueError(
                    f"{field} must be one of {allowed}, "
                    f"got {getattr(self, field)!r}")
        if self.checkpoint_every < 0:
            # bool(-1) is truthy and negative-divisor modulo never hits 0,
            # so a negative value would silently degrade to final-epoch-only
            # saves instead of honouring the 0=never / N=every-N contract.
            raise ValueError(
                f"checkpoint_every must be >= 0 (0 = never, N = every N "
                f"epochs); got {self.checkpoint_every}")
        self.save_path = self.save_path.replace("%", self.name)
        self.log_path = self.log_path.replace("%", self.name)
        self.image_root_train = self.image_root_train.replace("%", self.dataset)
        self.image_root_val = self.image_root_val.replace("%", self.dataset)
        self.image_root_test = self.image_root_test.replace("%", self.dataset)

        sp = self.save_path
        self.model_path = sp + "/models"
        self.results_path_recons = sp + "/results/recons"
        self.results_path_samples = sp + "/results/samples"
        self.test_results_path_recons = sp + "/test_results/recons"
        self.test_results_path_originals = sp + "/test_results/originals"
        self.test_results_path_samples = sp + "/test_results/samples"
        self.fid_path_samples = sp + "/fid_results/samples"
        self.fid_path_recons = sp + "/fid_results/recons"

        if make_dirs:
            root = Path(sp)
            if root.exists():
                warnings.warn(
                    "Path exists and containing files could be overwritten",
                    UserWarning,
                )
            for p in (
                root,
                self.model_path,
                sp + "/results",
                self.results_path_recons,
                self.results_path_samples,
                self.test_results_path_recons,
                self.test_results_path_originals,
                self.test_results_path_samples,
                self.fid_path_samples,
                self.fid_path_recons,
                self.log_path,
            ):
                Path(p).mkdir(parents=True, exist_ok=True)
        return self


def build_arg_parser(description: str = "") -> argparse.ArgumentParser:
    """An argparse parser exposing every Config field under the reference's
    flag names (envsetter.py:13-55) plus the JAX package's additions."""
    p = argparse.ArgumentParser(description=description)
    d = Config()

    p.add_argument("--name", type=str, required=True)
    p.add_argument("--seed", type=int, default=d.seed,
                   help="random seed (default: 999)")
    p.add_argument("--num_workers", type=int, default=d.num_workers)
    p.add_argument("--log_interval", type=int, default=d.log_interval,
                   help="how many batches to wait before logging training status")
    p.add_argument("--use_gpus", type=str, default=d.use_gpus,
                   help="ignored; kept for CLI compatibility (see --device)")

    p.add_argument("--load_path", type=str, nargs="+", default=[])
    p.add_argument("--save_path", type=str, default=d.save_path)
    p.add_argument("--log_path", type=str, default=d.log_path)
    p.add_argument("--fid_path_pretrained", type=str, default=d.fid_path_pretrained)

    p.add_argument("--dataset", type=str, default=d.dataset)
    p.add_argument("--image_root_train", type=str, default=d.image_root_train)
    p.add_argument("--image_root_val", type=str, default=d.image_root_val)
    p.add_argument("--image_root_test", type=str, default=d.image_root_test)

    p.add_argument("--epochs", type=int, default=d.epochs, metavar="N")
    p.add_argument("--batch_size_train", type=int, default=d.batch_size_train, metavar="N")
    p.add_argument("--batch_size_val", type=int, default=d.batch_size_val, metavar="N")
    p.add_argument("--batch_size_test", type=int, default=d.batch_size_test, metavar="N")
    p.add_argument("--n_samples", type=int, default=d.n_samples)
    p.add_argument("--n_z", type=int, nargs="+", default=list(d.n_z))
    p.add_argument("--n_hidden", type=int, default=d.n_hidden)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--beta", type=float, default=d.beta)

    p.add_argument("--input_channels", type=int, default=d.input_channels)
    p.add_argument("--img_size", type=int, default=d.img_size)

    p.add_argument("--representation_size", type=int, default=d.representation_size)
    p.add_argument("--head_width", type=int, default=d.head_width)
    p.add_argument("--decoder_channels", type=int, nargs=3,
                   default=list(d.decoder_channels))
    p.add_argument("--disc_channels", type=int, nargs=4,
                   default=list(d.disc_channels))
    p.add_argument("--disc_feature_dim", type=int, default=d.disc_feature_dim)

    p.add_argument("--calc_fid", type=str2bool, default=d.calc_fid)
    p.add_argument("--fid_save_samples", type=str2bool,
                   default=d.fid_save_samples,
                   help="write the per-epoch FID sample PNGs (True = "
                        "reference parity; False skips only the files, "
                        "not the score)")
    p.add_argument("--to_train", type=str2bool, default=d.to_train)
    p.add_argument("--test_recons", type=str2bool, default=d.test_recons)
    p.add_argument("--test_samples", type=str2bool, default=d.test_samples)

    p.add_argument("--freeze_mode", type=str, default=d.freeze_mode,
                   choices=["observed", "intent"])
    p.add_argument("--bn_groups", type=int, default=d.bn_groups,
                   help="BatchNorm statistics groups: 1 = global batch "
                        "(global batch), 2 = per-GPU DataParallel emulation")
    p.add_argument("--dtype", type=str, default=d.dtype,
                   choices=["bfloat16", "float32"])
    p.add_argument("--optimizer_dtype", type=str, default=d.optimizer_dtype,
                   choices=["float32", "bfloat16"],
                   help="Adam moment storage dtype (bfloat16 = opt-in perf "
                        "mode; update math is float32 either way)")
    p.add_argument("--mesh_shape", type=int, default=d.mesh_shape)
    p.add_argument("--synthetic_data", type=str2bool, default=d.synthetic_data)
    p.add_argument("--synthetic_train_size", type=int, default=d.synthetic_train_size)
    p.add_argument("--synthetic_basis_sigma", type=float,
                   default=d.synthetic_basis_sigma,
                   help="synthetic basis blur σ; <0 = resolution-scaled "
                        "default, 0 = legacy white basis (study-only)")
    p.add_argument("--profile_dir", type=str, default=d.profile_dir)
    p.add_argument("--resnet18_ckpt", type=str, default=d.resnet18_ckpt)
    p.add_argument("--keep_checkpoints", type=int, default=d.keep_checkpoints)
    p.add_argument("--checkpoint_every", type=int, default=d.checkpoint_every,
                   help="save a checkpoint every N epochs (0 = never)")
    p.add_argument("--checkpoint_save_dtype", type=str,
                   default=d.checkpoint_save_dtype,
                   choices=["float32", "bfloat16"],
                   help="storage dtype for Adam moments in checkpoints "
                        "(bfloat16 shrinks the per-epoch device→host "
                        "fetch ~1/3; params always stay float32)")
    p.add_argument("--cache_decoded", type=str,
                   default=d.cache_decoded,
                   choices=["auto", "on", "off"])
    # here, not at the top: models/ imports torch, which this module does not
    from .models.nvae import FLAGS as NVAE_FLAGS

    for name in NVAE_FLAGS:
        v = getattr(d, name)
        p.add_argument(f"--{name}", type=str2bool if isinstance(v, bool)
                       else type(v), default=v,
                       help="NVAE (--model nvae)")
    return p


class EnvSetter:
    """Drop-in equivalent of the reference's EnvSetter (envsetter.py:6-98):
    ``EnvSetter(name).get_parser()`` parses argv into a finalized Config and
    creates the run directory tree as a side effect."""

    def __init__(self, description: str, argv: Optional[Sequence[str]] = None,
                 make_dirs: bool = True):
        ns = build_arg_parser(description).parse_args(argv)
        self._config = Config(**vars(ns)).finalize(make_dirs=make_dirs)

    def get_parser(self) -> Config:
        return self._config


def config_from_args(argv: Optional[Sequence[str]] = None,
                     description: str = "",
                     make_dirs: bool = True) -> Config:
    return EnvSetter(description, argv=argv, make_dirs=make_dirs).get_parser()
