"""Epoch loop of the port's β-VAE-GAN experiment
(disentangle_mlp_tpu/train/loop.py ``run_vaegan``; reference
experiments/new_betavaegan.py:211-267): config → logger → data → models →
per epoch: train over batches → checkpoint → console line + JSON record
{Epoch, Avg Eec Loss, Avg Dnc Loss, Avg Dis Loss, FID}.

Not ported yet, and refused rather than skipped: FID in the loop
(``calc_fid``), the ``--load_path`` eval sweep, profiling and multi-device
meshes.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ..config import Config
from ..data.pipeline import get_data_loader
from ..utils.checkpoint import (load_checkpoint, rotate_checkpoints,
                                save_checkpoint)
from ..utils.logger import Logger
from .vaegan import VAEGANExperiment


def resolve_device(name) -> torch.device:
    """The torch device for ``name``; a CUDA device that is not there is an
    error, never a quiet move to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} asked for but torch.cuda.is_available() is "
            f"False; pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def _ckpt_due(cfg: Config, epoch: int) -> bool:
    """Every ``checkpoint_every`` epochs and at the final epoch (0 = never)."""
    every = cfg.checkpoint_every
    return bool(every) and ((epoch + 1) % every == 0
                            or epoch + 1 == cfg.epochs)


class Throughput:
    """images/sec meter. The first ``warmup`` batches are excluded (the
    clock starts once they have finished on the device, via ``sync``), and
    the loop pauses it around non-train work such as checkpoint writes."""

    def __init__(self, warmup: int = 1,
                 sync: Optional[Callable[[], None]] = None):
        self.images = 0
        self.batches = 0
        self.warmup = warmup
        self.sync = sync
        self.start = None
        self._excluded = 0.0
        self._paused_at = None

    def add(self, n: int):
        self.batches += 1
        if self.batches <= self.warmup:
            if self.sync is not None:
                self.sync()
            self.start = time.perf_counter()
            return
        self.images += n

    def pause(self):
        if self.start is not None and self._paused_at is None:
            self._paused_at = time.perf_counter()

    def resume(self):
        if self._paused_at is not None:
            self._excluded += time.perf_counter() - self._paused_at
            self._paused_at = None

    def rate(self) -> float:
        if self.start is None:
            return 0.0
        end = (time.perf_counter() if self._paused_at is None
               else self._paused_at)
        dt = end - self.start - self._excluded
        return self.images / dt if dt > 0 else 0.0


def _states(exp: VAEGANExperiment) -> Dict:
    opt = exp.optimizer_state()
    return {"eg": {"model": exp.vae.state_dict(), "opt": opt["eg"]},
            "d": {"model": exp.discriminator.state_dict(), "opt": opt["d"]}}


def _restore(exp: VAEGANExperiment, path: str) -> int:
    ckpt = load_checkpoint(path, exp.device)
    exp.vae.load_state_dict(ckpt["eg"]["model"])
    exp.discriminator.load_state_dict(ckpt["d"]["model"])
    exp.load_optimizer_state({"eg": ckpt["eg"]["opt"],
                              "d": ckpt["d"]["opt"]})
    return int(ckpt["epoch"])


def _refuse_unported(cfg: Config) -> None:
    if cfg.calc_fid:
        raise NotImplementedError(
            "FID in the training loop is not yet ported to the PyTorch "
            "package; pass --calc_fid False")
    if cfg.load_path and (len(cfg.load_path) > 1 or not cfg.to_train
                          or cfg.test_recons or cfg.test_samples):
        raise NotImplementedError(
            "the --load_path evaluation sweep is not yet ported; one "
            "--load_path resumes training")
    if cfg.profile_dir:
        raise NotImplementedError("--profile_dir is not yet ported")
    if cfg.mesh_shape > 1:
        raise NotImplementedError("the port trains on one device; "
                                  "--mesh_shape above 1 is not yet ported")


def run_vaegan(cfg: Config, logger: Optional[Logger] = None,
               device="cuda") -> Dict:
    """Train the β-VAE-GAN for ``cfg.epochs``; returns the last epoch's
    {Avg Eec Loss, Avg Dis Loss, FID}, ``images_per_sec`` and the last
    step's metrics as floats (``step_metrics``)."""
    _refuse_unported(cfg)
    device = resolve_device(device)
    logger = logger or Logger(cfg.log_path, cfg)
    exp = VAEGANExperiment(cfg, device)
    train_loader, _, _ = get_data_loader(cfg, device)
    start_epoch = _restore(exp, cfg.load_path[0]) if cfg.load_path else 0

    meter = Throughput(sync=torch.cuda.synchronize
                       if device.type == "cuda" else None)
    last: Dict = {}
    m: Dict = {}
    if cfg.to_train:
        for epoch in range(start_epoch, cfg.epochs):
            meter.resume()
            sums = None
            for x, _ in train_loader:
                m = exp.train_step(x)
                keep = {k: m[k] for k in
                        ("recon_enc", "recon_dec", "dis", "D_x")}
                sums = keep if sums is None else \
                    {k: sums[k] + keep[k] for k in sums}
                meter.add(x.shape[0])
            n = train_loader.dataset_size
            enc_l, dec_l = float(sums["recon_enc"]) / n, \
                float(sums["recon_dec"]) / n
            dis_l, d_x = float(sums["dis"]) / n, float(sums["D_x"]) / n
            meter.pause()
            if _ckpt_due(cfg, epoch):
                save_checkpoint(f"{cfg.model_path}/model_{epoch + 1}",
                                epoch + 1, _states(exp))
                rotate_checkpoints(cfg.model_path, cfg.keep_checkpoints)
            fid = "N/A"  # calc_fid is False here (_refuse_unported)
            rec = {"Epoch": epoch, "Avg Eec Loss": enc_l,
                   "Avg Dnc Loss": dec_l, "Avg Dis Loss": dis_l, "FID": fid}
            print(f"====> Epoch: {epoch} Avg Encoder Loss: {enc_l:.4f} "
                  f"Avg Decoder Loss: {dec_l:.4f} "
                  f"Avg Discriminator Loss: {dis_l:.4f} FID: {fid} "
                  f"Dx: {d_x:.4f} ({meter.rate():.1f} img/s)", flush=True)
            logger.log(rec)
            last = {k: rec[k] for k in ("Avg Eec Loss", "Avg Dis Loss",
                                        "FID")}
    last["images_per_sec"] = meter.rate()
    last["step_metrics"] = {k: float(v) for k, v in m.items()}
    return last


RUNNERS = {"betavaegan": run_vaegan, "vaegan": run_vaegan}
