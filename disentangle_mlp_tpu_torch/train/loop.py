"""Epoch loop of the port's β-VAE-GAN experiment
(disentangle_mlp_tpu/train/loop.py ``run_vaegan``; reference
experiments/new_betavaegan.py:211-267): config → logger → data → models →
per epoch: train over batches → checkpoint → FID over ``n_samples``
decoded samples → console line + JSON record
{Epoch, Avg Eec Loss, Avg Dnc Loss, Avg Dis Loss, FID}.

Per-epoch FID is scored asynchronously, as in the JAX package: the device
work (decode, per-image normalize, pool3, uint8 quantize) runs at epoch end
in the loop's thread, the host work (sample PNG encodes, the float64
Fréchet math) on one background worker, and the epoch's console line and
record are emitted when the next epoch ends (the last at loop exit).
Values and record order are those of inline scoring; DMT_ASYNC_FID=0
scores inline.

Not ported yet, and refused rather than skipped: FID statistics of an image
directory, the ``--load_path`` eval sweep, profiling and multi-device
meshes.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import torch

from ..config import Config
from ..data.pipeline import get_data_loader
from ..eval import fid as fid_mod
from ..eval.samples import (_sample_latents, generate_fid_samples,
                            write_sample_files)
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


def _maybe_fid(cfg: Config, decode_fn: Callable, epoch: int, path: str,
               device="cuda", z: Optional[torch.Tensor] = None):
    """FID over cfg.n_samples decoded samples against the reference stats
    (reference new_betavaegan.py:230-235), the samples written to ``path``
    when ``cfg.fid_save_samples``. 'N/A' when FID is off or the stats asset
    is missing or unreadable (ASSET_ERRORS); any other error re-raises.
    ``z`` replaces the seeded latents."""
    if not cfg.calc_fid:
        return "N/A"
    try:
        samples = generate_fid_samples(
            decode_fn, epoch, cfg.n_samples, cfg.n_hidden, path,
            rng_seed=cfg.seed + epoch, save=cfg.fid_save_samples,
            device=device, z=z)
        return fid_mod.get_fid_from_samples(samples, cfg.fid_path_pretrained)
    except fid_mod.ASSET_ERRORS as e:
        print(f"[fid] skipped: {e}", flush=True)
        return "N/A"


# The host half of per-epoch FID (PNG encodes, float64 eigen math) runs on
# this one background worker, overlapped with the next epoch's steps; FIFO
# order resolves the epochs' scores in order. DMT_ASYNC_FID=0 scores inline.
_FID_ASYNC = os.environ.get("DMT_ASYNC_FID", "1") != "0"
_FID_POOL: Optional[ThreadPoolExecutor] = None


def _instant_na():
    """A resolve() that is already 'N/A' (FID off, or the stats asset
    absent), tagged so _EpochEmitter needn't defer its epoch record."""
    fn = lambda: "N/A"  # noqa: E731
    fn.instant = True
    return fn


def _fid_pool() -> ThreadPoolExecutor:
    global _FID_POOL
    if _FID_POOL is None:
        _FID_POOL = ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix="dmt-fid")
    return _FID_POOL


def _maybe_fid_async(cfg: Config, decode_fn: Callable, epoch: int,
                     path: str, device="cuda",
                     z: Optional[torch.Tensor] = None
                     ) -> Callable[[], object]:
    """Async twin of :func:`_maybe_fid`: returns a zero-argument
    ``resolve()`` → float | 'N/A'. Decode, per-image normalize, pool3 and
    the uint8 quantize (and its pull to the host) run now, in the caller's
    thread; only the PNG encodes and the Fréchet math go to the worker.
    Same error contract: ASSET_ERRORS → 'N/A' (printed), anything else
    re-raises, from resolve() when it arises in the worker."""
    if not cfg.calc_fid:
        return _instant_na()
    try:
        m2, s2 = fid_mod._handle_path(cfg.fid_path_pretrained)
        if z is None:
            z = _sample_latents(cfg.seed + epoch, cfg.n_samples,
                                cfg.n_hidden, device)
        out = decode_fn(z)
        acts = fid_mod.get_activations(fid_mod.per_image_normalize(out))
        u8 = (fid_mod.normalized_u8(out).cpu().numpy()
              if cfg.fid_save_samples else None)
    except fid_mod.ASSET_ERRORS as e:
        print(f"[fid] skipped: {e}", flush=True)
        return _instant_na()

    def job():
        # the PNG files first: an unwritable samples directory degrades to
        # 'N/A' before any score exists, as in the inline path
        if u8 is not None:
            write_sample_files(u8, epoch, path)
        sqrt2 = (fid_mod.cached_sqrt_sigma2(cfg.fid_path_pretrained, s2)
                 if acts.shape[0] >= fid_mod.FEATURE_DIM else None)
        return fid_mod.frechet_from_acts(acts, m2, s2, sqrt_sigma2=sqrt2)

    future = _fid_pool().submit(job)

    def resolve():
        try:
            return future.result()
        except fid_mod.ASSET_ERRORS as e:
            print(f"[fid] skipped: {e}", flush=True)
            return "N/A"

    return resolve


class _EpochEmitter:
    """Defers each epoch's console line and JSON record until its FID
    resolves: one epoch later in async mode (finish() flushes the last).
    ``line`` is pre-formatted except for its ``{fid}`` slot, so rates and
    losses are those of the epoch's end."""

    def __init__(self, logger: Logger, deferred: Optional[bool] = None):
        self.logger = logger
        self.deferred = _FID_ASYNC if deferred is None else deferred
        self._pending = None
        self.last: Dict = {}

    def emit(self, resolve: Callable[[], object],
             record_fn: Callable[[object], Dict], line: str,
             last_fn: Optional[Callable[[Dict], Dict]] = None):
        item = (resolve, record_fn, line, last_fn)
        # an instant resolve emits inline, unless an earlier epoch is still
        # pending: that one flushes first, keeping records in epoch order
        if not self.deferred or (getattr(resolve, "instant", False)
                                 and self._pending is None):
            self._flush(item)
            return
        prev, self._pending = self._pending, item
        if prev is not None:
            self._flush(prev)

    def _flush(self, item):
        resolve, record_fn, line, last_fn = item
        fid = resolve()
        rec = record_fn(fid)
        print(line.format(fid=fid), flush=True)
        self.logger.log(rec)
        self.last = last_fn(rec) if last_fn else \
            {k: v for k, v in rec.items() if k != "Epoch"}

    def finish(self) -> Dict:
        if self._pending is not None:
            prev, self._pending = self._pending, None
            self._flush(prev)
        return dict(self.last)


def _refuse_unported(cfg: Config) -> None:
    if cfg.calc_fid and not cfg.fid_path_pretrained.endswith(".npz"):
        raise NotImplementedError(
            f"FID statistics of an image directory "
            f"(--fid_path_pretrained {cfg.fid_path_pretrained!r}) are not "
            f"yet ported; pass a .npz stats file")
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
    emitter = _EpochEmitter(logger)
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
            # the reference scores per-epoch FID into fid_path_recons
            # (new_betavaegan.py:234)
            emitter.emit(
                _maybe_fid_async(cfg, exp.decode, epoch, cfg.fid_path_recons,
                                 device=device),
                lambda fid, e=epoch, a=enc_l, b=dec_l, c=dis_l: {
                    "Epoch": e, "Avg Eec Loss": a, "Avg Dnc Loss": b,
                    "Avg Dis Loss": c, "FID": fid},
                f"====> Epoch: {epoch} Avg Encoder Loss: {enc_l:.4f} "
                f"Avg Decoder Loss: {dec_l:.4f} "
                f"Avg Discriminator Loss: {dis_l:.4f} FID: {{fid}} "
                f"Dx: {d_x:.4f} ({meter.rate():.1f} img/s)",
                last_fn=lambda rec: {k: rec[k] for k in
                                     ("Avg Eec Loss", "Avg Dis Loss", "FID")})
    last = emitter.finish()
    last["images_per_sec"] = meter.rate()
    last["step_metrics"] = {k: float(v) for k, v in m.items()}
    return last


RUNNERS = {"betavaegan": run_vaegan, "vaegan": run_vaegan}
