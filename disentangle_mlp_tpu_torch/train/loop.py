"""Epoch loop of the port's experiments (disentangle_mlp_tpu/train/loop.py;
reference experiments/new_vae.py, new_gan.py, new_betavaegan.py): config →
logger → data → models → per epoch: train over batches → checkpoint → FID
over ``n_samples`` samples → console line + JSON record; afterwards the
``--load_path`` evaluation sweep (FID, reconstructions, samples of each
listed checkpoint). ``--dataset birds|mnist`` trains that dataset's model
family instead, whatever ``--model`` says (:func:`run_family`: train loader
only, exactly one ``--load_path`` resumes, FID for birds only, no sweep).
Logged keys per experiment, as the JAX package logs them:

  vae:        {Epoch, Avg Loss, FID}
  gan:        {Epoch, Avg Loss G, Avg Loss E, FID}   ("Avg Loss E" holds
              the true average D loss, the JAX package's documented
              deviation from the reference's logging bug)
  betavaegan: {Epoch, Avg Eec Loss, Avg Dnc Loss, Avg Dis Loss, FID}
  families:   {Epoch, Avg Loss, Avg Recon Loss, FID}   (FID 'N/A' for
              mnist: its samples are not 3-channel n_hidden decodes)

Per-epoch FID is scored asynchronously, as in the JAX package: the device
work (decode, per-image normalize, pool3, uint8 quantize) runs at epoch end
in the loop's thread, the host work (sample PNG encodes, the float64
Fréchet math) on one background worker, and the epoch's console line and
record are emitted when the next epoch ends (the last at loop exit).
Values and record order are those of inline scoring; DMT_ASYNC_FID=0
scores inline.

The data are an image folder (``--image_root_train``: JPEGs decoded and
resized on the run's device, the uint8 cache on that device, filled ahead
by the decode warm-up), MNIST's idx files or the synthetic stream; the
reference statistics a ``.npz`` file or a directory of images. Not ported
yet, and refused rather than skipped: multi-device meshes.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import torch

from ..config import Config
from ..data.pipeline import get_data_loader
from ..eval import fid as fid_mod
from ..eval.samples import (_sample_latents, gen_reconstructions,
                            generate_fid_samples, generate_samples,
                            write_sample_files)
from ..utils.checkpoint import (load_checkpoint, rotate_checkpoints,
                                save_checkpoint)
from ..utils.logger import Logger
from .families import FamilyExperiment
from .gan import GANExperiment
from .vae import VAEExperiment
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


def _restore(exp, path: str) -> int:
    """Load the checkpoint at ``path`` into ``exp``; returns its epoch."""
    epoch, states = load_checkpoint(path, exp.states())
    exp.load_states(states)
    return epoch


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
# runs on several threads (the β search's groups) share the one worker
_FID_POOL_LOCK = threading.Lock()


def _instant_na():
    """A resolve() that is already 'N/A' (FID off, or the stats asset
    absent), tagged so _EpochEmitter needn't defer its epoch record."""
    fn = lambda: "N/A"  # noqa: E731
    fn.instant = True
    return fn


def _fid_pool() -> ThreadPoolExecutor:
    global _FID_POOL
    with _FID_POOL_LOCK:
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
        m2, s2 = fid_mod._handle_path(cfg.fid_path_pretrained, device)
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
    if cfg.mesh_shape > 1:
        raise NotImplementedError("the port trains on one device; "
                                  "--mesh_shape above 1 is not yet ported")


class _Run:
    """What every experiment's run shares: the experiment on its device,
    the loaders, the start epoch (one ``--load_path`` resumes; more than
    one only evaluates), the img/s meter and the epoch emitter."""

    def __init__(self, cfg: Config, make: Callable, logger, device):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_loader, _, self.test_loader = get_data_loader(
            cfg, self.device)
        if cfg.to_train:
            # decode epoch 1 into the cache ahead of the steps, as the JAX
            # loops do (a no-op without a cache)
            self.train_loader.start_cache_warmup()
        self.logger = logger or Logger(cfg.log_path, cfg)
        self.exp = make(cfg, self.device)
        self.start_epoch = 0
        if len(cfg.load_path) > 1 and cfg.to_train:
            # the reference silently trains from scratch here; the JAX
            # package raises
            raise ValueError("Cannot load more than one model for training")
        if len(cfg.load_path) == 1 and cfg.to_train:
            self.start_epoch = _restore(self.exp, cfg.load_path[0])
        self.meter = Throughput(sync=torch.cuda.synchronize
                                if self.device.type == "cuda" else None)
        self.emitter = _EpochEmitter(self.logger)
        self.m: Dict = {}

    def epochs(self):
        return range(self.start_epoch, self.cfg.epochs) if self.cfg.to_train \
            else range(0)

    def train_epoch(self, keys, progress: Optional[Callable] = None
                    ) -> Dict[str, float]:
        """One epoch of steps; returns each metric of ``keys`` summed over
        the batches and divided by the dataset size. ``progress(epoch-local
        batch index, metrics, batch)`` prints every ``log_interval``
        batches."""
        self.meter.resume()
        sums = None
        for i, (x, _) in enumerate(self.train_loader):
            self.m = self.exp.train_step(x)
            keep = {k: self.m[k] for k in keys}
            sums = keep if sums is None else \
                {k: sums[k] + keep[k] for k in sums}
            self.meter.add(x.shape[0])
            if progress is not None and i % self.cfg.log_interval == 0:
                progress(i, self.m, x)
        n = self.train_loader.dataset_size
        self.meter.pause()
        return {k: float(v) / n for k, v in sums.items()}

    def checkpoint(self, epoch: int) -> None:
        cfg = self.cfg
        if _ckpt_due(cfg, epoch):
            save_checkpoint(f"{cfg.model_path}/model_{epoch + 1}", epoch + 1,
                            self.exp.states(), cfg.checkpoint_save_dtype)
            rotate_checkpoints(cfg.model_path, cfg.keep_checkpoints)

    def finish(self, sample_fn: Callable, recon_fn: Optional[Callable]
               ) -> Dict:
        last = self.emitter.finish()
        last["sweep"] = _eval_sweep(self.cfg, self.exp, sample_fn, recon_fn,
                                    self.test_loader, self.device)
        last["images_per_sec"] = self.meter.rate()
        last["step_metrics"] = {k: float(v) for k, v in self.m.items()}
        return last


def run_vae(cfg: Config, logger: Optional[Logger] = None,
            device="cuda") -> Dict:
    """Train the plain VAE for ``cfg.epochs``, then sweep ``--load_path``;
    returns the last epoch's {Avg Loss, FID}, ``images_per_sec``, the last
    step's metrics (``step_metrics``) and the sweep's records."""
    run = _Run(cfg, VAEExperiment, logger, device)
    exp = run.exp

    def progress(i, m, x):
        print(f"Train Epoch: {epoch} [{i}/{len(run.train_loader)}] "
              f"Loss: {float(m['loss']) / x.shape[0]:.6f}", flush=True)

    for epoch in run.epochs():
        avg = run.train_epoch(("loss",), progress)["loss"]
        run.checkpoint(epoch)
        run.emitter.emit(
            _maybe_fid_async(cfg, exp.decode, epoch, cfg.fid_path_samples,
                             device=run.device),
            lambda fid, e=epoch, a=avg: {"Epoch": e, "Avg Loss": a,
                                         "FID": fid},
            f"====> Epoch: {epoch} Average loss: {avg:.4f} FID: {{fid}} "
            f"({run.meter.rate():.1f} img/s)")
    return run.finish(exp.decode, exp.reconstruct)


def run_gan(cfg: Config, logger: Optional[Logger] = None,
            device="cuda") -> Dict:
    """Train the DCGAN for ``cfg.epochs``, then sweep ``--load_path``;
    returns the last epoch's {Avg Loss G, Avg Loss E, FID} ("Avg Loss E"
    holding the average D loss), ``images_per_sec``, ``step_metrics`` and
    the sweep's records."""
    run = _Run(cfg, GANExperiment, logger, device)
    exp = run.exp

    def progress(i, m, x):
        print(f"[{epoch}/{cfg.epochs}][{i}/{len(run.train_loader)}] "
              f"Loss_D: {float(m['errD']):.4f} "
              f"Loss_G: {float(m['errG']):.4f} D(x): {float(m['D_x']):.4f} "
              f"D(G(z)): {float(m['D_G_z1']):.4f}/{float(m['D_G_z2']):.4f}",
              flush=True)

    for epoch in run.epochs():
        avg = run.train_epoch(("errG", "errD"), progress)
        run.checkpoint(epoch)
        g, d = avg["errG"], avg["errD"]
        run.emitter.emit(
            _maybe_fid_async(cfg, exp.generate, epoch, cfg.fid_path_samples,
                             device=run.device),
            lambda fid, e=epoch, a=g, b=d: {"Epoch": e, "Avg Loss G": a,
                                            "Avg Loss E": b, "FID": fid},
            f"====> Epoch: {epoch} Average loss G: {g:.4f} "
            f"Average loss D: {d:.4f} FID: {{fid}} "
            f"({run.meter.rate():.1f} img/s)")
    return run.finish(exp.generate, None)


def run_vaegan(cfg: Config, logger: Optional[Logger] = None,
               device="cuda") -> Dict:
    """Train the β-VAE-GAN for ``cfg.epochs``, then sweep ``--load_path``;
    returns the last epoch's {Avg Eec Loss, Avg Dis Loss, FID},
    ``images_per_sec``, ``step_metrics`` and the sweep's records."""
    run = _Run(cfg, VAEGANExperiment, logger, device)
    exp = run.exp
    for epoch in run.epochs():
        avg = run.train_epoch(("recon_enc", "recon_dec", "dis", "D_x"))
        run.checkpoint(epoch)
        enc_l, dec_l, dis_l = avg["recon_enc"], avg["recon_dec"], avg["dis"]
        # the reference scores per-epoch FID into fid_path_recons
        # (new_betavaegan.py:234)
        run.emitter.emit(
            _maybe_fid_async(cfg, exp.decode, epoch, cfg.fid_path_recons,
                             device=run.device),
            lambda fid, e=epoch, a=enc_l, b=dec_l, c=dis_l: {
                "Epoch": e, "Avg Eec Loss": a, "Avg Dnc Loss": b,
                "Avg Dis Loss": c, "FID": fid},
            f"====> Epoch: {epoch} Avg Encoder Loss: {enc_l:.4f} "
            f"Avg Decoder Loss: {dec_l:.4f} "
            f"Avg Discriminator Loss: {dis_l:.4f} FID: {{fid}} "
            f"Dx: {avg['D_x']:.4f} ({run.meter.rate():.1f} img/s)",
            last_fn=lambda rec: {k: rec[k] for k in
                                 ("Avg Eec Loss", "Avg Dis Loss", "FID")})
    return run.finish(exp.decode, exp.reconstruct)


def sweep_epoch(epoch: int, previous: int) -> int:
    """The epoch a sweep files a checkpoint under: its own, unless that is
    not above the previous checkpoint's, then the previous one plus 1 (the
    reference's de-collision, new_betavaegan.py:253-254)."""
    return epoch if (epoch != previous and previous < epoch) \
        else previous + 1


def _eval_sweep(cfg: Config, exp, sample_fn: Callable,
                recon_fn: Optional[Callable], test_loader, device) -> list:
    """For each ``--load_path`` checkpoint, as the flags ask: FID over
    ``n_samples`` samples into ``fid_path_samples``, a reconstruction grid
    of the first test batch (and its originals), a grid of 5 samples.
    Returns one {path, Epoch, FID} record a checkpoint."""
    records, previous = [], 0
    for path in cfg.load_path:
        epoch = previous = sweep_epoch(_restore(exp, path), previous)
        fid = "N/A"
        if cfg.calc_fid:
            fid = _maybe_fid(cfg, sample_fn, epoch, cfg.fid_path_samples,
                             device=device)
            print(f"Calculated FID: {fid}", flush=True)
        if cfg.test_recons and recon_fn is not None:
            gen_reconstructions(
                recon_fn, test_loader, epoch, cfg.test_results_path_recons,
                nrow=1, path_for_originals=cfg.test_results_path_originals)
            print("Generated reconstructions", flush=True)
        if cfg.test_samples:
            generate_samples(sample_fn, epoch, 5, cfg.n_hidden,
                             cfg.test_results_path_samples, nrow=1,
                             rng_seed=cfg.seed, device=device)
            print("Generated samples", flush=True)
        records.append({"path": path, "Epoch": epoch, "FID": fid})
    return records


def run_family(cfg: Config, logger: Optional[Logger] = None,
               device="cuda") -> Dict:
    """Train ``cfg.dataset``'s model family (birds or mnist) for
    ``cfg.epochs`` on the train loader; returns the last epoch's {Avg Loss,
    Avg Recon Loss, FID}, ``images_per_sec`` and the last step's metrics
    (``step_metrics``). One ``--load_path`` resumes; more than one raises,
    as the families have no evaluation sweep."""
    if len(cfg.load_path) > 1:
        # the celebA runners sweep several checkpoints; training a family
        # from scratch over the listed ones would be the worst outcome
        raise ValueError(
            "birds/mnist take exactly one --load_path (resume); "
            "multi-checkpoint eval sweeps are celebA-only")
    run = _Run(cfg, FamilyExperiment, logger, device)
    exp = run.exp
    for epoch in run.epochs():
        avg = run.train_epoch(("loss", "recon"))
        run.checkpoint(epoch)
        loss, recon = avg["loss"], avg["recon"]
        # FID needs 3-channel n_hidden decodes: only birds gives them
        run.emitter.emit(
            _maybe_fid_async(cfg, exp.decode, epoch, cfg.fid_path_samples,
                             device=run.device)
            if cfg.dataset == "birds" else _instant_na(),
            lambda fid, e=epoch, a=loss, r=recon: {
                "Epoch": e, "Avg Loss": a, "Avg Recon Loss": r, "FID": fid},
            f"====> Epoch: {epoch} Average loss: {loss:.4f} "
            f"(recon {recon:.4f}) FID: {{fid}} "
            f"({run.meter.rate():.1f} img/s)")
    last = run.emitter.finish()
    last["images_per_sec"] = run.meter.rate()
    last["step_metrics"] = {k: float(v) for k, v in run.m.items()}
    return last


RUNNERS = {"vae": run_vae, "gan": run_gan,
           "betavaegan": run_vaegan, "vaegan": run_vaegan}
