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

On a CUDA device each training step is one replay of a CUDA graph of the
experiment's step (train/scan.py), captured after the run's first step,
which runs eagerly on the capture stream; the step's random draws are made
from the experiment's generators as an eager step makes them, and copied
into the graph. On the CPU the steps run eagerly. Checkpoints are written
by an :class:`AsyncCheckpointer`: ``save`` snapshots the state on the
device and returns, a worker thread writes the file and then rotates; the
run waits for it before the evaluation sweep and before it returns.

The data are an image folder (``--image_root_train``: JPEGs decoded and
resized on the run's device, the uint8 cache on that device, filled ahead
by the decode warm-up), MNIST's idx files or the synthetic stream; the
reference statistics a ``.npz`` file or a directory of images.

Data parallelism (``--mesh_shape N``, a torchrun launch, or an explicit
``devices`` group; :func:`_setup_parallel` decides as the JAX package's
does) runs one rank a device (parallel/mesh.py): ranks that this process
does not hold yet are spawned, one process each. Every rank builds the
experiment on its device with the state of rank 0 (a ``--load_path`` is
read there and broadcast), reads its slice of each global batch and steps
on it; the metrics are the global batch's. Rank 0 alone prints (its first
line names the ranks and the backend), logs, writes checkpoints, sample
files and grids, and scores FID; every rank decodes the FID samples and
extracts pool3 from its slice of them. Under NCCL the steps are CUDA graph
replays as above, their collectives captured; under gloo every step is
eager.
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
from ..models.layers import local_groups
from ..parallel.mesh import (Mesh, broadcast_, make_mesh,
                             maybe_initialize_distributed, replicate, spawn)
from ..utils import runtime
from ..utils.checkpoint import AsyncCheckpointer, load_checkpoint
from ..utils.logger import Logger
from ..utils.runtime import float32_policy
from .families import FamilyExperiment
from .gan import GANExperiment
from .scan import MultiStep, make_multi_step, state_tensors
from .vae import VAEExperiment
from .vaegan import VAEGANExperiment


def resolve_device(name) -> torch.device:
    """The torch device for ``name``; a CUDA device that is not there is an
    error, never a quiet move to the CPU. Every entry point resolves its
    device here, so here the port's float32 policy is set (TF32 off,
    utils/runtime.py)."""
    float32_policy()
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} asked for but torch.cuda.is_available() is "
            f"False; pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def _setup_parallel(cfg: Config, device="cuda", devices=None
                    ) -> Optional[Mesh]:
    """The run's data-parallel mesh over ``cfg.mesh_shape`` devices (0 =
    all visible), or None for one device (the JAX package's loop.py
    ``_setup_parallel``).

    ``devices`` is an explicit group (the β search runs one run per group):
    an explicit group always gets a mesh, even a one-device one. A batch
    that the devices do not divide raises for an explicit group and for a
    torchrun launch of several processes; in the implicit single-host case
    the run falls back to one device. ``--bn_groups`` must split into whole
    groups on each rank."""
    maybe_initialize_distributed(device)
    mesh = make_mesh(cfg.mesh_shape, devices=devices, device=device)
    n = mesh.size
    if cfg.batch_size_train % n != 0:
        if devices is not None:
            raise ValueError(
                f"batch_size_train={cfg.batch_size_train} must divide the "
                f"explicit {n}-device group")
        if mesh.joined:
            raise ValueError(
                f"multi-process run: batch_size_train={cfg.batch_size_train}"
                f" must divide the {n} global devices")
        return None
    if n <= 1 and devices is None:
        return None
    if cfg.bn_groups > 1:
        local_groups(cfg.bn_groups, mesh)
    return mesh


def _parallel(impl: Callable, cfg: Config, logger, device, devices) -> Dict:
    """``impl(cfg, logger, device, mesh)`` on one device, on each rank of a
    torchrun launch, or on ranks spawned here (rank 0's result returned)."""
    device = resolve_device(device)
    mesh = _setup_parallel(cfg, device, devices)
    if mesh is None:
        return impl(cfg, logger, device)
    if mesh.joined:
        return impl(cfg, logger, mesh.device, mesh)
    return spawn(_rank_run, mesh, impl, cfg, logger)[0]


def _rank_run(mesh: Mesh, impl: Callable, cfg: Config, logger) -> Dict:
    return impl(cfg, logger if mesh.is_main else None, mesh.device, mesh)


def _ckpt_due(cfg: Config, epoch: int) -> bool:
    """Every ``checkpoint_every`` epochs and at the final epoch (0 = never)."""
    every = cfg.checkpoint_every
    return bool(every) and ((epoch + 1) % every == 0
                            or epoch + 1 == cfg.epochs)


class Throughput:
    """images/sec meter. The first ``warmup`` batches are excluded (the
    clock starts once they have finished on the device, via ``sync``), and
    the loop pauses it around non-train work such as checkpoint writes. A
    pause waits for the device too: graph replays return long before the
    steps they queue have run."""

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
            if self.sync is not None:
                self.sync()
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


def _restore(exp, path: str, mesh: Optional[Mesh] = None) -> int:
    """Load the checkpoint at ``path`` into ``exp``; returns its epoch.
    Under a mesh rank 0 reads it and every rank takes rank 0's state."""
    epoch = 0
    if mesh is None or mesh.is_main:
        epoch, states = load_checkpoint(path, exp.states())
        exp.load_states(states)
    if mesh is not None:
        t = torch.tensor([epoch], device=mesh.device)
        broadcast_([t], mesh)
        replicate(state_tensors(exp), mesh)
        epoch = int(t)
    return epoch


def _maybe_fid(cfg: Config, decode_fn: Callable, epoch: int, path: str,
               device="cuda", z: Optional[torch.Tensor] = None,
               mesh: Optional[Mesh] = None):
    """FID over cfg.n_samples decoded samples against the reference stats
    (reference new_betavaegan.py:230-235), the samples written to ``path``
    when ``cfg.fid_save_samples``. 'N/A' when FID is off or the stats asset
    is missing or unreadable (ASSET_ERRORS); any other error re-raises.
    ``z`` replaces the seeded latents. Under a mesh every rank decodes all
    samples and extracts its slice; rank 0 writes the files."""
    if not cfg.calc_fid:
        return "N/A"
    main = mesh is None or mesh.is_main
    try:
        samples = generate_fid_samples(
            decode_fn, epoch, cfg.n_samples, cfg.n_hidden, path,
            rng_seed=cfg.seed + epoch, save=cfg.fid_save_samples and main,
            device=device, z=z)
        return fid_mod.get_fid_from_samples(samples, cfg.fid_path_pretrained,
                                            mesh=mesh)
    except fid_mod.ASSET_ERRORS as e:
        if main:
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
                     z: Optional[torch.Tensor] = None,
                     mesh: Optional[Mesh] = None) -> Callable[[], object]:
    """Async twin of :func:`_maybe_fid`: returns a zero-argument
    ``resolve()`` → float | 'N/A'. Decode, per-image normalize, pool3 and
    the uint8 quantize (and its pull to the host) run now, in the caller's
    thread; only the PNG encodes and the Fréchet math go to the worker.
    Same error contract: ASSET_ERRORS → 'N/A' (printed), anything else
    re-raises, from resolve() when it arises in the worker. Under a mesh
    every rank decodes all samples and normalizes and extracts its slice
    (fid.get_activations); rank 0 alone quantizes, writes the files and
    scores, and the other ranks resolve to 'N/A'."""
    if not cfg.calc_fid:
        return _instant_na()
    main = mesh is None or mesh.is_main
    try:
        m2, s2 = fid_mod._handle_path(cfg.fid_path_pretrained, device)
        if z is None:
            z = _sample_latents(cfg.seed + epoch, cfg.n_samples,
                                cfg.n_hidden, device)
        with runtime.span("dmt.fid.decode"):
            out = decode_fn(z)
        acts = fid_mod.get_activations(out, mesh=mesh, normalize=True)
        if not main:
            return _instant_na()
        u8 = (fid_mod.normalized_u8(out).cpu().numpy()
              if cfg.fid_save_samples else None)
    except fid_mod.ASSET_ERRORS as e:
        if main:
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
    losses are those of the epoch's end. Without a logger (a mesh's ranks
    but rank 0) nothing is printed or logged."""

    def __init__(self, logger: Optional[Logger],
                 deferred: Optional[bool] = None):
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
        if self.logger is not None:
            print(line.format(fid=fid), flush=True)
            self.logger.log(rec)
        self.last = last_fn(rec) if last_fn else \
            {k: v for k, v in rec.items() if k != "Epoch"}

    def finish(self) -> Dict:
        if self._pending is not None:
            prev, self._pending = self._pending, None
            self._flush(prev)
        return dict(self.last)


class _Run:
    """What every experiment's run shares: the experiment on its device,
    the loaders, the start epoch (one ``--load_path`` resumes; more than
    one only evaluates), the img/s meter and the epoch emitter; under a
    joined ``mesh``, this rank's part of the run."""

    def __init__(self, cfg: Config, make: Callable, logger, device,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.main = mesh is None or mesh.is_main
        self.world = 1 if mesh is None else mesh.size
        self.device = resolve_device(device if mesh is None
                                     else mesh.device)
        # every step a CUDA graph replay after the first, unless a gloo
        # mesh's collectives go through the host
        self.graphed = self.device.type == "cuda" and (
            mesh is None or mesh.backend == "nccl")
        if mesh is not None and self.main:
            print(f"[mesh] data parallel over {mesh.describe()}; "
                  + ("the steps after the first replay one CUDA graph with "
                     "their collectives" if self.graphed else
                     "every step eager" + (": a CUDA graph cannot hold "
                                           "gloo's host-staged collectives"
                                           if self.device.type == "cuda"
                                           else "")), flush=True)
        ranks = (0, 1) if mesh is None else (mesh.rank, mesh.size)
        self.train_loader, _, self.test_loader = get_data_loader(
            cfg, self.device, *ranks)
        if cfg.to_train:
            # decode epoch 1 into the cache ahead of the steps, as the JAX
            # loops do (a no-op without a cache)
            self.train_loader.start_cache_warmup()
        self.logger = (logger or Logger(cfg.log_path, cfg)) if self.main \
            else None
        self.exp = make(cfg, self.device, mesh=mesh)
        self.start_epoch = 0
        if len(cfg.load_path) > 1 and cfg.to_train:
            # the reference silently trains from scratch here; the JAX
            # package raises
            raise ValueError("Cannot load more than one model for training")
        if len(cfg.load_path) == 1 and cfg.to_train:
            self.start_epoch = _restore(self.exp, cfg.load_path[0], mesh)
        elif mesh is not None:
            replicate(state_tensors(self.exp), mesh)
        self.meter = Throughput(sync=torch.cuda.synchronize
                                if self.device.type == "cuda" else None)
        self.emitter = _EpochEmitter(self.logger)
        self.checkpointer = AsyncCheckpointer(cfg.checkpoint_save_dtype)
        self.graph: Optional[MultiStep] = None
        self.m: Dict = {}

    def epochs(self):
        return range(self.start_epoch, self.cfg.epochs) if self.cfg.to_train \
            else range(0)

    def step(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One training step on ``x``: eager on the CPU and on a gloo mesh;
        on CUDA otherwise the run's first step eagerly on the capture
        stream, then the one-step graph captured after it, replayed for
        every later step."""
        if not self.graphed:
            return self.exp.train_step(x)
        with runtime.span("dmt.step.draw"):
            draws = [self.exp.draw(x.shape[0])]
        if self.graph is None:
            self.graph = make_multi_step(self.exp, 1)
            m = self.graph.step_and_capture(x[None], draws)
        else:
            m = self.graph(x[None], draws)
        return {k: v[0] for k, v in m.items()}

    def train_epoch(self, keys, progress: Optional[Callable] = None
                    ) -> Dict[str, float]:
        """One epoch of steps; returns each metric of ``keys`` summed over
        the batches and divided by the dataset size (the metrics are the
        global batch's under a mesh). ``progress(epoch-local batch index,
        metrics, global batch size)`` prints every ``log_interval`` batches
        on rank 0."""
        self.meter.resume()
        sums = None
        for i, (x, _) in enumerate(self.train_loader):
            self.m = self.step(x)
            keep = {k: self.m[k] for k in keys}
            sums = keep if sums is None else \
                {k: sums[k] + keep[k] for k in sums}
            self.meter.add(x.shape[0] * self.world)
            if (progress is not None and self.main
                    and i % self.cfg.log_interval == 0):
                progress(i, self.m, x.shape[0] * self.world)
        n = self.train_loader.dataset_size
        self.meter.pause()
        return {k: float(v) / n for k, v in sums.items()}

    def checkpoint(self, epoch: int) -> None:
        """Snapshot the state and return; the worker writes the file, then
        keeps the newest ``keep_checkpoints``. Under a mesh rank 0 alone
        writes: its state is every rank's."""
        cfg = self.cfg
        if self.main and _ckpt_due(cfg, epoch):
            self.checkpointer.save(f"{cfg.model_path}/model_{epoch + 1}",
                                   epoch + 1, self.exp.states(),
                                   rotate_keep=cfg.keep_checkpoints)

    def finish(self, sample_fn: Callable, recon_fn: Optional[Callable]
               ) -> Dict:
        self.checkpointer.wait()
        last = self.emitter.finish()
        last["sweep"] = _eval_sweep(self.cfg, self.exp, sample_fn, recon_fn,
                                    self.test_loader, self.device, self.mesh)
        last["images_per_sec"] = self.meter.rate()
        last["step_metrics"] = {k: float(v) for k, v in self.m.items()}
        return last


def run_vae(cfg: Config, logger: Optional[Logger] = None,
            device="cuda", devices=None) -> Dict:
    """Train the plain VAE for ``cfg.epochs``, then sweep ``--load_path``;
    returns the last epoch's {Avg Loss, FID}, ``images_per_sec``, the last
    step's metrics (``step_metrics``) and the sweep's records.
    ``devices``: an explicit device group to run on, one rank each."""
    return _parallel(_run_vae, cfg, logger, device, devices)


def _run_vae(cfg: Config, logger, device, mesh=None) -> Dict:
    run = _Run(cfg, VAEExperiment, logger, device, mesh)
    exp = run.exp

    def progress(i, m, b):
        print(f"Train Epoch: {epoch} [{i}/{len(run.train_loader)}] "
              f"Loss: {float(m['loss']) / b:.6f}", flush=True)

    for epoch in run.epochs():
        avg = run.train_epoch(("loss",), progress)["loss"]
        run.checkpoint(epoch)
        run.emitter.emit(
            _maybe_fid_async(cfg, exp.decode, epoch, cfg.fid_path_samples,
                             device=run.device, mesh=mesh),
            lambda fid, e=epoch, a=avg: {"Epoch": e, "Avg Loss": a,
                                         "FID": fid},
            f"====> Epoch: {epoch} Average loss: {avg:.4f} FID: {{fid}} "
            f"({run.meter.rate():.1f} img/s)")
    return run.finish(exp.decode, exp.reconstruct)


def run_gan(cfg: Config, logger: Optional[Logger] = None,
            device="cuda", devices=None) -> Dict:
    """Train the DCGAN for ``cfg.epochs``, then sweep ``--load_path``;
    returns the last epoch's {Avg Loss G, Avg Loss E, FID} ("Avg Loss E"
    holding the average D loss), ``images_per_sec``, ``step_metrics`` and
    the sweep's records. ``devices`` as for :func:`run_vae`."""
    return _parallel(_run_gan, cfg, logger, device, devices)


def _run_gan(cfg: Config, logger, device, mesh=None) -> Dict:
    run = _Run(cfg, GANExperiment, logger, device, mesh)
    exp = run.exp

    def progress(i, m, b):
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
                             device=run.device, mesh=mesh),
            lambda fid, e=epoch, a=g, b=d: {"Epoch": e, "Avg Loss G": a,
                                            "Avg Loss E": b, "FID": fid},
            f"====> Epoch: {epoch} Average loss G: {g:.4f} "
            f"Average loss D: {d:.4f} FID: {{fid}} "
            f"({run.meter.rate():.1f} img/s)")
    return run.finish(exp.generate, None)


def run_vaegan(cfg: Config, logger: Optional[Logger] = None,
               device="cuda", devices=None) -> Dict:
    """Train the β-VAE-GAN for ``cfg.epochs``, then sweep ``--load_path``;
    returns the last epoch's {Avg Eec Loss, Avg Dis Loss, FID},
    ``images_per_sec``, ``step_metrics`` and the sweep's records.
    ``devices`` as for :func:`run_vae` (the β search's groups)."""
    return _parallel(_run_vaegan, cfg, logger, device, devices)


def _run_vaegan(cfg: Config, logger, device, mesh=None) -> Dict:
    run = _Run(cfg, VAEGANExperiment, logger, device, mesh)
    exp = run.exp
    for epoch in run.epochs():
        avg = run.train_epoch(("recon_enc", "recon_dec", "dis", "D_x"))
        run.checkpoint(epoch)
        enc_l, dec_l, dis_l = avg["recon_enc"], avg["recon_dec"], avg["dis"]
        # the reference scores per-epoch FID into fid_path_recons
        # (new_betavaegan.py:234)
        run.emitter.emit(
            _maybe_fid_async(cfg, exp.decode, epoch, cfg.fid_path_recons,
                             device=run.device, mesh=mesh),
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
                recon_fn: Optional[Callable], test_loader, device,
                mesh: Optional[Mesh] = None) -> list:
    """For each ``--load_path`` checkpoint, as the flags ask: FID over
    ``n_samples`` samples into ``fid_path_samples``, a reconstruction grid
    of the first test batch (and its originals), a grid of 5 samples.
    Returns one {path, Epoch, FID} record a checkpoint. Under a mesh the
    ranks share the FID's pool3, and rank 0 alone prints and writes."""
    main = mesh is None or mesh.is_main
    records, previous = [], 0
    for path in cfg.load_path:
        epoch = previous = sweep_epoch(_restore(exp, path, mesh), previous)
        fid = "N/A"
        if cfg.calc_fid:
            fid = _maybe_fid(cfg, sample_fn, epoch, cfg.fid_path_samples,
                             device=device, mesh=mesh)
            if main:
                print(f"Calculated FID: {fid}", flush=True)
        if not main:
            records.append({"path": path, "Epoch": epoch, "FID": fid})
            continue
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
               device="cuda", devices=None) -> Dict:
    """Train ``cfg.dataset``'s model family (birds or mnist) for
    ``cfg.epochs`` on the train loader; returns the last epoch's {Avg Loss,
    Avg Recon Loss, FID}, ``images_per_sec`` and the last step's metrics
    (``step_metrics``). One ``--load_path`` resumes; more than one raises,
    as the families have no evaluation sweep. ``devices`` as for
    :func:`run_vae`."""
    if len(cfg.load_path) > 1:
        # the celebA runners sweep several checkpoints; training a family
        # from scratch over the listed ones would be the worst outcome
        raise ValueError(
            "birds/mnist take exactly one --load_path (resume); "
            "multi-checkpoint eval sweeps are celebA-only")
    return _parallel(_run_family, cfg, logger, device, devices)


def _run_family(cfg: Config, logger, device, mesh=None) -> Dict:
    run = _Run(cfg, FamilyExperiment, logger, device, mesh)
    exp = run.exp
    for epoch in run.epochs():
        avg = run.train_epoch(("loss", "recon"))
        run.checkpoint(epoch)
        loss, recon = avg["loss"], avg["recon"]
        # FID needs 3-channel n_hidden decodes: only birds gives them
        run.emitter.emit(
            _maybe_fid_async(cfg, exp.decode, epoch, cfg.fid_path_samples,
                             device=run.device, mesh=mesh)
            if cfg.dataset == "birds" else _instant_na(),
            lambda fid, e=epoch, a=loss, r=recon: {
                "Epoch": e, "Avg Loss": a, "Avg Recon Loss": r, "FID": fid},
            f"====> Epoch: {epoch} Average loss: {loss:.4f} "
            f"(recon {recon:.4f}) FID: {{fid}} "
            f"({run.meter.rate():.1f} img/s)")
    run.checkpointer.wait()
    last = run.emitter.finish()
    last["images_per_sec"] = run.meter.rate()
    last["step_metrics"] = {k: float(v) for k, v in run.m.items()}
    return last


RUNNERS = {"vae": run_vae, "gan": run_gan,
           "betavaegan": run_vaegan, "vaegan": run_vaegan}
