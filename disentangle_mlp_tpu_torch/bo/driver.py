"""Automated β search of the port: GP + EI with FID in the loop
(disentangle_mlp_tpu/bo/driver.py).

The reference launched five β-VAE-GAN runs by hand, transcribed their FIDs
into final_bo.py:33-36 and picked the next β off a plot. ``BetaSearch``
owns that loop: seed observations → fit the GP → maximize EI on the β grid
→ train and score the proposed β through an objective → repeat. The
objective is any ``beta -> fid`` callable; ``make_training_objective``
builds the real one, a full :func:`~..train.loop.run_vaegan` at that β on
one torch device.

Two execution modes:

- ``run(n)``: sequential, one β at a time;
- ``run_parallel(rounds, make_group_objectives(cfg, k))``: k βs proposed
  jointly per round (constant-liar q-EI) and trained concurrently, one per
  group of devices. A group is one device here: a group of several devices
  needs data-parallel training, which the port does not have yet
  (ROADMAP item 6, DDP), and is refused.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .gp import GaussianProcess, expected_improvement

# The reference's hand-collected observations (final_bo.py:33-36), usable
# as seed data so the search continues from published history.
REFERENCE_OBSERVATIONS: Tuple[Tuple[float, float], ...] = (
    (1.0, 139.33), (50.0, 147.92), (75.0, 126.75),
    (100.0, 137.98), (150.0, 151.08),
)


class GridExhausted(RuntimeError):
    """Every grid point has been observed (or claimed by a constant-liar
    lie): there is no untried candidate left to propose. Raised instead of
    returning grid[0] k times: duplicate proposals would train into the
    same <save_path>/<name>_beta<β> tree concurrently."""


@dataclasses.dataclass
class BetaSearch:
    objective: Callable[[float], float]
    grid_lo: float = 1.0
    grid_hi: float = 150.0
    grid_step: float = 1.0
    ell: float = 30.0
    sigma_f: float = 50.0
    xi: float = 0.01
    log_path: str = ""

    betas: List[float] = dataclasses.field(default_factory=list)
    fids: List[float] = dataclasses.field(default_factory=list)

    def seed(self, observations=REFERENCE_OBSERVATIONS) -> "BetaSearch":
        for b, f in observations:
            self.betas.append(float(b))
            self.fids.append(float(f))
        return self

    @property
    def grid(self) -> np.ndarray:
        return np.arange(self.grid_lo, self.grid_hi + self.grid_step,
                         self.grid_step)

    def fit_gp(self) -> GaussianProcess:
        return GaussianProcess(ell=self.ell, sigma_f=self.sigma_f).fit(
            np.asarray(self.betas), np.asarray(self.fids))

    def propose(self) -> float:
        """Next β = argmax EI over the grid, excluding already-tried points."""
        gp = self.fit_gp()
        ei = expected_improvement(gp, self.grid, xi=self.xi)
        tried = np.isin(self.grid, np.asarray(self.betas))
        if tried.all():
            raise GridExhausted(
                f"all {self.grid.size} grid points in "
                f"[{self.grid_lo}, {self.grid_hi}] have been observed")
        ei = np.where(tried, -np.inf, ei)
        return float(self.grid[int(np.argmax(ei))])

    def observe(self, beta: float, fid: float) -> None:
        """Record one evaluation; with ``log_path`` the whole history is
        rewritten there (``bo_history.json``), so a restarted search can
        seed from it."""
        self.betas.append(float(beta))
        self.fids.append(float(fid))
        if self.log_path:
            with open(self.log_path, "w") as f:
                json.dump({"betas": self.betas, "fids": self.fids}, f,
                          indent=2)

    def run(self, n_iterations: int) -> Dict[str, float]:
        for _ in range(n_iterations):
            try:
                beta = self.propose()
            except GridExhausted as e:
                # a fully observed grid is a completed search, not a
                # failure: the observations so far stand
                print(f"[bo] stopping: {e}")
                break
            fid = float(self.objective(beta))
            self.observe(beta, fid)
            print(f"[bo] beta={beta:.1f} -> FID={fid:.2f}")
        return self.best()

    def best(self) -> Dict[str, float]:
        i = int(np.argmin(self.fids))
        return {"best_beta": self.betas[i], "best_fid": self.fids[i]}

    def propose_batch(self, k: int) -> List[float]:
        """k jointly diverse proposals by the constant-liar heuristic
        (CL-mean, Ginsbourger et al. 2010): take the EI argmax, pretend its
        outcome is the current posterior mean there, refit, repeat. The
        lies push later proposals away from the βs already claimed, one
        distinct candidate per device group."""
        betas, fids = list(self.betas), list(self.fids)
        out: List[float] = []
        for _ in range(k):
            # a tiny noise floor: the liar set gathers near-coincident grid
            # points, whose noiseless RBF Gram has no Cholesky factor
            gp = GaussianProcess(ell=self.ell, sigma_f=self.sigma_f,
                                 noise_var=1e-6).fit(
                np.asarray(betas), np.asarray(fids))
            ei = expected_improvement(gp, self.grid, xi=self.xi)
            claimed = np.isin(self.grid, np.asarray(betas))
            if claimed.all():
                # fewer untried points than groups: hand back the partial
                # batch; raise only when no proposal at all is possible
                if out:
                    print(f"[bo] grid nearly exhausted: proposing "
                          f"{len(out)} of the requested {k} βs")
                    return out
                raise GridExhausted(
                    f"grid fully observed/claimed — no untried β left of "
                    f"the requested {k}; the search is complete")
            ei = np.where(claimed, -np.inf, ei)
            beta = float(self.grid[int(np.argmax(ei))])
            lie = float(gp.predict(np.asarray([beta]))[0][0])
            out.append(beta)
            betas.append(beta)
            fids.append(lie)
        return out

    def run_parallel(self, n_rounds: int,
                     group_objectives: List[Callable[[float], float]]
                     ) -> Dict[str, float]:
        """The search with one β per device group: each round proposes
        ``len(group_objectives)`` βs jointly (:meth:`propose_batch`) and
        evaluates them concurrently on a thread pool, one per objective."""
        from concurrent.futures import ThreadPoolExecutor

        k = len(group_objectives)
        with ThreadPoolExecutor(max_workers=k) as pool:
            for _ in range(n_rounds):
                try:
                    batch = self.propose_batch(k)
                except GridExhausted as e:
                    print(f"[bo] stopping: {e}")
                    break
                futures = [pool.submit(obj, b)
                           for obj, b in zip(group_objectives, batch)]
                # gather every future before raising: a failed group must
                # not discard the finished FIDs of its round-mates, which
                # observe() persists for a restarted search
                first_error = None
                for beta, fut in zip(batch, futures):
                    try:
                        fid = float(fut.result())
                    except Exception as e:  # noqa: BLE001 — re-raised below
                        if first_error is None:
                            first_error = e
                        print(f"[bo] beta={beta:.1f} FAILED: {e}")
                        continue
                    self.observe(beta, fid)
                    print(f"[bo] beta={beta:.1f} -> FID={fid:.2f}")
                if first_error is not None:
                    raise first_error
        return self.best()


def beta_run_config(base_cfg, beta: float, epochs: Optional[int] = None):
    """A finalized per-β run config with its own run-directory tree.

    When ``base_cfg`` still carries '%' templates, the per-β ``name``
    templates a fresh tree as usual; when it is already finalized (the CLI
    finalizes before building objectives), each β's run is nested under
    ``<save_path>/<name>_beta<β>`` instead, so no two βs of a search write
    the same checkpoint, log or FID paths."""
    name = f"{base_cfg.name}_beta{beta:g}"
    cfg = dataclasses.replace(base_cfg, beta=float(beta), name=name)
    if epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=epochs)
    if "%" not in cfg.save_path:
        run_root = f"{base_cfg.save_path}/{name}"
        cfg = dataclasses.replace(cfg, save_path=run_root,
                                  log_path=f"{run_root}/log")
    return cfg.finalize()


def make_training_objective(base_cfg, epochs: Optional[int] = None,
                            device="cuda") -> Callable[[float], float]:
    """beta → final-epoch FID of a full β-VAE-GAN training run on
    ``device`` (the automated form of the reference's manual procedure)."""
    from ..train.loop import resolve_device, run_vaegan

    device = resolve_device(device)

    def objective(beta: float) -> float:
        cfg = beta_run_config(base_cfg, beta, epochs)
        result = run_vaegan(cfg, device=device)
        fid = result.get("FID", "N/A")
        if fid == "N/A":
            raise RuntimeError(
                "objective requires calc_fid with usable reference stats")
        return float(fid)

    objective.devices = [device]
    return objective


def make_group_objectives(base_cfg, n_groups: int,
                          epochs: Optional[int] = None,
                          devices=None) -> List[Callable[[float], float]]:
    """Split ``devices`` (default every visible CUDA device, ``cuda:0`` …
    ``cuda:{n-1}``) into ``n_groups`` contiguous groups and build one
    training objective per group. A group must be one device: the port has
    no data-parallel training yet."""
    import torch

    devs = (list(devices) if devices is not None else
            [torch.device(f"cuda:{i}")
             for i in range(torch.cuda.device_count())])
    if n_groups < 1 or n_groups > len(devs):
        raise ValueError(
            f"n_groups={n_groups} must be in [1, {len(devs)}] "
            f"(visible devices)")
    per = len(devs) // n_groups
    if per > 1:
        raise NotImplementedError(
            f"{len(devs)} devices in {n_groups} groups puts {per} devices "
            f"in a group; a group of more than one device needs "
            f"data-parallel training, not yet ported (ROADMAP item 6, DDP)."
            f" Pass --bo_parallel {len(devs)} for one device a group")
    idle = devs[per * n_groups:]
    if idle:  # no silent capacity drops
        print(f"[bo] WARNING: {len(devs)} devices don't split into "
              f"{n_groups} groups — {len(idle)} will idle: {idle}")
    return [make_training_objective(base_cfg, epochs, device=d)
            for d in devs[:n_groups]]
