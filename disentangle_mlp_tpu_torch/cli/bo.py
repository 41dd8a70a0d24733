"""β Bayesian-optimization CLI of the port (disentangle_mlp_tpu/cli/bo.py;
the automated successor of the reference's bayesian_optimization/
final_bo.py):

    python -m disentangle_mlp_tpu_torch.cli.bo --name bo \
        [--posterior_only False --bo_iterations 3 --bo_epochs 10
         --bo_parallel 1 --bo_report report.json] [--device cuda|cpu]
        [flags of disentangle_mlp_tpu_torch.cli.train ...]

Two modes:

- ``--posterior_only True`` (default): fit the GP on the seed observations
  (the reference's five (β, FID) points, final_bo.py:33-36) and write the
  posterior mean, its ±2σ band and EI over the β grid to ``--bo_output``
  as JSON. Nothing is trained and no device is used.
- ``--posterior_only False``: the FID-in-the-loop search, a full-width
  β-VAE-GAN run of ``--bo_epochs`` epochs per proposed β on ``--device``
  (default cuda), each in its own tree under ``<save_path>/<name>_beta<β>``,
  the history in ``<save_path>/bo_history.json``. ``--bo_parallel k``
  splits the visible CUDA devices into k contiguous groups and trains k
  jointly proposed βs concurrently per round, one a group (a group of
  several devices trains data-parallel). ``--bo_report``
  writes every train→FID cycle with its wall time, also when the search
  dies midway (then marked partial, with the error).
"""

from __future__ import annotations

import json
import time

from ..bo.driver import (REFERENCE_OBSERVATIONS, BetaSearch,
                         make_group_objectives, make_training_objective)
from ..bo.gp import expected_improvement
from ..config import Config, build_arg_parser, str2bool
from ..train.loop import resolve_device

_FLAGS = ("posterior_only", "bo_iterations", "bo_output", "bo_epochs",
          "bo_parallel", "bo_report", "device")


def main(argv=None) -> None:
    parser = build_arg_parser("beta Bayesian optimization")
    parser.add_argument("--posterior_only", type=str2bool, default=True)
    parser.add_argument("--bo_iterations", type=int, default=3)
    parser.add_argument("--bo_output", type=str, default="bo_posterior.json")
    parser.add_argument("--bo_epochs", type=int, default=10,
                        help="epochs per objective evaluation")
    parser.add_argument("--bo_parallel", type=int, default=1,
                        help="device groups training concurrently, one beta "
                             "each (the visible devices split evenly; 1 = "
                             "sequential search)")
    parser.add_argument("--bo_report", type=str, default="",
                        help="write a full search artifact here: every "
                             "train→FID→propose cycle with per-evaluation "
                             "wall time, the final best β, and total wall "
                             "time")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the search's training runs "
                             "(default cuda; cpu must be asked for)")
    ns = parser.parse_args(argv)
    extra = {k: vars(ns).pop(k) for k in _FLAGS}
    cfg = Config(**vars(ns)).finalize()

    if extra["posterior_only"]:
        search = BetaSearch(objective=lambda b: 0.0).seed()
        gp = search.fit_gp()
        grid = search.grid
        mean, std = gp.predict(grid)
        ei = expected_improvement(gp, grid)
        out = {
            "beta": grid.tolist(),
            "posterior_mean": mean.tolist(),
            "band_low": (mean - 2 * std).tolist(),
            "band_high": (mean + 2 * std).tolist(),
            "expected_improvement": ei.tolist(),
            "proposed_beta": search.propose(),
            "observations": [list(o) for o in REFERENCE_OBSERVATIONS],
        }
        with open(extra["bo_output"], "w") as f:
            json.dump(out, f)
        print(f"posterior written to {extra['bo_output']}; "
              f"EI proposes beta={out['proposed_beta']:.0f}")
        _maybe_plot(grid, mean, std, extra["bo_output"])
        return

    cycles = []

    def _instrument(obj):
        """Record every train→FID evaluation (β, FID, wall seconds) for
        the --bo_report artifact; exceptions pass through untouched."""
        def timed(beta: float) -> float:
            t0 = time.time()
            fid = obj(beta)
            cycles.append({"beta": float(beta), "fid": float(fid),
                           "train_fid_wall_s": round(time.time() - t0, 2)})
            return fid
        return timed

    device = resolve_device(extra["device"])
    t_start = time.time()
    search = BetaSearch(objective=None,
                        log_path=f"{cfg.save_path}/bo_history.json").seed()
    result, search_error = None, None
    try:
        if extra["bo_parallel"] > 1:
            # every visible CUDA device, or the one CPU
            groups = [_instrument(g) for g in make_group_objectives(
                cfg, extra["bo_parallel"], epochs=extra["bo_epochs"],
                devices=None if device.type == "cuda" else [device])]
            result = search.run_parallel(extra["bo_iterations"], groups)
        else:
            search.objective = _instrument(make_training_objective(
                cfg, epochs=extra["bo_epochs"], device=device))
            result = search.run(extra["bo_iterations"])
        print(f"best: beta={result['best_beta']:.1f} "
              f"FID={result['best_fid']:.2f}")
    except (Exception, KeyboardInterrupt) as e:
        # the report below still records every completed train→FID cycle:
        # hours of evaluations must not be lost because one died
        search_error = e
    if extra["bo_report"]:
        report = {
            "mode": ("parallel" if extra["bo_parallel"] > 1 else
                     "sequential"),
            "groups": extra["bo_parallel"],
            "epochs_per_eval": extra["bo_epochs"],
            "rounds": extra["bo_iterations"],
            "seed_observations": [list(o) for o in REFERENCE_OBSERVATIONS],
            "cycles": cycles,
            "total_wall_s": round(time.time() - t_start, 2),
            "devices": _device_names(device),
            "synthetic_data": bool(cfg.synthetic_data),
        }
        if result is not None:
            report["best_beta"] = result["best_beta"]
            report["best_fid"] = result["best_fid"]
        else:
            report["partial"] = True
            report["error"] = repr(search_error)
            if cycles:  # best over the cycles that did complete
                best = min(cycles, key=lambda c: c["fid"])
                report["best_beta"] = best["beta"]
                report["best_fid"] = best["fid"]
        with open(extra["bo_report"], "w") as f:
            json.dump(report, f, indent=2)
        print(f"report → {extra['bo_report']}")
    if search_error is not None:
        raise search_error


def _device_names(device) -> list:
    """The search's devices: every visible CUDA device as ``cuda:<i>
    <name>`` for a run on the card, else ``device`` itself."""
    import torch

    if device.type != "cuda":
        return [str(device)]
    return [f"cuda:{i} {torch.cuda.get_device_name(i)}"
            for i in range(torch.cuda.device_count())]


def _maybe_plot(grid, mean, std, json_path: str) -> None:
    """Optional mean ± 2σ plot like the reference's (final_bo.py:64-73)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    fig, ax = plt.subplots(figsize=(13, 8))
    ax.plot(grid, mean, "-k", linewidth=2, label="mean completion")
    ax.fill_between(grid, mean - 2 * std, mean + 2 * std, alpha=0.4,
                    label="credible band")
    ax.set_xlabel("Beta")
    ax.set_ylabel("FID")
    ax.legend()
    fig.savefig(json_path.replace(".json", ".png"), bbox_inches="tight")
    plt.close(fig)


if __name__ == "__main__":
    main()
