"""CLI of the port's β=25 FID reproduction harness (eval/reproduce.py;
disentangle_mlp_tpu/cli/reproduce.py):

    python -m disentangle_mlp_tpu_torch.cli.reproduce --name repro \
        --image_root_train ... --image_root_val ... [--device cuda|cpu]

Defaults pin the reference's published configuration: β=25, 10 epochs,
batch 256, lr 3e-4, 1000 FID samples (results/logs/log_beta_vaegan_25.json
``args``). ``--synthetic_data True`` runs the same plumbing on the
synthetic dataset with self-built statistics (no assets needed).
``--assets_check`` prints the ready/missing report of the two assets and
``--rescore_log DIR`` re-gates a finished run's log; neither uses a
device. The run itself is on ``--device`` (default cuda), traced into
``--profile_dir`` when one is given."""

from __future__ import annotations

import json
import os

from ..config import Config, build_arg_parser
from ..train.loop import resolve_device
from ..utils.runtime import setup, teardown

_FLAGS = ("stats_out", "stats_images", "calib_images", "skip_train",
          "report_out", "assets_check", "rescore_log", "device")


def assets_report(cfg) -> dict:
    """Ready/missing report for the two assets the real reproduction needs:
    the pt_inception FID weights (searched where eval/inception.py
    ``find_fid_weights`` looks) and the CelebA image tree."""
    from ..eval.inception import WEIGHT_SEARCH_PATHS, find_fid_weights

    weights = find_fid_weights()
    report = {
        "inception_weights": {
            "ready": weights is not None,
            "found_at": weights,
            "expected_file": "pt_inception-2015-12-05-6726825d.pth",
            "sha256_prefix": "6726825d",
            "search_paths": [p for p in WEIGHT_SEARCH_PATHS if p],
            "hint": "set FID_INCEPTION_WEIGHTS=/path/to/file to override",
        },
        "celeba_images": {},
    }
    if weights is not None:
        import hashlib

        with open(weights, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        report["inception_weights"]["sha256"] = digest
        report["inception_weights"]["sha256_ok"] = digest.startswith(
            "6726825d")
    for split, root in (("train", cfg.image_root_train),
                        ("val", cfg.image_root_val),
                        ("test", cfg.image_root_test)):
        n = 0
        if os.path.isdir(root):
            for _, _, files in os.walk(root):
                n += sum(f.lower().endswith((".jpg", ".jpeg", ".png"))
                         for f in files)
        report["celeba_images"][split] = {
            "root": root, "ready": n > 0, "n_images": n}
    report["ready"] = (report["inception_weights"]["ready"]
                       and all(v["ready"]
                               for v in report["celeba_images"].values()))
    return report


def main(argv=None) -> None:
    parser = build_arg_parser("beta=25 FID reproduction harness")
    parser.add_argument("--stats_out", type=str, default="fid_stats_repro.npz")
    parser.add_argument("--stats_images", type=int, default=50000)
    parser.add_argument("--calib_images", type=int, default=50000)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--report_out", type=str, default="REPRODUCTION.json")
    parser.add_argument("--assets_check", action="store_true",
                        help="print the asset ready/missing report and exit")
    parser.add_argument("--rescore_log", type=str, default="",
                        help="re-gate an existing run: recompute the FID/Eec"
                             " curve gates from this log dir, merge them into"
                             " --report_out (created if missing), and exit")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the run (default cuda; cpu "
                             "must be asked for)")
    parser.set_defaults(beta=25.0, epochs=10)
    ns = parser.parse_args(argv)
    extra = {k: vars(ns).pop(k) for k in _FLAGS}
    if extra["assets_check"]:
        cfg = Config(**vars(ns)).finalize(make_dirs=False)
        print(json.dumps(assets_report(cfg), indent=2))
        return
    if extra["rescore_log"]:
        from ..eval.reproduce import rescore
        print(json.dumps(
            rescore(extra["rescore_log"], extra["report_out"]),
            indent=2, default=float))
        return
    device = resolve_device(extra["device"])
    cfg = Config(**vars(ns)).finalize()

    from ..eval.reproduce import run_reproduction
    setup(cfg.profile_dir, device)
    try:
        return run_reproduction(cfg, extra["stats_out"],
                                stats_images=extra["stats_images"],
                                calib_images=extra["calib_images"],
                                skip_train=extra["skip_train"],
                                report_out=extra["report_out"],
                                device=device)
    finally:
        teardown(cfg.profile_dir)


if __name__ == "__main__":
    main()
