"""FID reference-statistics builder of the port
(disentangle_mlp_tpu/cli/stats.py): streams the training set through the
port's InceptionV3 and writes the ``.npz`` {mu, sigma} that
``--fid_path_pretrained`` reads:

    python -m disentangle_mlp_tpu_torch.cli.stats --name stats \
        --image_root_train <tree> --stats_out fid_stats.npz \
        --max_images 50000 [--device cuda|cpu]

The training set is the trainer's: an image folder (``--image_root_train
<tree>``, decoded and resized on ``--device``; ``--dataset`` picks the
normalization) or, with ``--synthetic_data True``, the synthetic stream.
Statistics of a plain directory of images need no file:
``--fid_path_pretrained <dir>`` computes them (eval/fid.py
``statistics_from_dir``).
"""

from __future__ import annotations

from ..config import Config, build_arg_parser
from ..data.pipeline import get_data_loader
from ..eval.fid import compute_dataset_statistics, inception_is_pretrained
from ..train.loop import resolve_device


def main(argv=None) -> None:
    parser = build_arg_parser("FID reference statistics builder")
    parser.add_argument("--stats_out", type=str, default="fid_stats.npz")
    parser.add_argument("--max_images", type=int, default=50000)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu must be "
                             "asked for)")
    ns = parser.parse_args(argv)
    extra = {k: vars(ns).pop(k) for k in ["stats_out", "max_images",
                                          "device"]}
    device = resolve_device(extra["device"])
    cfg = Config(**vars(ns)).finalize()
    train, _, _ = get_data_loader(cfg, device)
    if not inception_is_pretrained():
        print("WARNING: no pretrained FID Inception weights found "
              "(see eval/inception.py WEIGHT_SEARCH_PATHS); statistics will "
              "be self-consistent but not comparable to published FIDs.")
    mu, sigma = compute_dataset_statistics(
        train, path_out=extra["stats_out"], max_images=extra["max_images"])
    print(f"wrote {extra['stats_out']}: mu{mu.shape} sigma{sigma.shape}")


if __name__ == "__main__":
    main()
