"""Offline evaluation CLI of the port — the checkpoint sweep of the JAX
package's ``cli/evaluate.py`` (FID, reconstructions, samples of each
checkpoint), plus ``--device``:

    python -m disentangle_mlp_tpu_torch.cli.evaluate --model betavaegan \
        --name eval --load_path m1 m2 --test_recons True --test_samples True \
        [--device cuda|cpu]

The checkpoints may come from either package (utils/checkpoint.py).
``--mesh_shape N`` shares the sweep's FID extraction over N ranks, as in
the trainer (rank 0 writes the files).
"""

from __future__ import annotations

from typing import Dict

from ..config import Config
from ..train.families import FAMILY_DATASETS
from ..train.loop import RUNNERS
from .train import parse


def main(argv=None) -> Dict:
    model, device, kwargs = parse("disentangle_mlp_tpu_torch offline eval",
                                  argv)
    kwargs["to_train"] = False  # sweep only
    cfg = Config(**kwargs).finalize()
    if cfg.dataset in FAMILY_DATASETS:
        raise SystemExit(
            f"offline eval sweeps are celebA-only (the reference's "
            f"generate_samples_recons.py instantiates the celebA models); "
            f"--dataset {cfg.dataset} checkpoints resume via the trainer's "
            f"--load_path instead")
    return RUNNERS[model](cfg, device=device)


if __name__ == "__main__":
    main()
