"""Training CLI of the PyTorch port — the JAX package's ``dmt-train`` flag
surface plus ``--device``:

    python -m disentangle_mlp_tpu_torch.cli.train --model betavaegan \
        --name beta25 --beta 25 --calc_fid False --synthetic_data True \
        [--device cuda|cpu] [flags of disentangle_mlp_tpu.cli.train ...]

``--model`` is ``vae``, ``gan`` or ``betavaegan`` (``vaegan`` is the same
experiment). ``--dataset birds|mnist`` trains that dataset's model family
whatever ``--model`` says (train/families.py; birds needs ``--img_size
128``, MNIST's idx files ``--input_channels 1``). One ``--load_path``
resumes training from a checkpoint of either package; for the CelebA
experiments more than one, or ``--to_train False``, evaluates them
(cli/evaluate.py). ``--profile_dir DIR`` writes a ``torch.profiler`` trace
of the run there (utils/runtime.py), also when the run raises, with the
port's ``dmt.*`` spans and device marks on.

``--mesh_shape N`` trains data-parallel on N devices, one process a rank:
this command spawns the ranks (N CPU ranks with ``--device cpu``), or, run
under ``torchrun --nproc_per_node N``, each process is the rank that
torchrun's environment names (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``; the JAX package reads
``JAX_COORDINATOR_ADDRESS``). 0 (the default) takes every visible device:
on one card the single-device path. Asking for more CUDA devices than are
visible raises, naming how many are. ``--device cuda:N`` pins the run to
that one card (``--mesh_shape`` above 1 with it raises).
"""

from __future__ import annotations

from typing import Dict

from ..config import Config, build_arg_parser
from ..train.families import FAMILY_DATASETS
from ..train.loop import RUNNERS, resolve_device, run_family
from ..utils.runtime import setup, teardown


def parse(description: str, argv=None):
    """The trainer's flags plus ``--model`` and ``--device``; returns
    (model, device, Config kwargs)."""
    parser = build_arg_parser(description)
    parser.add_argument("--model", type=str, default="betavaegan",
                        choices=sorted(RUNNERS))
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda; cpu "
                             "must be asked for)")
    ns = parser.parse_args(argv)
    kwargs = {k: v for k, v in vars(ns).items()
              if k not in ("model", "device")}
    return ns.model, resolve_device(ns.device), kwargs


def main(argv=None) -> Dict:
    model, device, kwargs = parse("disentangle_mlp_tpu_torch trainer", argv)
    cfg = Config(**kwargs).finalize()
    # a family dataset trains its family whatever --model says
    run = run_family if cfg.dataset in FAMILY_DATASETS else RUNNERS[model]
    setup(cfg.profile_dir, device)
    try:
        return run(cfg, device=device)
    finally:
        teardown(cfg.profile_dir)


if __name__ == "__main__":
    main()
