"""Training CLI of the PyTorch port — the JAX package's ``dmt-train`` flag
surface plus ``--device``:

    python -m disentangle_mlp_tpu_torch.cli.train --model betavaegan \
        --name beta25 --beta 25 --calc_fid False --synthetic_data True \
        [--device cuda|cpu] [flags of disentangle_mlp_tpu.cli.train ...]

``--model`` is ``vae``, ``gan`` or ``betavaegan`` (``vaegan`` is the same
experiment). One ``--load_path`` resumes training from a checkpoint of
either package; more than one, or ``--to_train False``, evaluates them
(cli/evaluate.py).
"""

from __future__ import annotations

from typing import Dict

from ..config import Config, build_arg_parser
from ..train.loop import RUNNERS, resolve_device


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
    return RUNNERS[model](cfg, device=device)


if __name__ == "__main__":
    main()
