"""Training CLI of the PyTorch port — the JAX package's ``dmt-train`` flag
surface plus ``--device``:

    python -m disentangle_mlp_tpu_torch.cli.train --model betavaegan \
        --name beta25 --beta 25 --calc_fid False --synthetic_data True \
        [--device cuda|cpu] [flags of disentangle_mlp_tpu.cli.train ...]

The β-VAE-GAN (``betavaegan``/``vaegan``) is ported; the other experiments
raise until they are.
"""

from __future__ import annotations

from typing import Dict

from ..config import Config, build_arg_parser
from ..train.loop import RUNNERS, resolve_device

MODELS = ("betavaegan", "gan", "vae", "vaegan")


def main(argv=None) -> Dict:
    parser = build_arg_parser("disentangle_mlp_tpu_torch trainer")
    parser.add_argument("--model", type=str, default="betavaegan",
                        choices=MODELS)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda; "
                             "cpu must be asked for)")
    ns = parser.parse_args(argv)
    kwargs = {k: v for k, v in vars(ns).items()
              if k not in ("model", "device")}
    if ns.model not in RUNNERS:
        raise NotImplementedError(
            f"--model {ns.model} is not yet ported to the PyTorch package "
            f"(ported: {', '.join(sorted(RUNNERS))})")
    device = resolve_device(ns.device)
    cfg = Config(**kwargs).finalize()
    return RUNNERS[ns.model](cfg, device=device)


if __name__ == "__main__":
    main()
