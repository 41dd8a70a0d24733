"""Convert a reference PyTorch ``.tar`` checkpoint into the port's
checkpoint format, which is the JAX package's (disentangle_mlp_tpu/cli/
convert.py; the two write the same bytes for the same file and flags):

    python -m disentangle_mlp_tpu_torch.cli.convert --model betavaegan \\
        --name mig --torch_checkpoint model_7.tar \\
        --output /runs/mig/models/model_7 [--device cuda|cpu]
    python -m disentangle_mlp_tpu_torch.cli.train --model betavaegan \\
        --name mig --load_path /runs/mig/models/model_7 ...

The reference saves {epoch, <model state dicts>, <optimizer state dicts>}
per epoch (reference: new_betavaegan.py:221-228, new_vae.py:88-91,
new_gan.py:169-174). The model weights are mapped into the flax layout
(utils/torch_compat.py) and dropped into the states of a fresh experiment
built on ``--device`` (default cuda) from the same flags, whose Adam state
is fresh (count 0, zero moments in ``--optimizer_dtype``; split into
``{dec, enc}`` under ``--freeze_mode intent``); the file keeps the
original epoch. Optimizer moments are not migrated (utils/torch_compat.py
says why).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config, build_arg_parser
from ..train.gan import GANExperiment
from ..train.loop import resolve_device
from ..train.vae import VAEExperiment
from ..train.vaegan import VAEGANExperiment
from ..utils.checkpoint import _check_structure, save_checkpoint
from ..utils.torch_compat import convert_reference_checkpoint

EXPERIMENTS = {"vae": VAEExperiment, "gan": GANExperiment,
               "betavaegan": VAEGANExperiment, "vaegan": VAEGANExperiment}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def main(argv=None) -> str:
    parser = build_arg_parser("convert a reference torch checkpoint")
    parser.add_argument("--model", type=str, default="betavaegan",
                        choices=sorted(EXPERIMENTS))
    parser.add_argument("--torch_checkpoint", type=str, required=True)
    parser.add_argument("--output", type=str, default="",
                        help="output checkpoint path (default: the input "
                             "path with .tar replaced by .converted)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the template experiment is built "
                             "on (default cuda; cpu must be asked for)")
    ns = parser.parse_args(argv)
    model = vars(ns).pop("model")
    src = vars(ns).pop("torch_checkpoint")
    dst = vars(ns).pop("output") or (
        src[:-4] if src.endswith(".tar") else src) + ".converted"
    device = resolve_device(vars(ns).pop("device"))
    cfg = Config(**vars(ns)).finalize(make_dirs=False)

    converted = convert_reference_checkpoint(src, model, cfg)
    epoch = converted.pop("epoch")

    # the experiment's states are the templates (fresh optimizer state);
    # the converted weights replace their params and batch_stats
    states = EXPERIMENTS[model](cfg, device).states()
    for name, tree in converted.items():
        for part in ("params", "batch_stats"):
            _check_structure(states[name][part], tree[part],
                             f"/{name}/{part}")
            states[name][part] = _to_torch(tree[part])

    out = save_checkpoint(dst, epoch, states)
    print(f"converted epoch-{epoch} checkpoint written to {out}")
    return out


if __name__ == "__main__":
    main()
