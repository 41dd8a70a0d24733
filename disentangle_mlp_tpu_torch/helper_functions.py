"""Drop-in compatibility shim of the port (disentangle_mlp_tpu/
helper_functions.py): the reference's experiment scripts import ``from
helper_functions import *`` (reference: experiments/new_vae.py:17,
new_betavaegan.py:24, the deployed copy of utils/utils.py). Users porting
scripts can keep that import against this package; the latents are drawn
on ``device`` (default cuda)."""

from .eval.samples import (gen_fid_reconstructions, gen_reconstructions,
                           generate_fid_samples, generate_samples)

__all__ = [
    "gen_fid_reconstructions",
    "gen_reconstructions",
    "generate_fid_samples",
    "generate_samples",
]
