from .samples import (gen_fid_reconstructions, gen_reconstructions,
                      generate_fid_samples, generate_samples)

__all__ = [
    "gen_fid_reconstructions",
    "gen_reconstructions",
    "generate_fid_samples",
    "generate_samples",
]
