"""cache_fill_s: the host seconds the program's decode-cache warm-up spent
filling the cache in set-up (``data/pipeline.py`` ``warmup_s``, counted by
the program on its warm-up thread); 0 in a cell whose feed keeps no cache.
Read in traced runs, as every per-layer metric is; nothing from a program
that does not count it."""

import importlib


def read(ctx):
    if not ctx.get("trace"):
        return None
    pipeline = importlib.import_module(
        "disentangle_mlp_tpu_torch.data.pipeline")
    return getattr(pipeline, "warmup_s", None)
