"""Shared helpers of the benchmark's CPU tests: the harness on the path
and a toy size of each configuration (the widths cut, the batch 8, an
epoch of 64 images), small enough for the CPU."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TOY = {"n_hidden": 16, "n_z": [8, 8, 8], "representation_size": 4,
       "head_width": 32, "decoder_channels": [8, 8, 8],
       "disc_channels": [4, 8, 8, 8], "disc_feature_dim": 32,
       "batch_size_train": 8, "dtype": "float32", "feed": {"size": 64}}


def toy(**kw):
    return {**TOY, **kw}


def run_toy(workload, seed, tmp_path, seconds=0.5, trace=False, **kw):
    import harness
    import run

    return run.run_cell(harness.Spec(workload), seed, seconds, trace, "cpu",
                        overrides=kw.pop("overrides", TOY),
                        tree_base=Path(tmp_path) / "trees", **kw)
