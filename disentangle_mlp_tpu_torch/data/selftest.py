"""Per-process slicing check of the port's loader
(disentangle_mlp_tpu/data/selftest.py).

Proves the slicing contract of :mod:`.pipeline` in one process: H simulated
processes each read only their contiguous slice of the global batch, and
the concatenation equals the single-process batch bit for bit. Kept out of
the loader's module; the tests run it."""

from __future__ import annotations

import numpy as np
import torch

from .pipeline import DataLoader, SyntheticSource


def hostshard_selftest(device="cpu") -> None:

    class Recording:
        """Records each load_batch call (the read thread keeps loading
        later batches, so only the first call is the first batch)."""

        def __init__(self, inner):
            self.inner = inner
            self.calls = []

        def __len__(self):
            return len(self.inner)

        def load_batch(self, indices):
            self.calls.append(np.asarray(indices).tolist())
            return self.inner.load_batch(indices)

    H, B = 2, 8
    base = SyntheticSource(size=32, img_size=8, seed=7)
    full_x, _ = next(iter(DataLoader(
        base, B, shuffle=True, seed=13, device=device, process_index=0,
        process_count=1)))
    parts, first = [], []
    for h in range(H):
        rec = Recording(SyntheticSource(size=32, img_size=8, seed=7))
        x, _ = next(iter(DataLoader(
            rec, B, shuffle=True, seed=13, device=device,
            process_index=h, process_count=H)))
        assert x.shape[0] == B // H, x.shape
        parts.append(x)
        first.append(rec.calls[0])
    assert not set(first[0]) & set(first[1]), "hosts decoded overlapping rows"
    assert len(first[0]) == len(first[1]) == B // H
    assert torch.equal(torch.cat(parts), full_x)
