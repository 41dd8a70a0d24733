"""The port's spans, marks and tracing counters (utils/runtime.py), on the
CPU: spans off cost one shared null context and leave nothing in a
profile; spans on leave the feed's nested ``dmt.feed.*`` ranges, none
named as the benchmark's own ranges; the batches and the steps' numbers
are the same bit for bit either way, BatchNorm's backward-mark functions
included; the decode-cache warm-up counts its seconds. The card's cases
(marks inside a CUDA graph) are in tests/test_torch_port_card_training.py.
"""

import contextlib

import numpy as np
import pytest
import torch

from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.data import pipeline
from disentangle_mlp_tpu_torch.data.pipeline import (DataLoader,
                                                     ImageFolderSource,
                                                     SyntheticSource)
from disentangle_mlp_tpu_torch.train.scan import state_tensors
from disentangle_mlp_tpu_torch.train.vae import VAEExperiment
from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
from disentangle_mlp_tpu_torch.utils import runtime

# h100_bench/tracing.py's own ranges, which the program's must not shadow
HARNESS_SPANS = {"feed", "step", "draw", "epoch_end", "traced_window"}
JPEG_FIXTURE = (__import__("pathlib").Path(pipeline.__file__).parent
                / "fixtures" / "jpeg")
TOY = dict(n_hidden=16, n_z=[8, 4, 4], representation_size=4, head_width=32,
           decoder_channels=[8, 8, 8], disc_channels=[4, 8, 8, 8],
           disc_feature_dim=32, img_size=32)
STEPS, BATCH = 3, 4


@contextlib.contextmanager
def spans(on: bool):
    prev = runtime.spans_on()
    runtime.set_spans(on)
    try:
        yield
    finally:
        runtime.set_spans(prev)


def profiled(fn):
    """(fn's result, the dmt.* ranges of a CPU profile: (name, start,
    end))."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith("dmt.")]
    return out, ranges


def batches(loader, n=None):
    out = []
    for i, (x, y) in enumerate(loader):
        if n is not None and i == n:
            break
        out.append((x.clone(), y.clone()))
    return out


def synthetic_loader():
    return DataLoader(SyntheticSource(size=16, img_size=8, seed=3), 4,
                      shuffle=True, seed=5, device="cpu")


def folder_loader(cache: str):
    return DataLoader(ImageFolderSource(str(JPEG_FIXTURE), img_size=16,
                                        num_workers=2, cache=cache,
                                        device="cpu"), 4, shuffle=True,
                      seed=5, device="cpu")


def inside(child, parents) -> bool:
    return any(a <= child[1] and child[2] <= b for _, a, b in parents)


def test_port_spans_off_are_one_null_context_and_leave_no_range():
    with spans(False):
        a, b = runtime.span("dmt.x"), runtime.span("dmt.y")
        assert a is b and isinstance(a, contextlib.nullcontext)
        _, ranges = profiled(lambda: batches(synthetic_loader()))
    assert ranges == []


@pytest.mark.parametrize("case", ["synthetic", "folder_cached",
                                  "folder_uncached"])
def test_port_feed_leaves_nested_ranges_with_spans_on(case):
    """A cached folder's second epoch gathers; its first epoch, and every
    uncached one, decodes."""
    cached = case == "folder_cached"
    if case == "synthetic":
        make, children = synthetic_loader, {"dmt.feed.queue",
                                            "dmt.feed.sync"}
    else:
        def make():
            loader = folder_loader("on" if cached else "off")
            if cached:
                batches(loader)  # epoch 1 fills the cache
            return loader

        children = {"dmt.feed.queue", "dmt.feed.sync", "dmt.feed.normalize"}
        children |= ({"dmt.feed.gather"} if cached else
                     {"dmt.feed.decode", "dmt.feed.decode.nvjpeg",
                      "dmt.feed.decode.resize"})
    loader = make()
    with spans(True):
        got, ranges = profiled(lambda: batches(loader))
    names = {n for n, _, _ in ranges}
    assert names == {"dmt.feed"} | children
    assert not names & HARNESS_SPANS
    feeds = [r for r in ranges if r[0] == "dmt.feed"]
    assert len(feeds) == len(loader) + 1  # the last finds the epoch's end
    assert all(inside(r, feeds) for r in ranges if r[0] != "dmt.feed")
    decode = [r for r in ranges if r[0] == "dmt.feed.decode"]
    assert all(inside(r, decode) for r in ranges
               if r[0].startswith("dmt.feed.decode."))
    with spans(False):
        want = batches(make())
    for (x, y), (wx, wy) in zip(got, want):
        assert torch.equal(x, wx) and torch.equal(y, wy)


def test_port_cache_warmup_counts_its_seconds():
    loader = folder_loader("on")
    before = pipeline.warmup_s
    warm = loader.start_cache_warmup()
    warm.join(timeout=60)
    assert not warm.is_alive()
    assert pipeline.warmup_s > before


def _run(which: str, on: bool):
    """3 steps of a toy-width experiment from one seed and fixed draws,
    with spans ``on``; returns its metrics and state, as arrays."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (BATCH, 32, 32, 3))
                         .astype(np.float32))
    if which == "vae":
        cfg = Config(name="trace_vae", batch_size_train=BATCH,
                     dtype="float32", **TOY)
        make = VAEExperiment
        draws = [{"eps": rng.normal(size=(BATCH, 16))} for _ in range(STEPS)]
    else:
        cfg = Config(name="trace_bvg", batch_size_train=BATCH,
                     dtype="float32", beta=25.0, freeze_mode="observed",
                     **TOY)
        make = VAEGANExperiment
        draws = [{"labels": {"real": 0.9, "fake": 0.1},
                  **{k: rng.normal(size=(BATCH, 16))
                     for k in ("noise", "eps_dec", "eps_enc")}}
                 for _ in range(STEPS)]
    exp = make(cfg, "cpu")
    with spans(on):
        metrics = [exp.train_step(x, draws={
            k: v if k == "labels" else np.asarray(v, np.float32)
            for k, v in d.items()}) for d in draws]
    return ([m[k].detach().numpy() for m in metrics for k in sorted(m)]
            + [t.detach().numpy().copy() for t in state_tensors(exp)])


@pytest.mark.parametrize("which", ["vae", "betavaegan"])
def test_port_steps_are_bit_identical_with_spans_on(which):
    """Spans on put BatchNorm's identity functions (whose backward marks)
    into the autograd graph; nothing else may change."""
    off, on = _run(which, False), _run(which, True)
    assert len(off) == len(on)
    for i, (a, b) in enumerate(zip(off, on)):
        np.testing.assert_array_equal(a, b, err_msg=f"{which} tensor {i}")


def test_port_batchnorm_marks_its_backward_only_with_spans_on():
    """With spans on the output's grad_fn is the backward-mark function,
    and marks on the CPU launch nothing."""
    from disentangle_mlp_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(3)
    x = torch.randn(4, 3, 2, 2, requires_grad=True)
    with spans(False):
        assert "MarkBackward" not in type(bn(x).grad_fn).__name__
    with spans(True):
        y = bn(x)
        assert type(y.grad_fn).__name__ == "_MarkBackwardBackward"
        y.sum().backward()
        runtime.mark("dmt.test.begin", x)  # a CPU tensor: a no-op
    assert x.grad is not None
