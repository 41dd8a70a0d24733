"""A run whose timed path is broken comes out not correct: a step that
leaves the state unchanged, one that leaves one BatchNorm's running
statistics unchanged, a step on half the batch, a feed whose rows are
altered, and the control (the reference in float8 operands in the
program's place). Each drives the rest of a run on the CPU at toy size
under the cell's own limits."""

import numpy as np
import pytest
import torch

from bench_toy import run_toy, toy

CELLS = ["betavaegan_celeba64.synthetic", "vae_celeba64.jpeg_cached"]


def state_unchanged(session, x):
    from disentangle_mlp_tpu_torch.train.scan import state_tensors

    state = state_tensors(session.run.exp)
    saved = [t.detach().clone() for t in state]
    m = session.run.step(x)
    with torch.no_grad():
        for t, s in zip(state, saved):
            t.copy_(s)
    return m


def one_batchnorm_unchanged(session, x):
    """The step, with the first BatchNorm's running statistics put back."""
    bufs = [b for n, b in session.run.exp.vae.named_buffers()
            if n.endswith((".running_mean", ".running_var"))][:2]
    saved = [b.detach().clone() for b in bufs]
    m = session.run.step(x)
    with torch.no_grad():
        for b, v in zip(bufs, saved):
            b.copy_(v)
    return m


def half_batch(session, x):
    return session.run.step(x[: x.shape[0] // 2])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [state_unchanged, one_batchnorm_unchanged,
                                   half_batch],
                         ids=["state_unchanged", "one_batchnorm_unchanged",
                              "half_batch"])
def test_a_broken_step_is_not_correct(cell, fault, tmp_path):
    res, failed = run_toy(cell, 11, tmp_path, step_fault=fault)
    assert res["correct"] is False and failed
    if fault is one_batchnorm_unchanged:
        # one layer's update, which the medians cannot see
        assert "stats1" in failed


def test_altered_feed_rows_are_not_correct(tmp_path):
    res, failed = run_toy("vae_celeba64.jpeg_cached", 12, tmp_path,
                          feed_alter=lambda a: np.roll(a, 1, axis=0))
    assert res["correct"] is False and set(failed) >= {"feed", "feed_mean"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_is_not_correct(cell, tmp_path):
    from reference import nets

    res, failed = run_toy(cell, 13, tmp_path, ref_q=nets.FP8,
                          overrides=toy(dtype="bfloat16"))
    assert res["correct"] is False and failed
