"""The NVAE configuration's counts by hand at a toy size, and a toy run of
its cell on the CPU through the harness."""

import pytest

from bench_toy import run_toy

# one scale of one group each side of a down cell: a preprocess block of one
# down cell, one cell a group, a postprocess block of one up cell, batch 2
HAND = {"num_channels_enc": 8, "num_channels_dec": 8,
        "num_preprocess_blocks": 1, "num_preprocess_cells": 1,
        "num_postprocess_blocks": 1, "num_postprocess_cells": 1,
        "num_latent_scales": 2, "num_groups_per_scale": 1,
        "ada_groups": False, "num_latent_per_group": 2,
        "num_cell_per_cond_enc": 1, "num_cell_per_cond_dec": 1,
        "num_mixture_dec": 1, "img_size": 16, "input_channels": 3,
        "batch_size_train": 2}

TOY = {"num_channels_enc": 8, "num_channels_dec": 8, "num_latent_scales": 2,
       "num_groups_per_scale": 2, "ada_groups": False,
       "num_latent_per_group": 4, "img_size": 32, "batch_size_train": 4,
       "dtype": "float32", "feed": {"size": 16}}


def _reference():
    from reference import nvae

    return nvae


def test_batchnorm_calls_by_hand():
    b = 2
    want = [
        (b * 256, 8, "swish"), (b * 64, 16, "swish"),      # pre: down 8→16
        (b * 64, 16, "swish"), (b * 64, 16, "swish"),      # enc.0 at 8×8
        (b * 64, 16, "swish"), (b * 16, 32, "swish"),      # enc.1 down
        (b * 16, 32, "swish"), (b * 16, 32, "swish"),      # enc.2 at 4×4
        (b * 64, 32, "none"), (b * 64, 192, "swish"),      # dec.0 up, ×6
        (b * 64, 192, "swish"), (b * 64, 16, "none"),
        (b * 64, 16, "none"), (b * 64, 96, "swish"),       # dec.1, ×6
        (b * 64, 96, "swish"), (b * 64, 16, "none"),
        (b * 256, 16, "none"), (b * 256, 48, "swish"),     # post.0 up, ×3
        (b * 256, 48, "swish"), (b * 256, 8, "none")]
    assert _reference().batchnorm_calls(HAND) == want


def _conv(b, cin, cout, k, hw):
    return 2 * b * hw * hw * cout * cin * k * k


def test_step_flops_by_hand():
    import harness

    b = 2
    se = {16: 2 * (2 * b * 16 * 4), 32: 2 * (2 * b * 32 * 4),
          8: 2 * (2 * b * 8 * 4)}
    stem = _conv(b, 3, 8, 3, 16)
    rest = [
        4 * _conv(b, 8, 4, 1, 8), _conv(b, 8, 16, 3, 8),     # pre.0 down
        _conv(b, 16, 16, 3, 8), se[16],
        2 * _conv(b, 16, 16, 3, 8), se[16],                   # enc.0
        4 * _conv(b, 16, 8, 1, 4), _conv(b, 16, 32, 3, 4),   # enc.1 down
        _conv(b, 32, 32, 3, 4), se[32],
        2 * _conv(b, 32, 32, 3, 4), se[32],                   # enc.2
        _conv(b, 16, 16, 1, 8),                               # enc_comb.0
        _conv(b, 32, 32, 1, 4),                               # enc0
        _conv(b, 32, 4, 3, 4), _conv(b, 16, 4, 3, 8),         # enc_sampler
        _conv(b, 16, 4, 1, 8),                                # dec_sampler
        _conv(b, 32, 16, 1, 8), _conv(b, 32, 192, 1, 8),     # dec.0 up
        _conv(b, 1, 192, 5, 8), _conv(b, 192, 16, 1, 8), se[16],
        _conv(b, 16, 96, 1, 8), _conv(b, 1, 96, 5, 8),        # dec.1
        _conv(b, 96, 16, 1, 8), se[16],
        _conv(b, 34, 32, 1, 4), _conv(b, 18, 16, 1, 8),       # dec_comb
        _conv(b, 16, 8, 1, 16), _conv(b, 16, 48, 1, 16),      # post.0 up
        _conv(b, 1, 48, 5, 16), _conv(b, 48, 8, 1, 16), se[8],
        _conv(b, 8, 10, 3, 16)]                               # head
    # forward, weight and input gradients; the images need no gradient
    want = 2 * stem + 3 * sum(rest)
    assert _reference().step_flops(HAND, harness.costs()) == want
    assert len(_reference().fused_linear_launches(HAND)) == 2 * 7


def test_published_counts():
    """At the published widths: 436 BatchNorm calls, 292 of them with the
    Swish (74 res_bnswish cells, 2 each; 72 mconv cells, 2 of their 4),
    146 cells with two dense layers each, and 31.9 TFLOP of convolutions
    and dense layers a step at batch 128 (83 GFLOP an image forward)."""
    import harness

    spec = harness.Spec("nvae_celeba64.synthetic")
    c = spec.sizes()
    ref = spec.reference
    calls = ref.batchnorm_calls(c)
    assert len(calls) == 436
    assert sum(1 for _, _, a in calls if a == "swish") == 292
    assert (128 * 32 * 32, 768, "swish") in calls
    assert len(ref.fused_linear_launches(c)) == 2 * 146
    assert ref.step_flops(c, harness.costs()) / 1e12 == \
        pytest.approx(31.908620795904, rel=1e-12)


@pytest.mark.parametrize("trace", [False, True])
def test_a_toy_run_is_correct(tmp_path, trace):
    res, failed = run_toy("nvae_celeba64.synthetic", 2 ** 31 + 11, tmp_path,
                          trace=trace, overrides=TOY)
    assert not failed and res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    for k in ("loss.recon", "loss.kl", "grad", "stats", "change"):
        assert res["numbers"][k] < 1e-2, k
    if trace:
        # the device readers (the BatchNorm kernels' and fused_linear's
        # rooflines, the step's busy time) find nothing to read on the CPU
        assert set(res["metrics"]) == {"step_mfu", "device_idle_share",
                                       "cache_fill_s"}
    else:
        assert set(res["metrics"]) == {"train_img_per_s", "step_ms_p95",
                                       "setup_s"}
