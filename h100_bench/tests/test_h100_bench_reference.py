"""The plain reference against the program's step at toy widths on the
CPU: both in float32, from the same weights, batches and draws, so every
number is round-off; and the feed's batches against the reference's."""

import statistics

import numpy as np
import pytest

from bench_toy import TOY, run_toy, toy


@pytest.mark.parametrize("cell", ["betavaegan_celeba64.synthetic",
                                  "vae_celeba64.jpeg_cached",
                                  "betavaegan_celeba64.jpeg_nocache"])
def test_program_matches_reference_in_float32(cell, tmp_path):
    import harness

    spec = harness.Spec(cell)
    s = harness.Session(spec, 20261017, "cpu", TOY,
                        tree_base=tmp_path / "trees")
    s.first_steps()
    prog, c = s.readings, s.c
    batches = dict(s.checked)
    s.close()
    ref = harness.reference_readings(spec, 20261017, "cpu", TOY)
    feed = harness.feed_numbers(c, 20261017, batches)
    assert feed["feed"] < 1e-6 and feed["feed_mean"] < 1e-7
    for p, r in zip(prog["losses"], ref["losses"]):
        for k in r:
            # the KL term sums nearly cancelling terms at the start
            tol = 5e-3 if k == "kld" else 1e-3
            assert abs(p[k] - r[k]) <= tol * abs(r[k]), (k, p[k], r[k])
    for what in ("grad", "change", "stats"):
        gaps = [abs(prog[what][k] - r) / r
                for k, r in ref[what].items() if r > 0]
        # Adam moves a leaf whose gradient is round-off by +-lr, so a few
        # small leaves read far apart; the leaves as a whole agree
        assert statistics.median(gaps) < 1e-3, what
        assert np.percentile(gaps, 75) < 1e-2, what


def test_a_whole_run_is_correct_and_has_the_contract_keys(tmp_path):
    res, failed = run_toy("vae_celeba64.jpeg_cached", 5, tmp_path)
    assert not failed and res["correct"] is True
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert set(res["metrics"]) == {"train_img_per_s", "step_ms_p95",
                                   "setup_s"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["device"]["count"] == 1
    # the tree was made under tmp_path by this run, the libraries earlier
    assert res["first_run"]["made_jpeg_tree"] is True
    assert res["window"]["decoded"] == 0   # the cache was filled in set-up


@pytest.mark.parametrize("cell,host_metrics", [
    ("vae_celeba64.jpeg_cached", {"step_mfu", "device_idle_share"}),
    ("betavaegan_celeba64.jpeg_nocache",
     {"feed_wait_ms", "step_mfu", "device_idle_share"})])
def test_a_traced_run_prints_the_per_layer_metrics(cell, host_metrics,
                                                   tmp_path):
    res, failed = run_toy(cell, 6, tmp_path, trace=True,
                          overrides=toy(feed={"size": 32}))
    assert not failed and res["correct"] is True
    # on the CPU the device readers find nothing to read and stay silent;
    # feed_wait_ms is read in the cells its BENCHMARK.json entry lists
    assert set(res["metrics"]) == host_metrics
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
