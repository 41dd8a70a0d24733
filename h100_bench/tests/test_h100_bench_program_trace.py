"""The reduction of the program's own spans and marks (program_trace.py)
on hand-made event lists, its readers' silences, and the harness's own
reduction (tracing.py) left as it was by the program's ranges."""

import types

import pytest

from bench_toy import BENCH  # noqa: F401

MARK = "dmt_trace_mark"
# one replay's table: a step holding one BatchNorm's forward and backward
TABLE = ["dmt.step.begin", "dmt.bn0#1.fwd.begin", "dmt.bn0#1.fwd.end",
         "dmt.bn0#1.bwd.begin", "dmt.bn0#1.bwd.end", "dmt.step.end"]


def replay(t0):
    """One replay's device events from ``t0`` us: marks 1 us long, a conv,
    the BatchNorm's reduce and elementwise kernels, a gap of 2 us inside
    the step."""
    return [(MARK, t0, t0 + 1),                          # step begin
            ("cudnn_convolution_fprop", t0 + 1, t0 + 11),
            (MARK, t0 + 11, t0 + 12),                    # bn fwd begin
            ("reduce_kernel", t0 + 12, t0 + 16),
            ("vectorized_elementwise_kernel", t0 + 16, t0 + 20),
            (MARK, t0 + 20, t0 + 21),                    # bn fwd end
            ("cudnn_convolution_dgrad", t0 + 23, t0 + 33),  # after a gap
            (MARK, t0 + 33, t0 + 34),                    # bn bwd begin
            ("elementwise_kernel", t0 + 34, t0 + 40),
            (MARK, t0 + 40, t0 + 41),                    # bn bwd end
            (MARK, t0 + 41, t0 + 42)]                    # step end


def reduce(device, host=(), window=(0, 200), steps=2, table=TABLE,
           replays=2, recaptured=False):
    import program_trace

    return program_trace.reduce_program(device, list(host), window, steps,
                                        table, replays, recaptured)


def test_batchnorm_time_between_paired_marks_and_gaps_inside_replays():
    prog = reduce(replay(0) + replay(100))
    assert prog["marks_ok"] and prog["marks"] == 12
    # 4 + 4 forward, 6 backward, a replay; 2 replays over 2 steps
    assert prog["batchnorm_ms_per_step"] == pytest.approx(14e-3)
    assert prog["batchnorm_by_category_ms_per_step"] == pytest.approx(
        {"reduction": 4e-3, "elementwise": 10e-3})
    # the step's marks span 42 us, busy 40: the 2 us gap, a replay
    assert prog["graph_gap_ms_per_step"] == pytest.approx(2e-3)


def test_idle_is_charged_to_the_innermost_span_covering_most_of_it():
    import program_trace

    host = [("dmt.feed", 0, 100), ("dmt.feed.sync", 10, 40),
            ("dmt.feed.queue", 60, 70), ("dmt.graph.replay", 100, 110),
            ("aten::copy_", 10, 40)]
    dev = [("k", 0, 10), ("k", 50, 64), ("k", 90, 150)]
    prog = reduce(dev, host, window=(0, 160), steps=1, table=[], replays=0)
    # 10-50: under dmt.feed.sync for 30 of 40 us; 64-90: the queue covers
    # 6 of 26 us, so the feed, which covers it all; 150-160: nothing
    assert prog["idle_s_by_span"] == pytest.approx(
        {"dmt.feed.sync": 40e-6, "dmt.feed": 26e-6, "other": 10e-6})
    assert prog["host_ms_per_step"] == pytest.approx(
        {"dmt.feed": 0.1, "dmt.feed.sync": 0.03, "dmt.feed.queue": 0.01,
         "dmt.graph.replay": 0.01})
    assert program_trace.breakdown(prog)[0] == ["dmt.feed.sync",
                                                pytest.approx(40e-6)]
    assert not prog["marks_ok"]  # no table: nothing to pair


@pytest.mark.parametrize("fault", ["one_mark_short", "recaptured",
                                   "no_table"])
def test_mark_readings_are_silent_when_the_marks_do_not_add_up(fault):
    import program_trace

    dev = replay(0) + replay(100)
    kw = {}
    if fault == "one_mark_short":
        dev = dev[:-1]
    elif fault == "recaptured":
        kw["recaptured"] = True
    else:
        kw["table"] = []
    prog = reduce(dev, **kw)
    assert not prog["marks_ok"]
    ctx = {"trace": {"program": prog}}
    for key in ("batchnorm_ms_per_step", "graph_gap_ms_per_step"):
        assert program_trace.mark_reading(ctx, key) is None


def test_readers_are_silent_on_a_tree_without_spans():
    """The parent's program leaves no ``program`` in the trace: every new
    reader reads nothing, whatever else the trace holds."""
    import harness

    spec = harness.Spec("betavaegan_celeba64.jpeg_nocache")
    tr = {"steps": 2, "busy_s": 1.0, "idle_share": 0.1,
          "by_category_ms_per_step": {}, "idle_s_by_span": {}}
    for name in ("feed_queue_wait_ms", "feed_sync_ms", "feed_decode_ms",
                 "batchnorm_ms", "graph_gap_ms"):
        assert spec.reader(name).read({"trace": tr}) is None, name
        assert spec.reader(name).read({"trace": None}) is None, name
    prog = reduce(replay(0) + replay(100),
                  host=[("dmt.feed.sync", 0, 50)])
    tr["program"] = prog
    assert spec.reader("feed_sync_ms").read({"trace": tr}) == \
        pytest.approx(25e-3)
    assert spec.reader("feed_decode_ms").read({"trace": tr}) == 0.0
    assert spec.reader("batchnorm_ms").read({"trace": tr}) == \
        pytest.approx(14e-3)


def test_cache_fill_reader_reads_the_programs_counter():
    import harness
    from disentangle_mlp_tpu_torch.data import pipeline

    r = harness.Spec("vae_celeba64.jpeg_cached").reader("cache_fill_s")
    assert r.read({"trace": None}) is None
    assert r.read({"trace": {"steps": 1}}) == pipeline.warmup_s


def _ev(name, a, b, dev, ann=False):
    return types.SimpleNamespace(
        name=name, device_type=dev, is_user_annotation=ann,
        time_range=types.SimpleNamespace(start=a, end=b))


def test_harness_reduction_is_unchanged_by_the_programs_ranges():
    """The program's dmt.* ranges, host and their device-side annotations,
    leave every key of tracing.from_profiler as it was; program_trace
    reads them from the same profile."""
    import torch

    import program_trace
    import tracing

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    base = [_ev("traced_window", 0, 100, cpu, True),
            _ev("feed", 0, 50, cpu, True), _ev("feed", 0, 50, cuda, True),
            _ev("step", 50, 100, cpu, True), _ev("step", 50, 100, cuda, True),
            _ev("kernel_a", 10, 40, cuda), _ev("kernel_b", 60, 90, cuda)]
    program = [_ev("dmt.feed", 0, 48, cpu, True),
               _ev("dmt.feed", 0, 48, cuda, True),
               _ev("dmt.feed.sync", 5, 45, cpu, True),
               _ev("dmt.graph.replay", 55, 58, cpu, True),
               _ev("dmt.graph.replay", 55, 58, cuda, True)]

    def prof(events):
        return types.SimpleNamespace(events=lambda: events)

    assert tracing.from_profiler(prof(base), steps=1) == \
        tracing.from_profiler(prof(base + program), steps=1)
    got = program_trace.from_profiler(prof(base + program), 1, [], 0, False)
    assert got["host_ms_per_step"] == pytest.approx(
        {"dmt.feed": 0.048, "dmt.feed.sync": 0.04, "dmt.graph.replay": 0.003})
    # 0-10: the sync covers half, the feed all; 40-60: no span covers more
    # than half, the feed most (8 us against the sync's 5, the replay's
    # 3); 90-100: nothing
    assert got["idle_s_by_span"] == pytest.approx(
        {"dmt.feed": 30e-6, "other": 10e-6})
