"""The trace reduction: busy time as a union, idle gaps charged to the
host span that covers them, categories by the frozen kernel names."""

import pytest

from bench_toy import BENCH  # noqa: F401


def test_reduce_trace_by_hand():
    import tracing

    dev = [("fused_linear_stream_kernel", 0, 10),
           ("vectorized_elementwise_kernel", 5, 20),     # overlaps: union
           ("cudnn_convolution_fprop", 30, 40),
           ("Memcpy HtoD (Pinned -> Device)", 60, 70)]
    host = [("step", 0, 22), ("feed", 22, 45), ("step", 45, 100)]
    tr = tracing.reduce_trace(dev, host, (0, 100), steps=2)
    assert tr["busy_s"] == pytest.approx(40e-6)          # 0-20, 30-40, 60-70
    assert tr["idle_share"] == pytest.approx(0.6)
    # gap 20-30 mostly under the feed, 40-60 mostly under a step, 70-100
    # under a step
    assert tr["idle_s_by_span"] == pytest.approx({"feed": 10e-6,
                                                  "step": 50e-6})
    cats = tr["by_category_ms_per_step"]
    assert cats["fused_linear"] == pytest.approx(10e-3 / 2)
    assert cats["elementwise"] == pytest.approx(15e-3 / 2)
    assert cats["convolution"] == pytest.approx(10e-3 / 2)
    assert cats["memcpy/memset"] == pytest.approx(10e-3 / 2)
    b = tracing.breakdown(tr)
    assert b["device_ops"][0][0] == "vectorized_elementwise_kernel"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_readers_stay_silent_without_a_trace():
    import harness

    spec = harness.Spec("betavaegan_celeba64.synthetic")
    ctx = {"config": spec.sizes(), "reference": spec.reference,
           "costs": harness.costs(), "trace": None,
           "window": {"steps": 0, "wall_s": 0.0, "feed_waits_s": []}}
    for m in spec.per_layer():
        assert spec.reader(m["name"]).read(ctx) is None, m["name"]


def test_roofline_reader_refuses_a_launch_count_that_disagrees():
    import harness

    spec = harness.Spec("vae_celeba64.jpeg_cached")
    tr = {"steps": 2, "by_category_ms_per_step": {"fused_linear": 0.2},
          "fused_linear_launches": 10, "busy_s": 1.0, "idle_share": 0.1}
    ctx = {"config": spec.sizes(), "reference": spec.reference,
           "costs": harness.costs(), "trace": tr, "window": {}}
    r = spec.reader("fused_linear_roofline")
    assert r.read(ctx) == pytest.approx(0.0921077 / 0.2 * 100, rel=1e-5)
    tr["fused_linear_launches"] = 9
    assert r.read(ctx) is None


def test_from_profiler_keeps_annotations_off_the_device_timeline():
    """A record_function range also appears as a CUDA-side annotation
    spanning what it covers; it is no device activity."""
    import types

    import torch

    import tracing

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, a, b, dev, ann=False):
        return types.SimpleNamespace(
            name=name, device_type=dev, is_user_annotation=ann,
            time_range=types.SimpleNamespace(start=a, end=b))

    events = [ev("traced_window", 0, 100, cpu, True),
              ev("step", 0, 50, cpu, True), ev("step", 0, 50, cuda, True),
              ev("feed", 50, 100, cpu, True), ev("feed", 50, 100, cuda, True),
              ev("kernel_a", 10, 40, cuda), ev("aten::add", 5, 6, cpu)]
    prof = types.SimpleNamespace(events=lambda: events)
    tr = tracing.from_profiler(prof, steps=1)
    assert tr["busy_s"] == pytest.approx(30e-6)
    assert tr["device_s_by_name"] == pytest.approx({"kernel_a": 30e-6})
    # gaps 0-10 (under the step) and 40-100 (mostly under the feed)
    assert tr["idle_s_by_span"] == pytest.approx({"step": 10e-6,
                                                  "feed": 60e-6})
