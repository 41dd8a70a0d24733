"""depthwise_roofline's reader: its byte count at NVAE's published widths,
its silence where no depthwise kernel ran or the reference has no depthwise
convolution, and its arithmetic on a made-up trace."""

import json

import pytest

from bench_toy import BENCH  # noqa: F401  (puts the harness on the path)

NVAE_CELL = "nvae_celeba64.synthetic"
# batch 128 × Σ C·H·W over the 72 depthwise 5×5 (40 × 768·32², 20 ×
# 1,536·16², 8 × 3,072·8², 3,072·16², 1,536·32², 384·64², 192·64²), 10 B an
# element: 4 forward, 6 backward
NVAE_BYTES = 128 * (40 * 768 * 32 ** 2 + 20 * 1536 * 16 ** 2
                    + 8 * 3072 * 8 ** 2 + 3072 * 16 ** 2 + 1536 * 32 ** 2
                    + 384 * 64 ** 2 + 192 * 64 ** 2) * 10
KERNELS = {"void (anonymous namespace)::dmt_dwconv_fwd<__nv_bfloat16, 5>":
           0.080,
           "void (anonymous namespace)::dmt_dwconv_bwd<__nv_bfloat16, 5>":
           0.150,
           "void (anonymous namespace)::dmt_dwconv_bwd_finalize<"
           "__nv_bfloat16>": 0.002}
OTHERS = {"dgrad2d_c1_k1_nhwc_specialized": 0.32,
          "void at::native::elementwise_kernel<128, 4>": 0.2}


def _reader():
    import harness

    return harness.Spec(NVAE_CELL).reader("depthwise_roofline")


def _ctx(cell, by_name, steps=8):
    import harness

    spec = harness.Spec(cell)
    return {"config": spec.sizes(), "reference": spec.reference,
            "costs": harness.costs(), "window": {},
            "trace": {"steps": steps, "device_s_by_name": by_name}}


def test_the_bytes_of_nvae_step():
    import harness

    spec = harness.Spec(NVAE_CELL)
    c = spec.sizes()
    got = _reader().step_bytes(spec.reference.layers(c),
                               c["batch_size_train"])
    assert got == NVAE_BYTES == 58_384_711_680
    assert got / 3.35e12 * 1e3 == pytest.approx(17.428, abs=1e-3)


def test_the_arithmetic_on_a_made_up_trace():
    got = _reader().read(_ctx(NVAE_CELL, {**KERNELS, **OTHERS}, steps=8))
    device_s = sum(KERNELS.values())
    assert got == pytest.approx(NVAE_BYTES / 3.35e12 * 8 / device_s * 100,
                                rel=1e-12)
    assert 0 < got <= 100


def test_silent_without_its_kernels():
    reader = _reader()
    assert reader.read(_ctx(NVAE_CELL, OTHERS)) is None
    assert reader.read({**_ctx(NVAE_CELL, KERNELS), "trace": None}) is None


@pytest.mark.parametrize("cell", ["betavaegan_celeba64.synthetic",
                                  "vae_celeba64.jpeg_cached"])
def test_silent_for_the_celeba_references(cell):
    assert _reader().read(_ctx(cell, {**KERNELS, **OTHERS})) is None


def test_its_entry_lists_the_nvae_cell_alone():
    import harness

    bench = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}["depthwise_roofline"]
    assert entry == {"name": "depthwise_roofline", "unit": "%",
                     "better": "higher", "source": "device_trace",
                     "layer": "kernel depthwise_conv",
                     "moves": "train_img_per_s",
                     "workloads": [NVAE_CELL]}
