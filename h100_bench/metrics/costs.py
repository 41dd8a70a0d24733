"""Operation and byte counts of the layer kinds the benchmark times, and
the peaks of the card they are held against. One function a layer kind;
every count follows from the shapes alone.

The peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit
(dense rates): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32
outside them, 3.35 TB/s of HBM3.

The byte count of the dense kernel ``fused_linear`` is the one that
``chip_smoke.py``'s kernel table uses (copied here, frozen): x in its own
dtype, the float32 weight and bias each read once, the bf16 output
written once.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def conv2d_flops(batch: int, cin: int, cout: int, k: int, h_out: int,
                 w_out: int) -> float:
    """A k x k convolution: one multiply-add per output element, input
    channel and kernel tap."""
    return 2.0 * batch * h_out * w_out * cout * cin * k * k


def conv_transpose2d_flops(batch: int, cin: int, cout: int, k: int,
                           h_in: int, w_in: int) -> float:
    """A k x k transposed convolution: every input element scatters into
    k * k * cout outputs."""
    return 2.0 * batch * h_in * w_in * cin * cout * k * k


def linear_flops(m: int, k: int, n: int) -> float:
    """(m, k) x (k, n)."""
    return 2.0 * m * k * n


def fused_linear_bytes(m: int, k: int, n: int, x_bytes: int) -> float:
    """x (m, k) in ``x_bytes`` a value, the float32 weight (k, n) and bias
    (n,), the bf16 output (m, n)."""
    return float(m * k * x_bytes + k * n * 4 + n * 4 + m * n * 2)


def bound_seconds(flops: float, nbytes: float,
                  peak_flops: float = PEAK_BF16_FLOPS,
                  peak_bytes: float = PEAK_HBM_BYTES) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / peak_bytes)


def fused_linear_bound_seconds(m: int, k: int, n: int, x_bytes: int
                               ) -> float:
    return bound_seconds(linear_flops(m, k, n),
                         fused_linear_bytes(m, k, n, x_bytes))
