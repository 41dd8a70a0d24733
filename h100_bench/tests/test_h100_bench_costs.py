"""The FLOP and byte counters against counts made by hand."""

import pytest

from bench_toy import BENCH  # noqa: F401  (puts the harness on the path)


def test_conv_transposed_conv_and_fused_linear_by_hand():
    import harness

    c = harness.costs()
    # encoder conv2: 64 -> 128 channels, 5x5, stride 2, 32x32 -> 16x16,
    # batch 256: each of 256*16*16*128 outputs sums 64*25 products
    assert c.conv2d_flops(256, 64, 128, 5, 16, 16) == \
        2 * (256 * 16 * 16 * 128) * (64 * 25) == 26843545600
    # decoder deconv1: 8x8x256 in -> 256 channels, 5x5: each of
    # 256*8*8*256 inputs scatters into 25*256 outputs
    assert c.conv_transpose2d_flops(256, 256, 256, 5, 8, 8) == \
        2 * (256 * 8 * 8 * 256) * (25 * 256) == 53687091200
    # mu_fc1: x (256, 16384) bf16, w (16384, 2048) float32, bias float32,
    # out (256, 2048) bf16
    nbytes = 256 * 16384 * 2 + 16384 * 2048 * 4 + 2048 * 4 + 256 * 2048 * 2
    assert c.fused_linear_bytes(256, 16384, 2048, 2) == nbytes == 143663104
    assert c.linear_flops(256, 16384, 2048) == 2 * 256 * 16384 * 2048
    assert c.fused_linear_bound_seconds(256, 16384, 2048, 2) == \
        pytest.approx(nbytes / 3.35e12)          # bytes bound it
    assert c.bound_seconds(1e15, 1.0) == pytest.approx(1e15 / 989e12)


@pytest.mark.parametrize("cell,launches,tflop", [
    ("betavaegan_celeba64.synthetic", 21, 5.123102212096),
    ("vae_celeba64.jpeg_cached", 5, 0.932544774144)])
def test_step_counts_at_the_published_widths(cell, launches, tflop):
    import harness

    spec = harness.Spec(cell)
    c = spec.sizes()
    assert len(spec.reference.fused_linear_launches(c)) == launches
    assert spec.reference.step_flops(c, harness.costs()) / 1e12 == \
        pytest.approx(tflop, rel=1e-12)
    # chip_smoke.py's bounds of the same launches: 0.4068 and 0.0921 ms
    bound = sum(harness.costs().fused_linear_bound_seconds(*l)
                for l in spec.reference.fused_linear_launches(c))
    assert bound * 1e3 == pytest.approx(
        0.4068 if launches == 21 else 0.0921, abs=1e-4)


def test_vae_step_by_hand():
    """The VAE step's FLOPs counted layer by layer by hand: the encoder's
    forward and weight gradients and its input gradients but the first
    layer's; the decoder's forward, weight and input gradients."""
    import harness

    b, k2 = 256, 25
    enc = [2 * b * 32 * 32 * 64 * 3 * k2,        # conv1, 64x64 -> 32x32
           2 * b * 16 * 16 * 128 * 64 * k2,      # conv2
           2 * b * 8 * 8 * 256 * 128 * k2,       # conv3
           2 * b * 16384 * 2048, 2 * b * 2048 * 128,   # mu head
           2 * b * 16384 * 2048, 2 * b * 2048 * 128]   # logvar head
    dec = [2 * b * 128 * 16384,                  # preprocess
           2 * b * 8 * 8 * 256 * 256 * k2,       # deconv1, 8x8 in
           2 * b * 16 * 16 * 256 * 128 * k2,     # deconv2
           2 * b * 32 * 32 * 128 * 32 * k2,      # deconv3
           2 * b * 64 * 64 * 32 * 3 * k2]        # deconv4, stride 1
    by_hand = 3 * sum(enc) - enc[0] + 3 * sum(dec)
    spec = harness.Spec("vae_celeba64.jpeg_cached")
    assert spec.reference.step_flops(spec.sizes(), harness.costs()) == \
        by_hand
