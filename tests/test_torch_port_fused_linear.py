"""The port's fused_linear (disentangle_mlp_tpu_torch/ops/fused_linear.py)
against the JAX package's Pallas kernel run in interpret mode, plus its
autograd Function against autograd of the plain version.

On the CPU the wrapper computes with the plain version, so these tests pin
the function the CUDA kernel must compute; chip_smoke.py holds the kernel
against the same plain version on the GPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from disentangle_mlp_tpu.ops.pallas.matmul_fused import \
    fused_linear as jax_fused_linear
from disentangle_mlp_tpu_torch.cli.profile_step import categorize
from disentangle_mlp_tpu_torch.ops import fused_linear as fl

ACTS = ("none", "relu", "leaky_relu")
# the shapes of tests/test_pallas_ops.py: ragged (padded by the Pallas
# wrapper) and exact tile multiples
SHAPES = ((100, 300, 70), (128, 512, 128))
OUT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# float32 out: identical bf16 operands, only the summation order differs.
# bf16 out: one bf16 rounding apart (2⁻⁷ relative), atol for sums near 0.
TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
       "bfloat16": dict(rtol=8e-3, atol=1e-4)}


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("out", sorted(OUT))
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_port_fused_linear_plain_matches_pallas_interpret(shape, act, out):
    x, w, b = _inputs(*shape)
    t_out, j_out = OUT[out]
    want = jax_fused_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            activation=act, out_dtype=j_out, interpret=True)
    before = fl.launches
    got = fl.fused_linear(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), act, out_dtype=t_out)
    assert fl.launches == before  # CPU tensors never reach the kernel
    assert got.dtype == t_out and tuple(got.shape) == shape[::2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[out])


def test_port_fused_linear_bf16_input_and_no_bias():
    """bf16 x, no bias (JAX adds zeros), out_dtype defaulting to x's."""
    x, w, _ = _inputs(64, 96, 40, seed=1)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = jax_fused_linear(xj, jnp.asarray(w), None, interpret=True)
    got = fl.fused_linear(torch.from_numpy(x).bfloat16(), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **TOL["bfloat16"])


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_port_fused_linear_autograd_matches_plain(act, x_dtype):
    """The Function's backward (bf16 products, float32 accumulation) against
    autograd through the plain version, whose products are float32 and
    rounded to bf16 where it casts; one bf16 rounding apart."""
    x, w, b = _inputs(48, 80, 36, seed=2)
    dy = torch.from_numpy(np.random.default_rng(3).normal(
        size=(48, 36)).astype(np.float32))
    grads = []
    for fn in (fl.fused_linear, fl.fused_linear_plain):
        xt = torch.from_numpy(x).to(getattr(torch, x_dtype)).requires_grad_()
        # the (K, N) view of an (N, K) weight, as the port's Linear passes it
        wt = torch.from_numpy(w.T.copy()).requires_grad_()
        bt = torch.from_numpy(b).requires_grad_()
        y = fn(xt, wt.t(), bt, act, torch.float32)
        grads.append(torch.autograd.grad((y * dy).sum(), (xt, wt, bt)))
    for name, got, want in zip(("dx", "dw", "db"), *grads):
        assert got.dtype == want.dtype, name
        scale = want.float().abs().max().item()
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=0, atol=1e-2 * scale, err_msg=name)


def test_port_fused_linear_refuses_other_devices_and_bad_arguments():
    x = torch.zeros(4, 8, device="meta")
    w = torch.zeros(8, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fl.fused_linear(x, w)
    with pytest.raises(ValueError, match="activation"):
        fl.fused_linear(torch.zeros(4, 8), torch.zeros(8, 3),
                        activation="tanh")
    # argument checks of the CUDA path run before any build or launch
    with pytest.raises(ValueError, match="w must be contiguous"):
        fl._launch(torch.zeros(4, 8), torch.zeros(16, 6)[::2, ::2], None,
                   "none", torch.float32)
    with pytest.raises(ValueError, match="b must be"):
        fl._launch(torch.zeros(4, 8), torch.zeros(8, 3),
                   torch.zeros(3, dtype=torch.bfloat16), "none",
                   torch.float32)


BF16, F32 = torch.bfloat16, torch.float32
# (id, M, K, N, x dtype, w (N, K) read through its transpose, bases 16-byte
# aligned) -> (path, splits, workspace bytes) on a 132-SM card. The five
# call sites of one full-width training step, the FID decode, then the
# shapes the stream and dot paths refuse.
PLANS = [
    ("mu_fc1", 256, 16384, 2048, BF16, True, True,
     ("stream", 8, 8 * 256 * 2048 * 4)),
    ("lth_features", 256, 16384, 2048, BF16, True, True,
     ("stream", 8, 8 * 256 * 2048 * 4)),
    ("preprocess", 256, 128, 16384, BF16, True, True, ("stream", 1, 0)),
    ("mu_fc2", 256, 2048, 128, BF16, True, True,
     ("stream", 32, 32 * 256 * 128 * 4)),
    ("sigmoid_output", 256, 2048, 1, F32, True, True, ("dot", 1, 0)),
    ("fid_decode", 1000, 128, 16384, BF16, True, True, ("stream", 1, 0)),
    ("odd_f32_x", 100, 300, 70, F32, True, True, ("generic", 1, 0)),
    ("kn_layout", 256, 16384, 2048, BF16, False, True, ("generic", 1, 0)),
    ("bf16_row_stride_600B", 100, 300, 70, BF16, True, True,
     ("generic", 1, 0)),
    ("unaligned_base", 256, 16384, 2048, BF16, True, False,
     ("generic", 1, 0)),
    ("f32_x_wide", 256, 2048, 128, F32, True, True, ("generic", 1, 0)),
]


@pytest.mark.parametrize("m, k, n, x_dtype, w_nk, aligned, want",
                         [p[1:] for p in PLANS], ids=[p[0] for p in PLANS])
def test_port_fused_linear_plan(m, k, n, x_dtype, w_nk, aligned, want):
    """The path is a pure function of shapes, dtypes, layout and alignment;
    a stream plan with splits is a cooperative launch, so its blocks must
    fit the card's SMs (one each)."""
    got = fl.plan(m, n, k, x_dtype, torch.float32, w_nk, aligned, 132)
    assert tuple(got) == want
    if got.path == "stream":
        tiles = -(-m // fl.STREAM_TILE_M) * -(-n // fl.STREAM_TILE_N)
        assert got.splits == 1 or tiles * got.splits <= 132
        assert got.splits <= -(-k // fl.STREAM_TILE_K)


def test_port_fused_linear_weight_layout():
    """The port's Linear passes the (K, N) view of its (N, K) weight; with
    N = 1 that view is also contiguous and still reads as (N, K)."""
    w = torch.zeros(8, 3)
    assert fl.weight_layout(w) is False
    assert fl.weight_layout(torch.zeros(3, 8).t()) is True
    assert fl.weight_layout(torch.zeros(1, 8).t()) is True
    with pytest.raises(ValueError, match="w must be contiguous"):
        fl.weight_layout(torch.zeros(16, 6)[::2, ::2])


@pytest.mark.parametrize("act", ACTS)
def test_port_fused_linear_plain_matches_pallas_at_split_k_shape(act):
    """64×4096→96: the depth at which the stream path splits K (4096 / 32 =
    128 slices), against the Pallas kernel in interpret mode (eight 512-deep
    K tiles). float32 out: the same bf16 operands, only the order of the
    float32 sums differs (rtol 1e-5, atol 1e-4 as above)."""
    x, w, b = _inputs(64, 4096, 96, seed=4)
    want = jax_fused_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            activation=act, out_dtype=jnp.float32,
                            interpret=True)
    got = fl.fused_linear(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), act, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL["float32"])


def test_port_fused_linear_no_grad_call_matches_autograd_call():
    """A call that needs no gradient skips the autograd Function; its value
    is the Function's."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(32, 64, 24, seed=5))
    plain = fl.fused_linear(x, w, b, "leaky_relu", torch.bfloat16)
    graded = fl.fused_linear(x, w.clone().requires_grad_(), b,
                             "leaky_relu", torch.bfloat16)
    assert plain.grad_fn is None and graded.grad_fn is not None
    assert torch.equal(plain, graded.detach())


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::fused_linear_stream_kernel<__nv_bfloat16>"
    "(CUtensorMap_st, CUtensorMap_st, float const*, __nv_bfloat16*, float*, "
    "int*, int, int, int, int)",
    "void (anonymous namespace)::fused_linear_dot_kernel<float, float, "
    "__nv_bfloat16>(float const*, float const*, float const*, "
    "__nv_bfloat16*, int, int, int, int)",
    "void (anonymous namespace)::fused_linear_generic_kernel<__nv_bfloat16, "
    "float, __nv_bfloat16, true>(__nv_bfloat16 const*, float const*, "
    "float const*, __nv_bfloat16*, int, int, int, int)",
])
def test_port_profile_step_puts_every_fused_linear_kernel_in_its_category(
        name):
    assert categorize(name) == "fused_linear"


# the full-width step's shapes (M, K, N, activation, x dtype)
MAIN_PATH = [(256, 16384, 2048, "none", BF16),
             (256, 16384, 2048, "leaky_relu", BF16),
             (256, 128, 16384, "none", BF16), (256, 2048, 128, "none", BF16),
             (256, 2048, 1, "none", F32), (1000, 128, 16384, "none", BF16)]


@pytest.mark.cuda
def test_port_fused_linear_kernel_matches_plain_on_cuda():
    """Runs only where a GPU is (python -m pytest -m cuda): the CUDA kernel
    against the plain version at a ragged shape, both weight layouts, and at
    the main path's shapes, where two launches must also give identical
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; run with -m cuda on the GPU machine")
    x, w, b = (torch.from_numpy(a).cuda() for a in _inputs(100, 300, 70))
    for w_kn in (w, w.t().contiguous().t()):
        for act in ACTS:
            for out in (torch.float32, torch.bfloat16):
                got = fl.fused_linear(x, w_kn, b, act, out)
                want = fl.fused_linear_plain(x, w_kn, b, act, out)
                torch.cuda.synchronize()
                np.testing.assert_allclose(
                    got.float().cpu().numpy(), want.float().cpu().numpy(),
                    **TOL["float32" if out == torch.float32 else "bfloat16"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n, act, x_dtype in MAIN_PATH:
        x = torch.randn(m, k, device="cuda", generator=gen).to(x_dtype)
        w = torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5
        b = torch.randn(n, device="cuda", generator=gen) * 0.1
        got = fl.fused_linear(x, w.t(), b, act, torch.bfloat16)
        again = fl.fused_linear(x, w.t(), b, act, torch.bfloat16)
        want = fl.fused_linear_plain(x, w.t(), b, act, torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(got, again), (m, k, n)
        # one bf16 rounding of the output apart, relative to its largest
        # magnitude (chip_smoke.py's TOL_FWD)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 8e-3 * want.float().abs().max().item(), (m, k, n, err)
