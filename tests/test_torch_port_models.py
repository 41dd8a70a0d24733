"""Layers, losses, models and the parameter bridge of the PyTorch port
(disentangle_mlp_tpu_torch) against the JAX package's flax modules and loss
functions, at toy widths on the CPU. Both sides start from one init: the
flax parameters are loaded into the port's modules with utils/params.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disentangle_mlp_tpu.models import gan as jgan
from disentangle_mlp_tpu.models import layers as jl
from disentangle_mlp_tpu.models import vae as jvae
from disentangle_mlp_tpu.ops import losses as jlosses
from disentangle_mlp_tpu_torch.models import gan as tgan
from disentangle_mlp_tpu_torch.models import layers as tl
from disentangle_mlp_tpu_torch.models import vae as tvae
from disentangle_mlp_tpu_torch.ops import losses as tlosses
from disentangle_mlp_tpu_torch.utils.params import (from_jax, to_jax,
                                                    to_numpy_tree)
from tests.test_torch_compat import (DEC_CH, DISC_CH, FEAT_DIM, HEAD, IMG,
                                     N_HIDDEN, N_Z, RS)

LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _x(shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _nchw(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _flax_init(module, x, **kw):
    v = module.init(jax.random.key(0), jnp.asarray(x), **kw)
    return (to_numpy_tree(v["params"]),
            to_numpy_tree(v.get("batch_stats", {})))


def _perturb(tree, seed):
    """Non-trivial values for every leaf (BN scale 1 / bias 0 / running
    stats 0 and 1 at init would hide layout mistakes)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return (t + rng.normal(size=t.shape) * 0.1).astype(np.float32)
    return walk(tree)


def _positive_vars(stats):
    if isinstance(stats, dict):
        return {k: (np.abs(v) + 0.5 if k == "var" else _positive_vars(v))
                for k, v in stats.items()}
    return stats


def _models():
    enc = (jvae.CelebaEncoder(n_hidden=N_HIDDEN, representation_size=RS,
                              head_width=HEAD),
           tvae.CelebaEncoder(n_hidden=N_HIDDEN, representation_size=RS,
                              head_width=HEAD, img_size=IMG))
    dec = (jvae.CelebaDecoder(n_hidden=N_HIDDEN, n_z=N_Z, channels=DEC_CH),
           tvae.CelebaDecoder(n_hidden=N_HIDDEN, n_z=N_Z, channels=DEC_CH))
    disc = (jgan.DiscriminatorCeleba(n_z=N_Z, channels=DISC_CH,
                                     feature_dim=FEAT_DIM),
            tgan.DiscriminatorCeleba(channels=DISC_CH, feature_dim=FEAT_DIM,
                                     img_size=IMG))
    return {"encoder": enc, "decoder": dec, "discriminator": disc}


def _model_input(name, batch=4, seed=0):
    if name == "decoder":
        return np.random.default_rng(seed).normal(
            size=(batch, N_HIDDEN)).astype(np.float32)
    return _x((batch, IMG, IMG, 3), seed)


def _bridged(name, seed=5):
    jmod, tmod = _models()[name]
    x = _model_input(name)
    p, s = _flax_init(jmod, x)
    p, s = _perturb(p, seed), _positive_vars(_perturb(s, seed + 1))
    from_jax(tmod, p, s)
    return jmod, tmod, p, s


# ---------------------------------------------------------------- bridge --

def _assert_trees_equal(a, b, path=""):
    assert isinstance(b, dict) == isinstance(a, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("name", ["encoder", "decoder", "discriminator"])
def test_port_params_bridge_roundtrip_is_exact(name):
    _, tmod, p, s = _bridged(name)
    p2, s2 = to_jax(tmod)
    _assert_trees_equal(p, p2)
    _assert_trees_equal(s, s2)
    # and the other way: the port's own init through JAX layout and back
    other = _models()[name][1]
    from_jax(other, *to_jax(tmod))
    for (k, a), (_, b) in zip(tmod.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k


def test_port_params_bridge_rejects_missing_leaves():
    _, tmod, p, s = _bridged("discriminator")
    del p["sigmoid_output"]
    with pytest.raises(ValueError, match="not written"):
        from_jax(tmod, p, s)


# ---------------------------------------------------------------- layers --

LAYER_CASES = {
    "conv_s2": (lambda: jl.TorchConv(6, 5, stride=2, padding=2),
                lambda: tl.Conv(3, 6, 5, stride=2, padding=2)),
    "conv_s1": (lambda: jl.TorchConv(5, 5, stride=1, padding=2),
                lambda: tl.Conv(3, 5, 5, stride=1, padding=2)),
    "convT_s2": (lambda: jl.TorchConvTranspose(4, 5, stride=2, padding=2,
                                               output_padding=1),
                 lambda: tl.ConvTranspose(3, 4, 5, stride=2, padding=2,
                                          output_padding=1)),
    "convT_s1": (lambda: jl.TorchConvTranspose(4, 5, stride=1, padding=2,
                                               output_padding=0),
                 lambda: tl.ConvTranspose(3, 4, 5, stride=1, padding=2,
                                          output_padding=0)),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_port_conv_layers_match_flax(case):
    make_j, make_t = LAYER_CASES[case]
    jmod, tmod = make_j(), make_t()
    x = _x((2, 8, 8, 3), seed=1)
    p, _ = _flax_init(jmod, x)
    p = _perturb(p, 2)
    from_jax(tmod, p)
    want = np.asarray(jmod.apply({"params": p}, jnp.asarray(x)))
    got = tmod(_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **LAYER_TOL)


def test_port_linear_matches_flax():
    jmod, tmod = jl.TorchLinear(7), tl.Linear(12, 7)
    x = _x((5, 12), seed=3)
    p, _ = _flax_init(jmod, x)
    from_jax(tmod, p)
    want = np.asarray(jmod.apply({"params": p}, jnp.asarray(x)))
    np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(),
                               want, **LAYER_TOL)
    lrelu = tmod(torch.from_numpy(x), activation="leaky_relu")
    np.testing.assert_allclose(
        lrelu.detach().numpy(),
        np.asarray(jax.nn.leaky_relu(jnp.asarray(want), 0.2)), **LAYER_TOL)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("rank", [2, 4])
def test_port_batchnorm_matches_flax(rank, groups):
    """Train mode (batch statistics, running-stat update with Bessel's
    correction, group 0 only when grouped) and eval mode (running stats)."""
    c = 6
    shape = (4, c) if rank == 2 else (4, 3, 5, c)  # NHWC on the JAX side
    x = _x(shape, seed=4, lo=-2.0, hi=3.0)
    jmod = jl.BatchNorm(groups=groups)
    tmod = tl.BatchNorm(c, groups=groups)
    p, s = _flax_init(jmod, x)
    p, s = _perturb(p, 5), _positive_vars(_perturb(s, 6))
    from_jax(tmod, p, s)
    xt = torch.from_numpy(x) if rank == 2 else _nchw(x)

    def back(y):
        return (y if rank == 2 else y.permute(0, 2, 3, 1)).detach().numpy()

    want, mut = jmod.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                           use_running_average=False,
                           mutable=["batch_stats"])
    np.testing.assert_allclose(back(tmod(xt, train=True)), np.asarray(want),
                               **LAYER_TOL)
    new = to_numpy_tree(mut["batch_stats"])["bn"]
    np.testing.assert_allclose(tmod.running_mean.numpy(), new["mean"],
                               **LAYER_TOL)
    np.testing.assert_allclose(tmod.running_var.numpy(), new["var"],
                               **LAYER_TOL)
    want_eval = jmod.apply({"params": p, "batch_stats": mut["batch_stats"]},
                           jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(back(tmod(xt, train=False)),
                               np.asarray(want_eval), **LAYER_TOL)


# jax.nn.leaky_relu's formula, unjitted: a jit would compile once a shape
JAX_ACTIVATIONS = {"none": lambda h: h, "relu": jax.nn.relu,
                   "leaky_relu": lambda h: jnp.where(h >= 0, h, 0.2 * h)}
# bf16: the port computes in float32 and rounds y and dx once, so it is held
# against flax's float32 vjp on the same bf16 inputs: one rounding (2^-9 of
# the value) apart, plus float32's differences where the terms cancel.
# (flax's own bf16 module rounds x·inv and the shift one at a time: with two
# rows a group its output is 5 % of the largest value away from either.)
BF16_ROUNDING = 2.0 ** -8


@pytest.mark.parametrize("activation", sorted(JAX_ACTIVATIONS))
@pytest.mark.parametrize("mode", ["train", "groups2", "eval"])
@pytest.mark.parametrize("rank", [2, 4])
def test_port_batchnorm_activation_vjp_matches_flax(rank, mode, activation):
    """The port's BatchNorm with its fused activation, float32 and bf16,
    against ``jax.vjp`` of flax's float32 BatchNorm followed by the
    activation, on the same inputs (rounded to bf16, which both dtypes
    hold exactly): the output, dx, dγ and dβ for one cotangent, and the
    running statistics. The port's backward is its explicit formula
    (ops/batchnorm.py), flax's the autodiff of its E[x²]−E[x]² graph."""
    c, groups, train = 6, 2 if mode == "groups2" else 1, mode != "eval"
    shape = (4, c) if rank == 2 else (4, 3, 5, c)  # NHWC on the JAX side

    def bf16(a):
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                          .astype(jnp.float32))

    x, dy = bf16(_x(shape, seed=21, lo=-2.0, hi=3.0)), bf16(_x(shape, 22))
    jmod = jl.BatchNorm(groups=groups)
    p, s = _flax_init(jmod, x)
    p, s = _perturb(p, 23), _positive_vars(_perturb(s, 24))

    def f(xv, params):
        y, mut = jmod.apply({"params": params, "batch_stats": s}, xv,
                            use_running_average=not train,
                            mutable=["batch_stats"])
        return JAX_ACTIVATIONS[activation](y), mut

    y, vjp, mut = jax.vjp(f, jnp.asarray(x), p, has_aux=True)
    jdx, jdp = vjp(jnp.asarray(dy))
    new = to_numpy_tree(mut["batch_stats"])["bn"]
    for tdt in (torch.float32, torch.bfloat16):
        def nchw(a):
            t = torch.from_numpy(a.copy())
            return (t if rank == 2 else t.permute(0, 3, 1, 2)).to(tdt)

        def back(t):
            t = t if rank == 2 else t.permute(0, 2, 3, 1)
            return t.detach().float().numpy()

        tmod = tl.BatchNorm(c, groups=groups, dtype=tdt)
        from_jax(tmod, p, s)
        xt = nchw(x).detach().requires_grad_()
        yt = tmod(xt, train=train, activation=activation)
        assert yt.dtype == tdt
        yt.backward(nchw(dy))
        pairs = [("y", back(yt), y), ("dx", back(xt.grad), jdx),
                 ("dscale", tmod.weight.grad.numpy(), jdp["bn"]["scale"]),
                 ("dbias", tmod.bias.grad.numpy(), jdp["bn"]["bias"]),
                 ("mean", tmod.running_mean.numpy(), new["mean"]),
                 ("var", tmod.running_var.numpy(), new["var"])]
        for name, got, want in pairs:
            want = np.asarray(want, np.float32)
            rounded = tdt == torch.bfloat16 and name in ("y", "dx")
            np.testing.assert_allclose(
                got, want, rtol=BF16_ROUNDING if rounded else 1e-4,
                atol=1e-5 * max(1.0, np.abs(want).max()),
                err_msg=f"{name} {tdt}")


# ---------------------------------------------------------------- losses --

# no p of exactly 0.5: there JAX's min/max split the gradient of a tie in
# half (the log1p / log(1-p) branch point), torch's clamp does not
PROBS = np.array([0.0, 1e-30, 1e-8, 0.2, 0.45, 0.7, 1 - 1e-7, 1.0],
                 np.float32)
TARGETS = np.array([0.9, 0.1, 1.0, 0.0, 0.9, 0.1, 0.9, 0.1], np.float32)
LOGITS = np.array([-100.0, -30.0, -3.0, -0.25, 0.5, 4.0, 30.0, 100.0],
                  np.float32)


def _value_and_grad_pair(jfn, tfn, *args):
    """(value, grads w.r.t. every arg) from the JAX and the port function."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, ts)
    return (float(jv), [np.asarray(g) for g in jg],
            tv.item(), [g.numpy() for g in tg])


LOSS_CASES = {
    "bce_probs": (lambda p: jlosses.bce(p, TARGETS),
                  lambda p: tlosses.bce(p, torch.from_numpy(TARGETS)),
                  (PROBS,)),
    "bce_logits": (lambda l: jlosses.bce_logits(l, TARGETS),
                   lambda l: tlosses.bce_logits(l, torch.from_numpy(TARGETS)),
                   (LOGITS,)),
    "bce_logits_scalar_target": (lambda l: jlosses.bce_logits(l, 0.9),
                                 lambda l: tlosses.bce_logits(l, 0.9),
                                 (LOGITS,)),
    "kld": (jlosses.kld, tlosses.kld,
            (_x((3, 5), 7), _x((3, 5), 8, -3.0, 2.0))),
    "sim_loss": (jlosses.sim_loss, tlosses.sim_loss,
                 (_x((3, 6), 9), _x((3, 6), 10))),
    "reconstruction_loss": (jlosses.reconstruction_loss,
                            tlosses.reconstruction_loss,
                            (_x((2, 4, 4, 3), 11), _x((2, 4, 4, 3), 12))),
    "vae_loss": (jlosses.vae_loss, tlosses.vae_loss,
                 (_x((2, 4, 4, 3), 13), _x((2, 4, 4, 3), 14), _x((2, 5), 15),
                  _x((2, 5), 16, -3.0, 2.0))),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_port_losses_match_jax(case):
    """Values and gradients, including p ∈ {0, 1} (the −100 clamp, finite
    zero gradient) and saturated logits."""
    jfn, tfn, args = LOSS_CASES[case]
    jv, jg, tv, tg = _value_and_grad_pair(jfn, tfn, *args)
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    for a, b in zip(tg, jg):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------- models --

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["encoder", "decoder", "discriminator"])
def test_port_models_forward_match_flax_f32(name, train):
    jmod, tmod, p, s = _bridged(name)
    x = _model_input(name, seed=13)
    xt = torch.from_numpy(x)
    out = jmod.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                     train=train, mutable=["batch_stats"])[0]
    got = tmod(xt, train=train)
    want = out if isinstance(out, tuple) else (out,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **MODEL_TOL)


def test_port_encoder_forward_ref_with_injected_eps():
    jmod, tmod, p, s = _bridged("encoder")
    x = _model_input("encoder", seed=14)
    eps = np.random.default_rng(15).normal(size=(4, N_HIDDEN)).astype(
        np.float32)
    (z, kld), _ = jmod.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                             train=True, eps=jnp.asarray(eps),
                             method=jvae.CelebaEncoder.forward_ref,
                             mutable=["batch_stats"])
    zt, kt = tmod.forward_ref(torch.from_numpy(x), train=True,
                              eps=torch.from_numpy(eps))
    assert kt.shape == (4,)
    np.testing.assert_allclose(zt.detach().numpy(), np.asarray(z),
                               **MODEL_TOL)
    np.testing.assert_allclose(kt.detach().numpy(), np.asarray(kld),
                               rtol=1e-4, atol=1e-3)


def test_port_discriminator_logits_and_bf16_forward():
    """return_logits, and one bf16 forward (Linear through fused_linear's
    plain version on the CPU) within 5e-2 of the flax bf16 forward."""
    jmod, tmod, p, s = _bridged("discriminator")
    x = _model_input("discriminator", seed=16)
    (logit, _), _ = jmod.apply({"params": p, "batch_stats": s},
                               jnp.asarray(x), train=True,
                               return_logits=True, mutable=["batch_stats"])
    lt, _ = tmod(torch.from_numpy(x), train=True, return_logits=True)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(logit),
                               **MODEL_TOL)

    j16 = jgan.DiscriminatorCeleba(n_z=N_Z, channels=DISC_CH,
                                   feature_dim=FEAT_DIM, dtype=jnp.bfloat16)
    t16 = tgan.DiscriminatorCeleba(channels=DISC_CH, feature_dim=FEAT_DIM,
                                   img_size=IMG, dtype=torch.bfloat16)
    from_jax(t16, p, s)
    (prob, feat), _ = j16.apply({"params": p, "batch_stats": s},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    pt, ft = t16(torch.from_numpy(x), train=True)
    assert ft.dtype == torch.float32 and pt.dtype == torch.float32
    for got, want in ((pt, prob), (ft, feat)):
        want = np.asarray(want, np.float32)
        err = np.abs(got.detach().numpy() - want).max()
        assert err <= 5e-2 * np.abs(want).max(), err


def test_port_vae_bf16_forward_near_flax():
    """The full VAE forward in bf16 (encoder heads and decoder preprocess
    through fused_linear's plain version) within 5e-2 of flax's."""
    kw = dict(n_hidden=N_HIDDEN, n_z=N_Z, representation_size=RS,
              head_width=HEAD, decoder_channels=DEC_CH)
    x = _model_input("encoder", seed=17)
    j32 = jvae.VAE(**kw)
    v = j32.init({"params": jax.random.key(1), "reparam": jax.random.key(2)},
                 jnp.asarray(x))
    p, s = to_numpy_tree(v["params"]), to_numpy_tree(v["batch_stats"])
    eps = np.random.default_rng(18).normal(size=(4, N_HIDDEN)).astype(
        np.float32)
    j16 = jvae.VAE(**kw, dtype=jnp.bfloat16)
    t16 = tvae.VAE(**kw, img_size=IMG, dtype=torch.bfloat16)
    from_jax(t16, p, s)
    mu, lv = j16.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                       train=True, method=jvae.VAE.encode,
                       mutable=["batch_stats"])[0]
    z = mu + jnp.asarray(eps) * jnp.exp(0.5 * lv)
    rec = j16.apply({"params": p, "batch_stats": s}, z, train=True,
                    method=jvae.VAE.decode, mutable=["batch_stats"])[0]
    rt, mt, lt = t16(torch.from_numpy(x), train=True,
                     eps=torch.from_numpy(eps))
    assert rt.dtype == torch.bfloat16 and mt.dtype == torch.float32
    for got, want in ((rt, rec), (mt, mu), (lt, lv)):
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().detach().numpy() - want).max()
        assert err <= 5e-2 * np.abs(want).max(), err
