"""The port's birds and MNIST families (disentangle_mlp_tpu_torch:
models/resnet.py, models/birds.py, models/mnist.py, train/families.py and
the flax-tree bridge of utils/params.py) against the JAX package's, on the
CPU in float32 unless stated:

- forward and updated running statistics of every family module, from the
  JAX module's initial tree bridged into the port: within 1e-5 of the
  largest magnitude (FWD_RTOL; both frameworks compute the same float32
  sums in other orders);
- the ResNet-18 torchvision state-dict loader against the JAX package's
  converter;
- 3 MNIST steps and 2 birds steps with the JAX step's draws injected
  (labels from the first of the step key's 3 splits, z_prior and ε captured
  from the eager JAX step), with tests/test_torch_port_vaegan.py's
  tolerances for a step that updates every parameter (TOL["observed"]):
  Adam's g/(|g| + ε) turns float-level gradient differences near g = 0 into
  ±lr updates, and a conv bias that feeds a BatchNorm has no true gradient
  and random-walks on rounding noise (CANCELLED_ATOL);
- the bf16 policy's output dtypes;
- checkpoints both ways, float32 and bfloat16 moments, exactly.
"""

import functools

import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from disentangle_mlp_tpu.config import Config as JaxConfig
from disentangle_mlp_tpu.models import birds as jax_birds
from disentangle_mlp_tpu.models import mnist as jax_mnist
from disentangle_mlp_tpu.models import resnet as jax_resnet
from disentangle_mlp_tpu.train.families import create_family_experiment
from disentangle_mlp_tpu.utils import checkpoint as jax_ckpt
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.models import birds, mnist, resnet
from disentangle_mlp_tpu_torch.train import loop
from disentangle_mlp_tpu_torch.train.families import FamilyExperiment
from disentangle_mlp_tpu_torch.utils import checkpoint as port_ckpt
from disentangle_mlp_tpu_torch.utils.params import (from_jax, to_jax,
                                                    to_numpy_tree)
from tests.test_resnet_torch_load import make_torch_state_dict
from tests.test_torch_port_checkpoint import (_assert_states_equal,
                                              _random_like, _to_torch)
from tests.test_torch_trajectory import (CANCELLED_ATOL, STATS_ATOL, TOL,
                                         _labels_for)

FWD_RTOL = 1e-5
LR = 1e-3
BETA = 1.0
# (dataset, batch, image size, channels, steps)
FAMILIES = {"mnist": (4, 28, 1, 3), "birds": (2, 128, 3, 2)}
N_HIDDEN = 8  # the birds latent; the ResNet, G and D keep their widths


def _close(got, want, what, rtol=FWD_RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |d| {err:.3e}, scale {scale:.3e}"


def _trees_close(got, want, what, rtol=FWD_RTOL):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _trees_close(got[k], want[k], f"{what}/{k}", rtol)
    else:
        _close(got, want, what, rtol)


def _images(shape, seed, lo=-1.0, hi=1.0):
    """Distinct positive values after each ReLU: no max-pool ties at
    positive values (ties at 0 pass a zero gradient in both)."""
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def with_draws(fn, shape):
    """``fn`` jitted, also returning the jax.random.normal draws of
    ``shape`` it makes, in call order (flax traces the initializers of
    existing parameters too, which draw at their kernels' shapes)."""
    def run(*args):
        real, draws = jax.random.normal, []

        def recording(key, shp=(), dtype=jnp.float32):
            out = real(key, shp, dtype)
            if tuple(shp) == tuple(shape):
                draws.append(out)
            return out

        jax.random.normal = recording
        try:
            return fn(*args), draws
        finally:
            jax.random.normal = real
    return jax.jit(run)


def _jax_apply(module, variables, *args, rngs=None, draw_shape=None, **kw):
    """module.apply in train mode with mutable stats, jitted; returns (out,
    the updated batch_stats as numpy, the normals of ``draw_shape`` the
    call drew)."""
    def call(*a):
        return module.apply(variables, *a, rngs=rngs,
                            mutable=["batch_stats"], **kw)
    (out, mut), draws = with_draws(call, draw_shape or ())(*args)
    return out, to_numpy_tree(mut.get("batch_stats", {})), \
        [np.array(d) for d in draws]


def _init(module, rngs, *args):
    return jax.jit(module.init)(rngs, *args)


def _bridge(port_module, variables):
    from_jax(port_module, to_numpy_tree(variables["params"]),
             to_numpy_tree(variables.get("batch_stats", {})))
    return port_module


# ------------------------------------------------------------- forwards --

def test_port_resnet18_features_forward_and_statistics_match_jax():
    x = _images((2, 64, 64, 3), 0)
    jm = jax_resnet.ResNet18Features()
    v = _init(jm, jax.random.key(0), jnp.asarray(x))
    feats, stats, _ = _jax_apply(jm, v, jnp.asarray(x))
    port = _bridge(resnet.ResNet18Features(), v)
    got = port(torch.from_numpy(x), train=True)
    _close(got.detach().numpy(), feats, "features")
    _trees_close(to_jax(port)[1], stats, "running statistics")
    # eval mode reads the running statistics just written
    want = jax.jit(jm.apply, static_argnames="train")(
        {"params": v["params"], "batch_stats": stats}, jnp.asarray(x),
        train=False)
    _close(port(torch.from_numpy(x), train=False).detach().numpy(), want,
           "eval-mode features")


def test_port_resnet18_torchvision_state_dict_matches_jax_loader(tmp_path):
    """The port's loader of a torchvision state dict gives the features of
    the JAX package's converter bridged into the port; fc.* is dropped and
    a missing file gives None."""
    sd = make_torch_state_dict(seed=3)
    x = torch.from_numpy(_images((2, 64, 64, 3), 1))
    port = resnet.ResNet18Features()
    resnet.load_torch_state_dict(port, {k: torch.from_numpy(v)
                                        for k, v in sd.items()})
    ref = _bridge(resnet.ResNet18Features(),
                  jax_resnet.load_torch_state_dict(sd))
    with torch.no_grad():
        _close(port(x, train=False).numpy(), ref(x, train=False).numpy(),
               "features")
    path = tmp_path / "resnet18.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    again = resnet.load_torch_checkpoint(resnet.ResNet18Features(),
                                         str(path))
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(),
                                                 port.state_dict().values()))
    assert resnet.load_torch_checkpoint(resnet.ResNet18Features(),
                                        str(tmp_path / "none.pth")) is None


def _family_modules(name):
    """(JAX encoder, generator, discriminator, port counterparts, batch
    shape, latent size) of one family, float32."""
    if name == "birds":
        return (jax_birds.BirdsEncoder(n_z=N_HIDDEN),
                jax_birds.BirdsGenerator(n_z=N_HIDDEN),
                jax_birds.BirdsDiscriminator(),
                birds.BirdsEncoder(N_HIDDEN), birds.BirdsGenerator(N_HIDDEN),
                birds.BirdsDiscriminator(), (2, 128, 128, 3), N_HIDDEN)
    return (jax_mnist.MnistEncoder(), jax_mnist.MnistGenerator(),
            jax_mnist.MnistDiscriminator(), mnist.MnistEncoder(1),
            mnist.MnistGenerator(7, 1), mnist.MnistDiscriminator(1, 28),
            (4, 28, 28, 1), 7 * 7 * 4)


@pytest.mark.parametrize("name", ["mnist", "birds"])
def test_port_family_modules_forward_and_statistics_match_jax(name):
    """E (z and KLD with the JAX draw of ε), G and D (probability, logit
    and features), each with its updated running statistics."""
    je, jg, jd, pe, pg, pd, shape, z_dim = _family_modules(name)
    x = _images(shape, 2, *((0.0, 1.0) if name == "mnist" else (-1, 1)))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ve = _init(je, {"params": jax.random.key(1),
                    "reparam": jax.random.key(2)}, xj)
    (z, kld), stats, draws = _jax_apply(je, ve, xj,
                                        rngs={"reparam": jax.random.key(3)},
                                        draw_shape=(shape[0], z_dim))
    _bridge(pe, ve)
    got_z, got_kld = pe(xt, torch.from_numpy(draws[0]))
    _close(got_z.detach().numpy(), z, "encoder z")
    _close(got_kld.detach().numpy(), kld, "encoder KLD")
    _trees_close(to_jax(pe)[1], stats, "encoder statistics")

    zin = _images((shape[0], z_dim), 4)
    zj = jnp.asarray(zin)
    if name == "mnist":  # the JAX generator takes the (H, W, C) map
        zj = zj.reshape(shape[0], 7, 7, 4)
    vg = _init(jg, jax.random.key(5), zj)
    img, stats, _ = _jax_apply(jg, vg, zj)
    _bridge(pg, vg)
    got = pg(torch.from_numpy(zin))
    _close(got.detach().numpy(), img, "generator")
    if stats:
        _trees_close(to_jax(pg)[1], stats, "generator statistics")

    vd = _init(jd, jax.random.key(6), xj)
    (prob, feats), stats, _ = _jax_apply(jd, vd, xj)
    (logit, _), _, _ = _jax_apply(jd, vd, xj, return_logits=True)
    _bridge(pd, vd)
    got_p, got_f = pd(xt)
    _close(got_p.detach().numpy(), prob, "discriminator probability")
    _close(got_f.detach().numpy(), feats, "discriminator features")
    _trees_close(to_jax(pd)[1], stats, "discriminator statistics")
    _close(pd(xt, return_logits=True)[0].detach().numpy(), logit,
           "discriminator logit")


def test_port_birds_bf16_policy_output_dtypes_match_jax():
    je, jg, jd = (jax_birds.BirdsEncoder(n_z=N_HIDDEN, dtype=jnp.bfloat16),
                  jax_birds.BirdsGenerator(n_z=N_HIDDEN, dtype=jnp.bfloat16),
                  jax_birds.BirdsDiscriminator(dtype=jnp.bfloat16))
    bf = torch.bfloat16
    pe, pg, pd = (birds.BirdsEncoder(N_HIDDEN, bf),
                  birds.BirdsGenerator(N_HIDDEN, bf),
                  birds.BirdsDiscriminator(3, bf))
    x = jnp.zeros((2, 128, 128, 3), jnp.float32)
    z = jnp.zeros((2, N_HIDDEN), jnp.float32)
    want = [jax.eval_shape(lambda: m.init_with_output(r, a)[0])
            for m, r, a in ((je, {"params": jax.random.key(0),
                                  "reparam": jax.random.key(1)}, x),
                            (jg, jax.random.key(2), z),
                            (jd, jax.random.key(3), x))]
    with torch.no_grad():
        got = [pe(torch.zeros(2, 128, 128, 3), torch.zeros(2, N_HIDDEN)),
               pg(torch.zeros(2, N_HIDDEN)), pd(torch.zeros(2, 128, 128, 3))]
    for what, g, w in zip(("encoder", "generator", "discriminator"), got,
                          want):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        assert [str(t.dtype).replace("torch.", "") for t in g] == \
            [np.dtype(a.dtype).name for a in w], what
        assert [tuple(t.shape) for t in g] == [a.shape for a in w], what


# -------------------------------------------------------- trajectories --

def _kwargs(name, **kw):
    batch, img, ch, _ = FAMILIES[name]
    return dict(name=f"fam_{name}", dataset=name, img_size=img,
                input_channels=ch, n_hidden=N_HIDDEN, batch_size_train=batch,
                dtype="float32", lr=LR, beta=BETA, **kw)


def _batch(name):
    batch, img, ch, _ = FAMILIES[name]
    x = _images((batch, img, img, ch), 7, 0.0, 1.0)
    if name == "mnist":  # MNIST's Normalize, as the idx loader feeds it
        x = (x - 0.1307) / 0.3081
    return x.astype(np.float32)


def _cancelled(name):
    """MNIST's conv biases feed BatchNorms: no true gradient."""
    return lambda path: name == "mnist" and "Conv_" in path \
        and path.endswith("bias")


def _assert_tree_close(port_tree, jax_tree, atol, what, cancelled):
    if isinstance(jax_tree, dict) or hasattr(jax_tree, "items"):
        assert set(port_tree) == set(jax_tree), what
        for k in jax_tree:
            _assert_tree_close(port_tree[k], jax_tree[k], atol,
                               f"{what}/{k}", cancelled)
        return
    np.testing.assert_allclose(
        np.asarray(port_tree), np.asarray(jax_tree), rtol=1e-3,
        atol=CANCELLED_ATOL if cancelled(what) else atol, err_msg=what)


@functools.lru_cache(maxsize=None)
def _jax_experiment(name):
    return create_family_experiment(JaxConfig(**_kwargs(name)),
                                    jax.random.key(0))


@pytest.mark.parametrize("name", ["mnist", "birds"])
def test_port_family_step_trajectory_matches_jax(name):
    """Every step's metrics, and after the last step the parameter and
    running-statistic trees of EG and D. The JAX step is the experiment's
    own train_step function, jitted here with its z_prior and ε draws
    returned."""
    kw = _kwargs(name)
    jexp = _jax_experiment(name)
    eg, d = jexp.eg_state, jexp.d_state
    port = FamilyExperiment(Config(**kw), "cpu")
    step_fn = with_draws(jexp.train_step.__wrapped__,
                         (FAMILIES[name][0], port.z_dim))
    from_jax(port.vae, to_numpy_tree(eg.params),
             to_numpy_tree(eg.batch_stats))
    from_jax(port.discriminator, to_numpy_tree(d.params),
             to_numpy_tree(d.batch_stats))
    x = _batch(name)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    tol = TOL["observed"]
    for step in range(FAMILIES[name][3]):
        rng = jax.random.fold_in(jax.random.key(11), step)
        real_l, fake_l = _labels_for(rng, 3)
        (eg, d, m), draws = step_fn(eg, d, xj, rng)
        z_prior, eps = (np.array(a) for a in draws)
        assert z_prior.shape == eps.shape == (x.shape[0], port.z_dim)
        ours = port.train_step(xt, draws={
            "labels": {"real": real_l, "fake": fake_l}, "z_prior": z_prior,
            "eps": eps})
        for key in ("loss", "errD", "recon", "D_x"):
            np.testing.assert_allclose(
                ours[key].item(), float(m[key]), rtol=tol["metric_rtol"],
                err_msg=f"{name} step {step} {key}")
    for what, module, state in (("EG", port.vae, eg),
                                ("D", port.discriminator, d)):
        params, stats = to_jax(module)
        _assert_tree_close(params, to_numpy_tree(state.params),
                           tol["param_atol"], f"{name} {what} params",
                           _cancelled(name))
        _assert_tree_close(stats, to_numpy_tree(state.batch_stats),
                           STATS_ATOL, f"{name} {what} statistics",
                           lambda path: False)
    assert port.opt_eg.count == port.opt_d.count == FAMILIES[name][3]


def test_port_family_decode_keeps_running_statistics():
    """decode() samples in train mode and puts G's statistics back; the
    step's prior decode, outside any graph, advances them (the JAX step's
    first phase)."""
    port = FamilyExperiment(Config(**_kwargs("birds")), "cpu")
    bn = port.vae.generator.BatchNorm_0
    before = bn.running_mean.clone()
    out = port.decode(torch.randn(3, port.z_dim))
    assert out.shape == (3, 128, 128, 3)
    assert torch.equal(bn.running_mean, before)
    with torch.no_grad():
        port.vae.decode(torch.randn(3, port.z_dim))
    assert not torch.equal(bn.running_mean, before)


@pytest.mark.parametrize("kw, match", [
    ({"dataset": "birds", "img_size": 64}, "--img_size 128"),
    ({"dataset": "mnist", "img_size": 30}, "divisible by 4"),
])
def test_port_family_refusals_match_jax(kw, match):
    for make, cfg in ((create_family_experiment, JaxConfig),
                      (FamilyExperiment, Config)):
        with pytest.raises(ValueError, match=match):
            make(cfg(**dict(_kwargs("mnist"), **kw)),
                 jax.random.key(0) if make is create_family_experiment
                 else "cpu")


def test_port_real_mnist_needs_one_channel(tmp_path):
    from tests.test_torch_port_data import _mnist_files

    _mnist_files(tmp_path, 8)
    cfg = Config(**dict(_kwargs("mnist"), input_channels=3,
                        image_root_train=str(tmp_path)))
    with pytest.raises(ValueError, match="--input_channels 1"):
        FamilyExperiment(cfg, "cpu")


# ---------------------------------------------------------- checkpoints --

def _jax_states(name):
    jexp = _jax_experiment(name)
    return {"eg": jexp.eg_state, "d": jexp.d_state}


@pytest.mark.parametrize("name, moments", [("mnist", "float32"),
                                           ("mnist", "bfloat16"),
                                           ("birds", "bfloat16")])
def test_port_family_checkpoints_both_ways_exactly(tmp_path, capsys, name,
                                                   moments):
    """A JAX family checkpoint loads into the port, and the port's save of
    other values loads into the JAX package: every parameter, statistic,
    moment and step count equal (bf16 moments cast back to float32 on
    load, as both packages do). Birds' tree, the larger, once: with bf16
    moments, which also casts."""
    template = _jax_states(name)
    path = str(tmp_path / "model_2")
    jax_ckpt.save_checkpoint(path, 2, _random_like(template, 1),
                             opt_state_dtype=None if moments == "float32"
                             else moments)
    port = FamilyExperiment(Config(**_kwargs(name)), "cpu")
    assert loop._restore(port, path) == 2
    _, want = jax_ckpt.load_checkpoint(path, template)
    _assert_states_equal(port.states(), want)
    notice = "opt_state leaves to the experiment's --optimizer_dtype"
    assert (notice in capsys.readouterr().out) == (moments == "bfloat16")

    port.load_states(_to_torch(serialization.to_state_dict(
        _random_like(template, 2))))
    path = str(tmp_path / "model_4")
    port_ckpt.save_checkpoint(path, 4, port.states(), moments)
    epoch, got = jax_ckpt.load_checkpoint(path, template)
    assert epoch == 4
    _assert_states_equal(port.states(), got,
                         moments_via=None if moments == "float32"
                         else torch.bfloat16)
