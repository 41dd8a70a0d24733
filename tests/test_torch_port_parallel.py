"""Data parallelism of the port (disentangle_mlp_tpu_torch/parallel/mesh.py
and its users) against the JAX package, on the CPU: two ranks, gloo, toy
widths (tests/test_torch_compat.py), a global batch of 8.

The JAX package runs as its own tests run it: its steps unsharded on the
whole batch (its tests/test_parallel.py shows a sharded step equals that),
from the initial state bridged into the port, with its random draws
captured and injected, each rank taking its rows. One module-scoped spawn
of two ranks (tests/torch_parallel_worker.py) runs every multi-rank case:

- (a) the β-VAE-GAN step, both freeze modes, 2 steps: every metric (per
  step, STEP_RTOL), every parameter (PARAM_ATOL) and running statistic
  (STATS_ATOL) from tests/test_torch_trajectory.py's tolerances, which it
  explains (Adam turns float-level gradient differences near g = 0 into
  ±lr updates), and every state tensor, Adam's included, bit-identical
  across the ranks;
- (b) the same with ``bn_groups=2`` against JAX ``bn_groups=2``, with
  tests/test_torch_port_vaegan.py's tolerances for grouped statistics;
- (c) the VAE, DCGAN and MNIST-family steps, one step each, TOL["observed"];
- (d) cross-replica BatchNorm (plain and grouped): output, input gradient
  and running statistics against JAX's BatchNorm on the whole batch,
  tests/test_torch_port_models.py's layer tolerance;
- (f) FID activations split over the ranks against the JAX package's
  unsharded ``get_activations`` (the case of its
  test_sharded_activations_match_unsharded), the Inception parity
  tolerance (POOL3_TOL), with and without the per-image normalize.

In this process: (e) the per-process data slicing against the JAX
loader's, (g) the trainer CLI with ``--mesh_shape 2`` against one rank,
(h) β-search groups of two CPU ranks each, two groups at once. The card
twins of (a) and (f) are in tests/test_torch_port_parallel_cuda.py, which
imports no JAX (the GPU machine has no flax).
"""

import glob
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disentangle_mlp_tpu.config import Config as JaxConfig
from disentangle_mlp_tpu.data import pipeline as jax_pipeline
from disentangle_mlp_tpu.eval import fid as jax_fid
from disentangle_mlp_tpu.models import layers as jax_layers
from disentangle_mlp_tpu.train import loop as jax_loop
from disentangle_mlp_tpu.train.families import create_family_experiment
from disentangle_mlp_tpu.train.gan import create_gan_experiment
from disentangle_mlp_tpu.train.vae import create_vae_experiment
from disentangle_mlp_tpu.train.vaegan import create_vaegan_experiment
from disentangle_mlp_tpu_torch.bo import driver
from disentangle_mlp_tpu_torch.cli import train as cli_train
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.data import pipeline
from disentangle_mlp_tpu_torch.data.selftest import hostshard_selftest
from disentangle_mlp_tpu_torch.eval.inception import init_random_params
from disentangle_mlp_tpu_torch.parallel import make_mesh, spawn
from disentangle_mlp_tpu_torch.train import loop
from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
from disentangle_mlp_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       save_checkpoint)
from disentangle_mlp_tpu_torch.utils.params import to_numpy_tree
from tests.test_torch_compat import (DEC_CH, DISC_CH, FEAT_DIM, HEAD, IMG,
                                     N_HIDDEN, N_Z, RS)
from tests.test_torch_port_bo import _base
from tests.test_torch_port_families import with_draws
from tests.test_torch_port_fid import share_inception
from tests.test_torch_port_inception import POOL3_TOL
from tests.test_torch_port_loop import TOY_FLAGS, _stats_npz
from tests.test_torch_port_models import LAYER_TOL
from tests.test_torch_port_vaegan import BN2_STEP_RTOL, BN2_TOL
from tests.test_torch_trajectory import (STATS_ATOL, TOL, _assert_tree_close,
                                         _labels_for)
from tests.torch_parallel_worker import run_cases

RANKS, BATCH, STEPS, LR, BETA = 2, 8, 2, 1e-3, 25.0
TOY = dict(n_hidden=N_HIDDEN, n_z=list(N_Z), representation_size=RS,
           head_width=HEAD, decoder_channels=list(DEC_CH),
           disc_channels=list(DISC_CH), disc_feature_dim=FEAT_DIM,
           img_size=IMG, batch_size_train=BATCH, dtype="float32", lr=LR,
           beta=BETA)
MNIST = dict(dataset="mnist", img_size=28, input_channels=1, n_hidden=8,
             batch_size_train=BATCH, dtype="float32", lr=LR, beta=1.0)
STEP_METRICS = {"vaegan": ("D_x", "sim", "kld", "recon_enc", "recon_dec",
                           "dis"),
                "vae": ("loss",),
                "gan": ("errD", "errG", "D_x", "D_G_z1", "D_G_z2"),
                "family": ("loss", "errD", "recon", "D_x")}
FID_IMAGES = {"fid": 12, "fid_norm": 13}  # 13: the last rank pads a row
# β-VAE-GAN metric rtol per step. TOL was set at a batch of 4; at this
# batch of 8 the one-device port is itself 2.4 % ('observed', the KL term)
# and 0.34 % ('intent', the similarity term) from JAX in the second step
# (this file's __main__ prints it: Adam's g/(|g| + ε) amplifies
# float-level gradient differences near g = 0, most where every phase
# updates everything), so the second step is bounded by 5e-2 and 1e-2
STEP_RTOL = {"observed": (TOL["observed"]["metric_rtol"], 5e-2),
             "intent": (TOL["intent"]["metric_rtol"], 1e-2)}
# parameters: TOL["observed"]'s 6e-3 for both modes, Adam's own bound (an
# update moves a parameter by about lr at most); at this batch the
# one-device port's parameters are 3.9e-3 from JAX in 'intent' (__main__),
# past TOL["intent"]'s 5e-4 set at a batch of 4
PARAM_ATOL = TOL["observed"]["param_atol"]
# the trainer's epoch averages and log, two ranks against one: two Adam
# steps apart by reduction order alone
CLI_RTOL = 1e-3


def _images(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _numpy(tree):
    return to_numpy_tree(tree)


def _state_init(**states):
    return {k: (_numpy(s.params), _numpy(s.batch_stats))
            for k, s in states.items()}


def _vaegan_case(name, mode, bn_groups=1, steps=STEPS):
    kw = dict(TOY, name=name, freeze_mode=mode, bn_groups=bn_groups)
    jexp = create_vaegan_experiment(JaxConfig(**kw), jax.random.key(0))
    eg, d = jexp.eg_state, jexp.d_state
    init = _state_init(eg=eg, d=d)
    x = _images((BATCH, IMG, IMG, 3), 0)
    step_fn = with_draws(lambda *a: jexp.step_with_beta(*a, BETA),
                         (BATCH, N_HIDDEN))
    draws, metrics = [], []
    for step in range(steps):
        rng = jax.random.fold_in(jax.random.key(7), step)
        real_l, fake_l = _labels_for(rng, 4)
        (eg, d, m), normals = step_fn(eg, d, jnp.asarray(x), rng)
        assert len(normals) == 3  # noise, ε of the decoder and encoder steps
        draws.append(dict(zip(("noise", "eps_dec", "eps_enc"),
                              map(np.array, normals)),
                          labels={"real": real_l, "fake": fake_l}))
        metrics.append({k: float(m[k]) for k in STEP_METRICS["vaegan"]})
    return ({"name": name, "run": "step", "kind": "vaegan", "config": kw,
             "device": "cpu", "init": init, "batch": x, "draws": draws},
            {"metrics": metrics, "trees": {"eg": (eg.params, eg.batch_stats),
                                           "d": (d.params, d.batch_stats)}})


def _vae_case():
    kw = dict(TOY, name="ddp_vae")
    jexp = create_vae_experiment(JaxConfig(**kw), jax.random.key(0))
    state = jexp.state
    init = _state_init(state=state)
    x = _images((BATCH, IMG, IMG, 3), 1)
    rng = jax.random.fold_in(jax.random.key(11), 0)
    step_fn = with_draws(jexp.step_fn, (BATCH, N_HIDDEN))
    (state, m), (eps,) = step_fn(state, jnp.asarray(x), rng)
    return ({"name": "vae", "run": "step", "kind": "vae", "config": kw,
             "device": "cpu", "init": init, "batch": x,
             "draws": [{"eps": np.array(eps)}]},
            {"metrics": [{"loss": float(m["loss"])}],
             "trees": {"state": (state.params, state.batch_stats)}})


def _gan_case():
    kw = dict(TOY, name="ddp_gan")
    jexp = create_gan_experiment(JaxConfig(**kw), jax.random.key(0))
    g, d = jexp.g_state, jexp.d_state
    init = _state_init(g=g, d=d)
    x = _images((BATCH, IMG, IMG, 3), 2)
    rng = jax.random.fold_in(jax.random.key(9), 0)
    real_l, fake_l = _labels_for(rng, 2)
    step_fn = with_draws(jexp.step_fn, (BATCH, N_HIDDEN))
    (g, d, m), (noise,) = step_fn(g, d, jnp.asarray(x), rng)
    return ({"name": "gan", "run": "step", "kind": "gan", "config": kw,
             "device": "cpu", "init": init, "batch": x,
             "draws": [{"labels": {"real": real_l, "fake": fake_l},
                        "noise": np.array(noise)}]},
            {"metrics": [{k: float(m[k]) for k in STEP_METRICS["gan"]}],
             "trees": {"g": (g.params, g.batch_stats),
                       "d": (d.params, d.batch_stats)}})


def _mnist_case():
    kw = dict(MNIST, name="ddp_mnist")
    jexp = create_family_experiment(JaxConfig(**kw), jax.random.key(0))
    eg, d = jexp.eg_state, jexp.d_state
    init = _state_init(eg=eg, d=d)
    z_dim = 7 * 7 * 4  # the 28x28 latent map, (H/4, W/4, 4) flattened
    step_fn = with_draws(jexp.train_step.__wrapped__, (BATCH, z_dim))
    x = ((_images((BATCH, 28, 28, 1), 3, 0.0, 1.0) - 0.1307) / 0.3081
         ).astype(np.float32)
    rng = jax.random.fold_in(jax.random.key(11), 0)
    real_l, fake_l = _labels_for(rng, 3)
    (eg, d, m), (z_prior, eps) = step_fn(eg, d, jnp.asarray(x), rng)
    return ({"name": "mnist", "run": "step", "kind": "family", "config": kw,
             "device": "cpu", "init": init, "batch": x,
             "draws": [{"labels": {"real": real_l, "fake": fake_l},
                        "z_prior": np.array(z_prior), "eps": np.array(eps)}]},
            {"metrics": [{k: float(m[k]) for k in STEP_METRICS["family"]}],
             "trees": {"eg": (eg.params, eg.batch_stats),
                       "d": (d.params, d.batch_stats)}})


def _bn_case(groups):
    """JAX's BatchNorm on the whole NHWC batch; the ranks get it NCHW."""
    c = 6
    x = _images((BATCH, 3, 5, c), 4, -2.0, 3.0)
    w = _images((BATCH, 3, 5, c), 5)
    jmod = jax_layers.BatchNorm(groups=groups)
    variables = jmod.init(jax.random.key(1), jnp.asarray(x),
                          use_running_average=False)
    p = jax.tree_util.tree_map(lambda a: a + 0.1, variables["params"])
    s = variables["batch_stats"]

    def loss(xj):
        y, mut = jmod.apply({"params": p, "batch_stats": s}, xj,
                            use_running_average=False,
                            mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (y, stats)), g = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(x))
    nchw = (0, 3, 1, 2)
    return ({"name": f"bn{groups}", "run": "bn", "features": c,
             "groups": groups,
             "init": (_numpy(p), _numpy(s)),
             "x": np.ascontiguousarray(x.transpose(nchw)),
             "w": np.ascontiguousarray(w.transpose(nchw))},
            {"y": np.asarray(y), "grad": np.asarray(g),
             "stats": _numpy(stats)["bn"]}, groups)


def _fid_cases(device="cpu"):
    cases = []
    for name, n in FID_IMAGES.items():
        norm = name == "fid_norm"
        cases.append({"name": name, "run": "fid", "device": device,
                      "inception": init_random_params(seed=0),
                      "images": _images((n, 32, 32, 3), 11,
                                        -1.0 if norm else 0.0, 1.0),
                      "batch_size": 8, "normalize": norm})
    return cases


def _spawn(cases, device="cpu"):
    """Every case on RANKS ranks; {case name: [rank results]}."""
    outs = spawn(run_cases, make_mesh(devices=[device] * RANKS), cases)
    return {c["name"]: [o[c["name"]] for o in outs] for c in cases}


def _jax_references():
    refs = {}
    for name, mode, groups in (("observed", "observed", 1),
                               ("intent", "intent", 1),
                               ("bn_groups2", "observed", 2)):
        refs[name] = _vaegan_case(name, mode, groups)
    for make in (_vae_case, _gan_case, _mnist_case):
        case, want = make()
        refs[case["name"]] = (case, want)
    return refs


@pytest.fixture(scope="module")
def ranks():
    """(JAX references, the two ranks' results) of every multi-rank case:
    one spawn for the module."""
    refs = _jax_references()
    bns = [_bn_case(g) for g in (1, 2)]
    cases = [c for c, _ in refs.values()] + [c for c, _, _ in bns] \
        + _fid_cases()
    got = _spawn(cases)
    return refs, {c["name"]: (want, got[c["name"]]) for c, want, _ in bns}, \
        got


def _check_step(want, got, kind, metric_rtol, param_atol, stats_atol,
                what):
    for rank, r in enumerate(got):
        for step, (m_want, m_got) in enumerate(zip(want["metrics"],
                                                   r["metrics"])):
            for key in STEP_METRICS[kind]:
                rtol = (metric_rtol[step] if isinstance(metric_rtol, tuple)
                        else metric_rtol)
                np.testing.assert_allclose(
                    m_got[key], m_want[key], rtol=rtol,
                    err_msg=f"{what} rank {rank} step {step} {key}")
        for key, (params, stats) in want["trees"].items():
            got_params, got_stats = r["trees"][key]
            _assert_tree_close(params, got_params, param_atol,
                               f"{what} rank {rank} {key} params")
            _assert_tree_close(stats, got_stats, stats_atol,
                               f"{what} rank {rank} {key} running stats")
    # identical state on every rank: parameters, statistics, Adam
    for r in got[1:]:
        np.testing.assert_array_equal(r["state"], got[0]["state"],
                                      err_msg=f"{what}: ranks differ")
        assert r["metrics"] == got[0]["metrics"], what


@pytest.mark.parametrize("mode", ["observed", "intent"])
def test_port_two_rank_vaegan_step_matches_jax_whole_batch(ranks, mode):
    refs, _, got = ranks
    _, want = refs[mode]
    _check_step(want, got[mode], "vaegan", STEP_RTOL[mode], PARAM_ATOL,
                STATS_ATOL, f"[{mode}]")


def test_port_two_rank_vaegan_bn_groups2_matches_jax_bn_groups2(ranks):
    """Two groups over two ranks: each rank normalizes its own group (the
    published DataParallel run); the running statistics are group 0's,
    from rank 0."""
    refs, _, got = ranks
    _, want = refs["bn_groups2"]
    _check_step(want, got["bn_groups2"], "vaegan", BN2_STEP_RTOL,
                BN2_TOL["param_atol"], BN2_TOL["stats_atol"], "[bn_groups 2]")


@pytest.mark.parametrize("name, kind", [("vae", "vae"), ("gan", "gan"),
                                        ("mnist", "family")])
def test_port_two_rank_vae_gan_and_family_steps_match_jax(ranks, name, kind):
    refs, _, got = ranks
    _, want = refs[name]
    tol = TOL["observed"]
    _check_step(want, got[name], kind, tol["metric_rtol"],
                tol["param_atol"], STATS_ATOL, f"[{name}]")


@pytest.mark.parametrize("groups", [1, 2])
def test_port_cross_replica_batchnorm_matches_jax_whole_batch(ranks, groups):
    _, bns, got = ranks
    want, res = bns[f"bn{groups}"]
    nhwc = (0, 2, 3, 1)
    for key in ("y", "grad"):
        full = np.concatenate([r[key] for r in res]).transpose(nhwc)
        np.testing.assert_allclose(full, want[key], **LAYER_TOL,
                                   err_msg=key)
    for r in res:
        np.testing.assert_allclose(r["mean"], want["stats"]["mean"],
                                   **LAYER_TOL)
        np.testing.assert_allclose(r["var"], want["stats"]["var"],
                                   **LAYER_TOL)


@pytest.mark.parametrize("name", list(FID_IMAGES))
def test_port_two_rank_fid_activations_match_jax_unsharded(
        ranks, monkeypatch, name):
    _, _, got = ranks
    case = next(c for c in _fid_cases() if c["name"] == name)
    share_inception(monkeypatch, case["inception"])
    images = case["images"]
    if case["normalize"]:
        images = np.asarray(jax_fid.per_image_normalize(jnp.asarray(images)))
    want = jax_fid.get_activations(images, batch_size=8, shard=False)
    jax_fid._jitted_features_cached.cache_clear()
    for r in got[name]:
        assert r["acts"].shape == want.shape
        np.testing.assert_allclose(r["acts"], want, **POOL3_TOL)
    np.testing.assert_array_equal(got[name][0]["acts"], got[name][1]["acts"])


# ------------------------------------------------------ (e) data slicing --

def test_port_process_local_slice_equals_jax():
    idx = np.arange(12)
    parts = [pipeline.process_local_slice(idx, h, 4) for h in range(4)]
    for h, p in enumerate(parts):
        np.testing.assert_array_equal(
            p, jax_pipeline.process_local_slice(idx, h, 4))
    np.testing.assert_array_equal(np.concatenate(parts), idx)


def test_port_hostshard_selftest():
    hostshard_selftest()


def test_port_sliced_loader_equals_jax_slices_uneven_files():
    """27 images, batches of 8 over 4 processes: each process's batches are
    the JAX loader's slices for that process, bit for bit, and the
    remainder is dropped alike (the JAX package's
    test_uneven_per_host_file_count)."""
    for h in range(4):
        port = pipeline.DataLoader(
            pipeline.SyntheticSource(size=27, img_size=8, seed=11), BATCH,
            shuffle=True, seed=5, device="cpu", process_index=h,
            process_count=4)
        jl = jax_pipeline.DataLoader(
            jax_pipeline.SyntheticSource(size=27, img_size=8, seed=11),
            BATCH, shuffle=True, seed=5, process_index=h, process_count=4)
        for _ in range(2):  # the reshuffle of a second epoch
            pairs = list(zip(port, jl))
            assert len(pairs) == 27 // BATCH
            for (xt, yt), (xj, yj) in pairs:
                assert xt.shape[0] == BATCH // 4
                np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
                np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    with pytest.raises(ValueError, match="divide evenly across 4"):
        pipeline.DataLoader(pipeline.SyntheticSource(size=32, img_size=8),
                            6, device="cpu", process_index=0,
                            process_count=4)


# --------------------------------------------- (g) the trainer, 2 ranks --

def _epoch_numbers(out: str):
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith("====> Epoch:")]
    return [float(v) for v in re.findall(r"[-\d.]+(?:e[-+]\d+)?",
                                         line.split("(")[0])]


def _log(tmp_path, name):
    (path,) = glob.glob(str(tmp_path / name / "log" / "log_*.json"))
    with open(path) as f:
        return json.load(f)["output"]


def test_port_trainer_mesh_shape_2_equals_one_rank(tmp_path, capfd):
    """``cli.train --device cpu --mesh_shape 2``: one synthetic epoch of 2
    steps in 'intent' mode with FID over 8 samples; its epoch line and log
    equal the one-rank run's within CLI_RTOL, its checkpoint (written
    once, by rank 0) holds parameters within PARAM_ATOL of the one-rank
    run's, and it resumes in a one-device run."""
    stats = _stats_npz(tmp_path)

    def argv(name, *extra):
        return ["--model", "betavaegan", "--name", name, "--device", "cpu",
                "--synthetic_data", "True", "--synthetic_train_size", "16",
                "--batch_size_train", str(BATCH), "--freeze_mode", "intent",
                "--calc_fid", "True", "--n_samples", "8",
                "--fid_path_pretrained", stats, "--epochs", "1",
                "--save_path", str(tmp_path / "%"),
                "--log_path", str(tmp_path / "%" / "log"), *TOY_FLAGS,
                *extra]

    two = cli_train.main(argv("two", "--mesh_shape", "2"))
    out_two = capfd.readouterr().out
    assert re.search(r"^\[mesh\] data parallel over 2 rank\(s\) on cpu, "
                     r"cpu, backend gloo; every step eager$", out_two,
                     re.M), out_two
    assert out_two.count("====> Epoch:") == 1  # rank 0 alone prints
    one = cli_train.main(argv("one"))
    out_one = capfd.readouterr().out
    np.testing.assert_allclose(_epoch_numbers(out_two),
                               _epoch_numbers(out_one), rtol=CLI_RTOL)
    (rec_two,), (rec_one,) = _log(tmp_path, "two"), _log(tmp_path, "one")
    assert set(rec_two) == set(rec_one)
    for key in rec_one:
        np.testing.assert_allclose(rec_two[key], rec_one[key], rtol=CLI_RTOL,
                                   err_msg=key)
    assert two["images_per_sec"] > 0 and np.isfinite(two["FID"])
    assert sorted(os.listdir(tmp_path / "two" / "models")) == ["model_1"]
    exp = VAEGANExperiment(Config(**dict(TOY, name="r",
                                         freeze_mode="intent")), "cpu")
    path_two = str(tmp_path / "two" / "models" / "model_1")
    _, s_two = load_checkpoint(path_two, exp.states())
    _, s_one = load_checkpoint(str(tmp_path / "one" / "models" / "model_1"),
                               exp.states())
    _assert_tree_close(_as_numpy(s_one["eg"]["params"]),
                       _as_numpy(s_two["eg"]["params"]),
                       PARAM_ATOL, "checkpoint params")
    # into a one-device experiment bit for bit: saved again, the same bytes
    assert loop._restore(exp, path_two) == 1
    save_checkpoint(str(tmp_path / "again"), 1, exp.states())
    with open(path_two, "rb") as a, open(tmp_path / "again", "rb") as b:
        assert a.read() == b.read()
    cli_train.main(argv("two", "--epochs", "2", "--load_path",
                        str(tmp_path / "two" / "models" / "model_1")))
    assert "====> Epoch: 1 " in capfd.readouterr().out


def _as_numpy(tree):
    return {k: _as_numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


# ------------------------------------------------ (h) β-search groups --

def test_port_group_objectives_of_two_ranks_run_concurrently(tmp_path):
    """Four CPU devices in two groups: two βs trained at once, each by two
    ranks (the JAX package's test_concurrent_group_runs_end_to_end)."""
    cfg = _base(tmp_path, "pairs")
    cpu = torch.device("cpu")
    groups = driver.make_group_objectives(cfg, 2, epochs=1,
                                          devices=[cpu] * 4)
    assert [g.devices for g in groups] == [[cpu, cpu], [cpu, cpu]]
    search = driver.BetaSearch(objective=None).seed()
    batch = search.propose_batch(2)
    search.run_parallel(1, groups)
    assert search.betas[5:] == batch
    assert all(np.isfinite(f) for f in search.fids[5:])


def test_port_nondividing_explicit_group_raises_as_jax(tmp_path):
    """A batch of 6 on an explicit group of 4 raises the JAX package's
    error (its test_setup_parallel_rejects_nondividing_explicit_group),
    also through a group objective; an implicit CPU mesh falls back to one
    device; the bn_groups the ranks cannot split raise."""
    kw = dict(TOY, name="nd", batch_size_train=6,
              save_path=str(tmp_path / "%"), log_path=str(tmp_path / "%/log"))
    with pytest.raises(ValueError) as want:
        jax_loop._setup_parallel(JaxConfig(**kw).finalize(),
                                 devices=jax.devices()[:4])
    with pytest.raises(ValueError) as got:
        loop._setup_parallel(Config(**kw), "cpu", devices=["cpu"] * 4)
    assert str(got.value) == str(want.value)
    (objective,) = driver.make_group_objectives(
        Config(**kw).finalize(), 1, devices=[torch.device("cpu")] * 4)
    with pytest.raises(ValueError, match="must divide the explicit "
                                         "4-device group"):
        objective(25.0)
    assert loop._setup_parallel(Config(**dict(kw, mesh_shape=4)),
                                "cpu") is None
    with pytest.raises(ValueError, match="bn_groups=3 does not split"):
        loop._setup_parallel(Config(**dict(kw, batch_size_train=12,
                                           bn_groups=3, mesh_shape=2)), "cpu")
    with pytest.raises(ValueError, match="more devices than the 0 visible"):
        loop._setup_parallel(Config(**dict(kw, mesh_shape=2)), "cuda")


def test_port_one_device_runs_build_no_mesh_of_several(tmp_path,
                                                       monkeypatch):
    """On a host of four CUDA devices, ``make_group_objectives(cfg, 4)``
    pins each β run to a mesh of its own one device (as the JAX package's
    groups are pinned), and ``run_vaegan(device='cuda:1')`` runs on that
    device alone, without a mesh; ``--mesh_shape 2`` with it raises. The
    runs themselves are replaced: only the meshes they would get are
    read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    meshes, alone = [], []
    monkeypatch.setattr(loop, "spawn", lambda fn, mesh, *a: (
        meshes.append(mesh), [{"FID": 1.0}])[1])
    monkeypatch.setattr(loop, "_run_vaegan", lambda cfg, logger, device,
                        mesh=None: (alone.append((device, mesh)),
                                    {"FID": 1.0})[1])
    cfg = _base(tmp_path, "pinned")
    groups = driver.make_group_objectives(cfg, 4, epochs=1)
    for g in groups:
        assert g(25.0) == 1.0
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert [g.devices for g in groups] == [[d] for d in cuda]
    assert [m.devices for m in meshes] == [(d,) for d in cuda]
    loop.run_vaegan(cfg, device="cuda:1")
    assert alone == [(torch.device("cuda", 1), None)]
    assert len(meshes) == 4
    with pytest.raises(ValueError, match="on the one device cuda:1"):
        loop.run_vaegan(Config(**dict(TOY, name="p2", mesh_shape=2)),
                        device="cuda:1")


def test_port_one_device_meshes_run_side_by_side():
    """Meshes of one device joined on threads of one process each hold a
    process group of their own (the β search's concurrent one-device
    groups): none sees another's sums, and no process-wide group is
    left."""
    import threading

    from disentangle_mlp_tpu_torch.parallel import (all_gather_rows,
                                                    all_reduce_flat)

    def rank(mesh, i):
        x = torch.full((3,), float(i))
        (s,) = all_reduce_flat([x], mesh)
        return s.tolist(), all_gather_rows(x[None], mesh).tolist()

    got = {}
    threads = [threading.Thread(target=lambda i=i: got.__setitem__(
        i, spawn(rank, make_mesh(devices=["cpu"]), i)[0]))
        for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert got == {i: ([float(i)] * 3, [[float(i)] * 3]) for i in range(3)}
    assert not torch.distributed.is_initialized()


def _one_device_gaps() -> dict:
    """The one-device port against JAX at this batch, per mode: each
    metric's relative difference per step and the largest parameter
    difference (BatchNorm-fed biases apart), which set STEP_RTOL and
    PARAM_ATOL."""
    from disentangle_mlp_tpu_torch.utils.params import from_jax, to_jax
    from tests.test_torch_trajectory import BN_CANCELLED

    out = {}
    for mode in ("observed", "intent"):
        case, want = _vaegan_case(mode, mode)
        exp = VAEGANExperiment(Config(**case["config"]), "cpu")
        from_jax(exp.vae, *case["init"]["eg"])
        from_jax(exp.discriminator, *case["init"]["d"])
        x = torch.from_numpy(case["batch"])
        steps = []
        for d, w in zip(case["draws"], want["metrics"]):
            m = exp.train_step(x, draws=d)
            steps.append({k: abs(float(m[k]) / w[k] - 1) for k in w})
        worst = 0.0
        for key, net in (("eg", exp.vae), ("d", exp.discriminator)):
            flat = jax.tree_util.tree_flatten_with_path(want["trees"][key][0])
            ours = jax.tree_util.tree_flatten_with_path(to_jax(net)[0])
            for (path, a), (_, b) in zip(flat[0], ours[0]):
                ks = jax.tree_util.keystr(path)
                if ks.endswith("['bias']") and any(f"['{m}']" in ks
                                                  for m in BN_CANCELLED):
                    continue
                worst = max(worst, float(np.abs(np.asarray(a) - b).max()))
        out[mode] = {"metric_rel_by_step": steps, "param_abs": worst}
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_parallel.py
    print(json.dumps(_one_device_gaps(), indent=1))

