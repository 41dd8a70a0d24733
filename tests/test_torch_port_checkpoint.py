"""Checkpoints shared between the JAX package and the port
(disentangle_mlp_tpu_torch: utils/msgpack.py, utils/checkpoint.py and the
Adam bridge of utils/params.py), on the CPU at toy width:

- the msgpack codec against flax.serialization, both ways and byte for
  byte, chunked arrays included;
- checkpoints the JAX package writes load into the port, and checkpoints
  the port writes load into the JAX package, for the three experiments,
  both freeze modes of the β-VAE-GAN, float32 and bfloat16 moments: every
  parameter, statistic, moment and step count equal after the layout
  transform;
- a run the JAX package started continues in the port: the port's step
  from the JAX checkpoint matches the JAX package's own next step;
- ``--checkpoint_save_dtype bfloat16`` through the trainer CLI, and the
  refusals of a checkpoint that does not fit;
- the ``AsyncCheckpointer``: its file byte-identical to the synchronous
  writer's (and read by the JAX package), written from the snapshot taken
  at ``save`` (the worker held while the parameters change), rotated only
  after it has landed, and its worker's error raised by ``wait``.
"""

import functools
import glob
import threading

import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from disentangle_mlp_tpu.config import Config as JaxConfig
from disentangle_mlp_tpu.train.gan import create_gan_experiment
from disentangle_mlp_tpu.train.vae import create_vae_experiment
from disentangle_mlp_tpu.train.vaegan import create_vaegan_experiment
from disentangle_mlp_tpu.utils import checkpoint as jax_ckpt
from disentangle_mlp_tpu_torch.cli import train as cli_train
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.train import loop
from disentangle_mlp_tpu_torch.train.gan import GANExperiment
from disentangle_mlp_tpu_torch.train.scan import state_tensors
from disentangle_mlp_tpu_torch.train.vae import VAEExperiment
from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
from disentangle_mlp_tpu_torch.utils import checkpoint as port_ckpt
from disentangle_mlp_tpu_torch.utils import msgpack
from tests.test_torch_port_loop import _argv
from tests.test_torch_port_vae import batch, jax_vae_step, toy_kwargs
from tests.test_torch_trajectory import TOL, _assert_tree_close

# model, freeze mode → (JAX factory, its states, port experiment)
EXPERIMENTS = {
    "vae": (create_vae_experiment, lambda e: {"model": e.state},
            VAEExperiment),
    "gan": (create_gan_experiment, lambda e: {"g": e.g_state, "d": e.d_state},
            GANExperiment),
    "betavaegan": (create_vaegan_experiment,
                   lambda e: {"eg": e.eg_state, "d": e.d_state},
                   VAEGANExperiment),
}
CASES = [("vae", "observed"), ("gan", "observed"),
         ("betavaegan", "observed"), ("betavaegan", "intent")]


# ----------------------------------------------------------------- codec --

def _bf16(values):
    return (np.asarray(jnp.asarray(values, jnp.bfloat16)),
            torch.tensor(values, dtype=torch.bfloat16))


def _codec_trees():
    """The same tree for flax (numpy leaves) and for the port (torch
    leaves): ints of every width, floats, str, bool, nil, an empty map,
    0-d int32 (optax's count), bfloat16, a transposed (non-contiguous)
    array, a numpy scalar."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 5)).astype(np.float32)
    bf_np, bf_t = _bf16([[1.5, -2.25, 3e-3], [7.0, 0.0, -1e30]])
    common = {"epoch": 30, "small": -7, "neg": -200, "u16": 60000,
              "u32": 2 ** 31, "i64": -2 ** 40, "float": 0.1, "yes": True,
              "no": False, "nil": None, "name": "x" * 40, "empty": {},
              "scalar": np.float32(2.5)}
    flax_tree = dict(common, count=np.zeros((), np.int32), a=a, aT=a.T,
                     bf=bf_np, big=np.arange(70000, dtype=np.int64),
                     nested={"k": {"kernel": a[:2]}, "1": {}})
    port_tree = dict(common, count=torch.zeros((), dtype=torch.int32),
                     a=torch.from_numpy(a), aT=torch.from_numpy(a).t(),
                     bf=bf_t, big=torch.arange(70000, dtype=torch.int64),
                     nested={"k": {"kernel": torch.from_numpy(a[:2])},
                             "1": {}})
    return flax_tree, port_tree


def _assert_same(got, want, path=""):
    """A port tree (torch leaves) equal to a flax one (numpy leaves)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        assert isinstance(got, torch.Tensor), path
        assert tuple(got.shape) == want.shape, path
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, path
            got, want = got.float().numpy(), want.astype(np.float32)
        else:
            got = got.numpy()
            assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_port_msgpack_writes_flax_bytes_and_reads_them_back():
    flax_tree, port_tree = _codec_trees()
    data = serialization.msgpack_serialize(flax_tree)
    assert msgpack.packb(port_tree) == data
    _assert_same(msgpack.unpackb(data), flax_tree)
    # and flax reads what the port writes
    _assert_same(msgpack.unpackb(serialization.msgpack_serialize(
        serialization.msgpack_restore(msgpack.packb(port_tree)))), flax_tree)


def test_port_msgpack_chunked_arrays_both_ways(monkeypatch):
    """Array leaves over the chunk limit are stored as flax's chunk maps
    (a small limit stands in for flax's 2**30 bytes)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    a = np.arange(3 * 7 * 5, dtype=np.float32).reshape(3, 7, 5)
    bf_np, bf_t = _bf16(np.linspace(-3, 3, 50).reshape(5, 10).tolist())
    flax_tree = {"a": a, "bf": bf_np, "small": a[0, 0]}
    port_tree = {"a": torch.from_numpy(a), "bf": bf_t,
                 "small": torch.from_numpy(a[0, 0].copy())}
    _assert_same(msgpack.unpackb(serialization.msgpack_serialize(flax_tree)),
                 flax_tree)
    back = serialization.msgpack_restore(msgpack.packb(port_tree))
    np.testing.assert_array_equal(back["a"], a)
    np.testing.assert_array_equal(back["bf"].astype(np.float32),
                                  bf_np.astype(np.float32))


# ----------------------------------------------------- both frameworks ---

@functools.lru_cache(maxsize=None)
def _jax_experiment(model, mode):
    make = EXPERIMENTS[model][0]
    return make(JaxConfig(**toy_kwargs(f"ck_{model}", freeze_mode=mode)),
                jax.random.key(0))


def _jax_states(model, mode):
    return EXPERIMENTS[model][1](_jax_experiment(model, mode))


def _random_like(states, seed):
    """Every float leaf random (optimizer moments included), every step
    count a random int32: nothing can match by accident."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        if x.dtype == jnp.int32:
            return jnp.asarray(rng.integers(1, 1000), jnp.int32)
        return jnp.asarray(rng.normal(size=x.shape), x.dtype)

    return jax.tree.map(leaf, states)


def _port(model, mode, **kw):
    cfg = Config(**toy_kwargs(f"ck_{model}", freeze_mode=mode, **kw))
    return EXPERIMENTS[model][2](cfg, "cpu")


def _assert_states_equal(port_states, jax_states, moments_via=None):
    """The port's ``states()`` equal to JAX states, leaf by leaf; with
    ``moments_via`` the port's float32 moments are first rounded through
    that dtype (what a bf16 file holds)."""
    want = serialization.to_state_dict(jax_states)

    def walk(got, want, path):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                walk(got[k], want[k], f"{path}/{k}")
            return
        want = np.asarray(want)
        if moments_via is not None and "opt_state" in path.split("/") \
                and got.dtype == torch.float32:
            got = got.to(moments_via).float()
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).replace("torch.", "") == want.dtype.name, path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)

    walk(port_states, want, "")


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("model, mode", CASES)
def test_port_loads_jax_checkpoints_exactly(tmp_path, capsys, model, mode,
                                            moments):
    states = _random_like(_jax_states(model, mode), 1)
    path = str(tmp_path / "model_3")
    jax_ckpt.save_checkpoint(path, 3, states,
                             opt_state_dtype=moments if moments != "float32"
                             else None)
    port = _port(model, mode)
    assert loop._restore(port, path) == 3
    # the JAX package's own restore casts bf16 moments back to float32, as
    # the port does
    _, want = jax_ckpt.load_checkpoint(path, _jax_states(model, mode))
    _assert_states_equal(port.states(), want)
    notice = "opt_state leaves to the experiment's --optimizer_dtype"
    assert (notice in capsys.readouterr().out) == (moments == "bfloat16")


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("model, mode", CASES)
def test_jax_loads_port_checkpoints_exactly(tmp_path, model, mode, moments):
    port = _port(model, mode)
    # random values everywhere, from a random flax tree of this structure
    template = _jax_states(model, mode)
    port.load_states(_to_torch(serialization.to_state_dict(
        _random_like(template, 2))))
    path = str(tmp_path / "model_5")
    port_ckpt.save_checkpoint(path, 5, port.states(), moments)
    epoch, got = jax_ckpt.load_checkpoint(path, template)
    assert epoch == 5
    _assert_states_equal(port.states(), got,
                         moments_via=None if moments == "float32"
                         else torch.bfloat16)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_port_resumes_a_jax_run_at_its_next_step(tmp_path):
    """The JAX package trains a step and saves; the port loads it and takes
    the next step, which must match the JAX package's own second step: the
    parameters, statistics, both moments and the step count all carried
    over (a count restarted at 0 redoes Adam's bias correction)."""
    kw = toy_kwargs("resume")
    jexp = create_vae_experiment(JaxConfig(**kw), jax.random.key(0))
    x_j, x_t = batch()
    state1, _, _ = jax_vae_step(jexp, jexp.state, x_j, 0)
    path = str(tmp_path / "model_1")
    jax_ckpt.save_checkpoint(path, 1, {"model": state1})
    state2, m2, eps2 = jax_vae_step(jexp, state1, x_j, 1)

    port = VAEExperiment(Config(**kw), "cpu")
    assert loop._restore(port, path) == 1
    assert port.opt.count == 1
    ours = port.train_step(x_t, draws={"eps": np.array(eps2)})
    assert port.opt.count == 2
    tol = TOL["observed"]
    np.testing.assert_allclose(ours["loss"].item(), float(m2["loss"]),
                               rtol=tol["metric_rtol"])
    got = port.states()["model"]
    _assert_tree_close(state2.params, _numpy(got["params"]),
                       tol["param_atol"], "params after the resumed step")
    _assert_tree_close(state2.opt_state[0].nu,
                       _numpy(got["opt_state"]["0"]["nu"]),
                       tol["param_atol"], "Adam nu after the resumed step")


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


# ------------------------------------------------------- CLI and refusals --

def test_port_trainer_saves_bf16_moments_and_resumes_in_float32(tmp_path,
                                                                capsys):
    """--checkpoint_save_dtype bfloat16 writes the Adam moments in bf16 and
    nothing else; a resume casts them to the run's --optimizer_dtype and
    says so."""
    argv = [a if a != "betavaegan" else "vae" for a in _argv(
        tmp_path, "--epochs", "1", "--checkpoint_save_dtype", "bfloat16")]
    cli_train.main(argv)
    (path,) = glob.glob(str(tmp_path / "port_cli" / "models" / "model_1"))
    raw = msgpack.load(path)
    assert raw["epoch"] == 1 and set(raw["states"]) == {"model"}
    state = raw["states"]["model"]
    adam = state["opt_state"]["0"]
    assert state["opt_state"]["1"] == {}
    assert adam["count"].dtype == torch.int32 and int(adam["count"]) == 2
    for part, dtype in ((state["params"], torch.float32),
                        (state["batch_stats"], torch.float32),
                        (adam["mu"], torch.bfloat16),
                        (adam["nu"], torch.bfloat16)):
        assert {t.dtype for t in _leaves(part)} == {dtype}
    capsys.readouterr()
    out = cli_train.main(argv[:argv.index("--epochs") + 1] + ["2"]
                         + argv[argv.index("--epochs") + 2:]
                         + ["--load_path", path])
    log = capsys.readouterr().out
    assert "cast 'model' opt_state leaves" in log and "bfloat16->float32" \
        in log
    assert np.isfinite(out["Avg Loss"])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("fault", ["freeze_mode", "param_dtype", "shape"])
def test_port_checkpoint_refuses_what_does_not_fit(tmp_path, fault):
    intent = _port("betavaegan", "intent")
    path = str(tmp_path / "model_1")
    states = intent.states()
    target = _port("betavaegan", "observed")
    match = "--freeze_mode"
    if fault == "param_dtype":
        target = intent
        states["d"]["params"]["conv1"]["kernel"] = \
            states["d"]["params"]["conv1"]["kernel"].bfloat16()
        match = "bfloat16, the experiment holds float32"
    elif fault == "shape":
        target = _port("betavaegan", "intent", head_width=16)
        match = "shape"
    port_ckpt.save_checkpoint(path, 1, states)
    with pytest.raises(ValueError, match=match):
        loop._restore(target, path)


# ------------------------------------------------------ async checkpoints --

def _held_writer(monkeypatch):
    """Hold the AsyncCheckpointer's worker before it writes: returns (an
    event set when the worker is held, the event that releases it)."""
    held, release = threading.Event(), threading.Event()
    write = port_ckpt.save_checkpoint

    def held_write(*args, **kw):
        held.set()
        assert release.wait(60)
        return write(*args, **kw)

    monkeypatch.setattr(port_ckpt, "save_checkpoint", held_write)
    return held, release


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_port_async_checkpoint_is_the_sync_file(tmp_path, moments):
    """The worker's file is byte-identical to save_checkpoint's, and the
    JAX package's load_checkpoint reads it exactly."""
    port = _port("betavaegan", "intent")
    template = _jax_states("betavaegan", "intent")
    port.load_states(_to_torch(serialization.to_state_dict(
        _random_like(template, 3))))
    sync, path = str(tmp_path / "sync"), str(tmp_path / "model_2")
    port_ckpt.save_checkpoint(sync, 2, port.states(), moments)
    saver = port_ckpt.AsyncCheckpointer(moments)
    saver.save(path, 2, port.states())
    saver.wait()
    with open(sync, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()
    assert saver.last["path"] == path and saver.last["bytes"] > 0
    epoch, got = jax_ckpt.load_checkpoint(path, template)
    assert epoch == 2
    _assert_states_equal(port.states(), got,
                         moments_via=None if moments == "float32"
                         else torch.bfloat16)


def test_port_async_checkpoint_writes_the_snapshot(tmp_path, monkeypatch):
    """Parameters, moments and counts changed after save() returned do not
    reach the file: the worker, held until they have changed, writes the
    states as they were at the call."""
    port = _port("vae", "observed")
    want = str(tmp_path / "want")
    port_ckpt.save_checkpoint(want, 1, port.states())
    held, release = _held_writer(monkeypatch)
    saver = port_ckpt.AsyncCheckpointer()
    path = str(tmp_path / "model_1")
    saver.save(path, 1, port.states())
    assert held.wait(60)
    with torch.no_grad():
        for t in state_tensors(port):
            t.add_(1)
    release.set()
    saver.wait()
    with open(want, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()


def test_port_async_checkpoint_rotates_after_the_write_lands(tmp_path,
                                                             monkeypatch):
    """keep 2: while a save is held the older files stay; once it lands
    exactly the two newest remain (the JAX package rotated from the caller
    through round 4, before the write existed, and left three)."""
    port = _port("vae", "observed")
    saver = port_ckpt.AsyncCheckpointer()
    names = lambda: sorted(p.name for p in tmp_path.iterdir())  # noqa: E731
    for n in (1, 2, 3):
        saver.save(str(tmp_path / f"model_{n}"), n, port.states(),
                   rotate_keep=2)
    saver.wait()
    assert names() == ["model_2", "model_3"]
    held, release = _held_writer(monkeypatch)
    saver.save(str(tmp_path / "model_4"), 4, port.states(), rotate_keep=2)
    assert held.wait(60)
    assert names() == ["model_2", "model_3"]
    release.set()
    saver.wait()
    assert names() == ["model_3", "model_4"]


def test_port_async_checkpoint_raises_the_worker_error(tmp_path,
                                                       monkeypatch):
    """An error of the worker comes up at the next wait(), once."""
    def broken(*args, **kw):
        raise OSError("no space left on device")

    monkeypatch.setattr(port_ckpt, "save_checkpoint", broken)
    saver = port_ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path / "model_1"), 1, _port("vae", "observed")
               .states())
    with pytest.raises(OSError, match="no space left"):
        saver.wait()
    saver.wait()
    assert not (tmp_path / "model_1").exists()
