"""The two-rank walk of the encoder heads' BatchNorm statistics, in the JAX
package and in the port, side by side on the CPU.

At full width the running statistics of ``encoder.mu_bn`` and
``encoder.lv_bn`` (the BatchNorms after the two 16384→2048 heads) and the
KL term differ between one device on the whole batch and two devices on
half of it each by much more than every other reading: Adam's sign-like
update moves each element of the two 33.5M-weight heads whose gradient
lies within rounding noise by ±lr, the reduction orders of one and two
devices round those gradients differently, and each channel's statistic
sums 16384 such elements. This file measures that walk in both packages
from one start:

- the JAX package's full-width float32 β-VAE-GAN ('observed', β 25,
  ``create_vaegan_experiment``) in a subprocess with two forced host
  devices (``--xla_force_host_platform_device_count=2``, as
  ``__graft_entry__.dryrun_multichip`` forces them): WALK_STEPS steps on
  one device, then the same steps from the same state, batches and keys
  with ``replicate``/``shard_batch`` over ``make_mesh(2)``;
- the port from the JAX state, with the JAX run's draws injected: one
  process on the whole batch against two gloo ranks of half of it each
  (``parallel.spawn``, as tests/test_torch_port_parallel.py runs them).

Readings after every step (:func:`readings`): each walk leaf's largest
|Δ| beside its largest |value|, the KL term's relative difference, and the
largest |Δ| of every other running statistic, for scale. The test holds
each of the port's walk readings at each step within WALK_MULTIPLE times
the JAX package's largest reading of it up to that step (:func:`envelope`),
at a global batch of WALK_BATCH (the test takes about 4 minutes on 8
cores, so it is marked slow):

    python -m pytest tests/test_torch_port_walk.py -m slow -q -s

The batches are those of chip_smoke.py's ``[ddp] gloo w2``: the synthetic
source at the config's seed (``--noise``: uniform noise, on which both
packages' running variances walk about a hundred times less: the walk
depends on the data). The same comparison at another batch, printed as
JSON (one side alone with ``--only jax`` or ``--only port``, the port then
from its own seeded start and draws):

    JAX_PLATFORMS=cpu python -m tests.test_torch_port_walk --batch 256 \\
        --only jax
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALK_BATCH, WALK_STEPS, BETA, SEED = 32, 3, 25.0, 0
# "the same order": a port walk reading at most this many times the JAX
# package's largest up to the same step
WALK_MULTIPLE = 4.0
WALK_LEAVES = tuple(f"eg/encoder/{bn}/bn/{s}" for bn in ("mu_bn", "lv_bn")
                    for s in ("mean", "var"))
WALK_METRICS = ("kld",)
METRICS = ("D_x", "sim", "kld", "recon_enc", "recon_dec", "dis")


def config_kwargs(batch: int) -> dict:
    """Both packages' Config fields of the walk: full default width,
    float32."""
    return dict(name="walk", batch_size_train=batch, dtype="float32",
                beta=BETA, freeze_mode="observed")


def flat(tree, prefix: str = "") -> dict:
    """A nested dict of arrays as {"a/b/c": numpy array}, copied."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.array(tree)}


def nest(leaves: dict) -> dict:
    """The inverse of :func:`flat`."""
    out: dict = {}
    for path, v in leaves.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def readings(got: list, want: list) -> list:
    """Per step, two runs' readings: ``got`` and ``want`` are lists (one
    entry a step) of {"stats": {leaf: array}, "metrics": {name: float}};
    ``want`` is the one-device run. Each walk leaf: [largest |Δ|, largest
    |value|]; each walk metric: its relative difference; "other": [largest
    |Δ| of any other running statistic, its leaf, its largest |value|]."""
    out = []
    for g, w in zip(got, want):
        step = {}
        other = (0.0, "", 0.0)
        for leaf, b in w["stats"].items():
            d = float(np.abs(g["stats"][leaf].astype(np.float64)
                             - b.astype(np.float64)).max())
            if leaf in WALK_LEAVES:
                step[leaf] = [d, float(np.abs(b).max())]
            elif d >= other[0]:
                other = (d, leaf, float(np.abs(b).max()))
        for k in WALK_METRICS:
            step[k] = abs(g["metrics"][k] / w["metrics"][k] - 1.0)
        step["other"] = list(other)
        out.append(step)
    return out


def envelope(walk: list, running: bool = True) -> list:
    """Each walk reading of :func:`readings` by step as one number (a
    leaf's largest |Δ|), with ``running`` its largest over the steps so
    far: a walk's size is its envelope, and a scalar such as the KL term's
    difference can be small at one step by chance."""
    out, top = [], {}
    for step in walk:
        now = {k: (step[k][0] if k in WALK_LEAVES else step[k])
               for k in WALK_LEAVES + WALK_METRICS}
        top = {k: max(v, top.get(k, 0.0)) if running else v
               for k, v in now.items()}
        out.append(top)
    return out


def _batches(source, batch: int, steps: int, cfg,
             noise: bool = False) -> np.ndarray:
    """``steps`` global batches of ``source`` (either package's
    SyntheticSource: the two are identical), made as chip_smoke.py's
    ``[ddp] gloo w2`` makes its batches; with ``noise`` uniform noise in
    [-1, 1] instead."""
    if noise:
        return np.random.default_rng(SEED).uniform(
            -1.0, 1.0, (steps, batch, cfg.img_size, cfg.img_size, 3)
        ).astype(np.float32)
    x, _ = source(size=steps * batch, img_size=cfg.img_size,
                  seed=cfg.seed).load_batch(np.arange(steps * batch))
    return x.reshape((steps, batch) + x.shape[1:]).astype(np.float32)


# ---------------------------------------------------------------------------
# the JAX package (in a subprocess with two forced host devices)
# ---------------------------------------------------------------------------

def _jax_walk(batch: int, steps: int, out: str, save_start: bool,
              noise: bool) -> None:
    """The JAX side, in this process (which must see 2 CPU devices): the
    steps on one device, then on ``make_mesh(2)``; writes ``out`` (.npz):
    the readings as JSON, and with ``save_start`` the initial state, the
    batches and the one-device run's draws for the port."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from disentangle_mlp_tpu.config import Config
    from disentangle_mlp_tpu.data.pipeline import SyntheticSource
    from disentangle_mlp_tpu.parallel.mesh import (make_mesh, replicate,
                                                   shard_batch)
    from disentangle_mlp_tpu.train.vaegan import create_vaegan_experiment
    from tests.test_torch_port_families import with_draws
    from tests.test_torch_trajectory import _labels_for

    if len(jax.devices()) < 2:
        raise RuntimeError(f"the JAX walk needs 2 devices, found "
                           f"{jax.devices()}")
    cfg = Config(**config_kwargs(batch))
    xs = _batches(SyntheticSource, batch, steps, cfg, noise)

    def run(mesh):
        """(the record, the draws, the initial state as numpy) of one
        run."""
        exp = create_vaegan_experiment(cfg, jax.random.key(SEED))
        eg, d = exp.eg_state, exp.d_state
        init = jax.tree_util.tree_map(np.array, {
            "eg": (eg.params, eg.batch_stats),
            "d": (d.params, d.batch_stats)}) if save_start else None
        if mesh is not None:
            eg, d = replicate(eg, mesh), replicate(d, mesh)
        step_fn = with_draws(lambda *a: exp.step_with_beta(*a, BETA),
                             (batch, cfg.n_hidden))
        record, draws = [], []
        for s in range(steps):
            x = jnp.asarray(xs[s])
            if mesh is not None:
                x = shard_batch(x, mesh)
            rng = jax.random.fold_in(jax.random.key(7), s)
            (eg, d, m), normals = step_fn(eg, d, x, rng)
            real_l, fake_l = _labels_for(rng, 4)
            draws.append({"labels": {"real": real_l, "fake": fake_l},
                          **dict(zip(("noise", "eps_dec", "eps_enc"),
                                     map(np.asarray, normals)))})
            record.append({"stats": flat({"eg": jax.device_get(
                eg.batch_stats), "d": jax.device_get(d.batch_stats)}),
                "metrics": {k: float(m[k]) for k in METRICS}})
        return record, draws, init

    one, draws, init = run(None)
    jax.clear_caches()  # one run's buffers at a time
    two, draws2, _ = run(make_mesh(2, devices=jax.devices()[:2]))
    for a, b in zip(draws, draws2):  # the same keys give the same draws
        for k in ("noise", "eps_dec", "eps_enc"):
            np.testing.assert_array_equal(a[k], b[k])
    arrays = {"readings": np.array(json.dumps(readings(two, one)))}
    if save_start:
        for net, (params, stats) in init.items():
            arrays.update({f"init/{net}/params/{k}": v
                           for k, v in flat(params).items()})
            arrays.update({f"init/{net}/stats/{k}": v
                           for k, v in flat(stats).items()})
        arrays["batches"] = xs
        for s, d in enumerate(draws):
            arrays.update({f"draws/{s}/{k}": v for k, v in d.items()
                           if k != "labels"})
            arrays[f"draws/{s}/labels"] = np.array(
                [d["labels"]["real"], d["labels"]["fake"]])
    np.savez(out, **arrays)


def jax_walk(batch: int, steps: int = WALK_STEPS, out: str = "",
             save_start: bool = False, noise: bool = False) -> list:
    """The JAX package's walk (:func:`readings` of two devices against one)
    from a subprocess with two forced host devices; the .npz it writes
    stays at ``out`` when given."""
    with tempfile.TemporaryDirectory() as tmp:
        path = out or os.path.join(tmp, "jax_walk.npz")
        env = dict(os.environ)
        flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                       env.get("XLA_FLAGS", ""))
        # the two host devices share the cores: at batch 256 one device's
        # work between two all-reduces outlasts XLA's 40 s rendezvous
        # timeout, which aborts the process
        env["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count=2 "
            f"--xla_cpu_collective_call_terminate_timeout_seconds=3600 "
            f"--xla_cpu_collective_call_warn_stuck_timeout_seconds=600 "
            f"--xla_cpu_collective_timeout_seconds=3600").strip()
        env["JAX_PLATFORMS"] = "cpu"
        code = (f"from tests.test_torch_port_walk import _jax_walk; "
                f"_jax_walk({batch}, {steps}, {path!r}, {save_start}, "
                f"{noise})")
        subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       check=True)
        with np.load(path) as f:
            return json.loads(str(f["readings"]))


# ---------------------------------------------------------------------------
# the port (one process, then two gloo ranks), from the JAX start
# ---------------------------------------------------------------------------

def _port_run(mesh, path: str, batch: int, steps: int) -> list:
    """The port's steps from the start in ``path`` on the CPU, on this
    rank's rows of each batch and draw (the whole batch when ``mesh`` is
    None); the running statistics and metrics after each step."""
    from disentangle_mlp_tpu_torch.config import Config
    from disentangle_mlp_tpu_torch.parallel.mesh import local_rows
    from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
    from disentangle_mlp_tpu_torch.utils.params import from_jax, to_jax

    rows = slice(None) if mesh is None else local_rows(batch, mesh)
    with np.load(path) as f:
        start = nest({k[len("init/"):]: f[k] for k in f.files
                      if k.startswith("init/")})
        xs = f["batches"]
        draws = [{k: f[f"draws/{s}/{k}"][rows]
                  for k in ("noise", "eps_dec", "eps_enc")}
                 | {"labels": dict(zip(("real", "fake"),
                                       map(float, f[f"draws/{s}/labels"])))}
                 for s in range(steps)]
    exp = VAEGANExperiment(Config(**config_kwargs(batch)), "cpu",
                           mesh=mesh)
    for attr, net in (("vae", "eg"), ("discriminator", "d")):
        from_jax(getattr(exp, attr), start[net]["params"],
                 start[net]["stats"])
    record = []
    for s in range(steps):
        m = exp.train_step(torch.from_numpy(xs[s][rows]), draws=draws[s])
        record.append({
            "stats": flat({"eg": to_jax(exp.vae)[1],
                           "d": to_jax(exp.discriminator)[1]}),
            "metrics": {k: float(m[k]) for k in METRICS}})
    return record


def port_walk(path: str, batch: int, steps: int = WALK_STEPS) -> list:
    """The port's walk (:func:`readings` of two gloo ranks against one
    process) from the start and draws the JAX side saved at ``path``."""
    from disentangle_mlp_tpu_torch.parallel import make_mesh, spawn

    one = _port_run(None, path, batch, steps)
    two = spawn(_port_run, make_mesh(2, device="cpu"), path, batch,
                steps)[0]
    return readings(two, one)


def port_start(path: str, batch: int, steps: int = WALK_STEPS,
               noise: bool = False) -> None:
    """A start for :func:`port_walk` without the JAX package: the port's
    own seeded initial state and draws, in the layout ``_jax_walk`` saves."""
    from disentangle_mlp_tpu_torch.config import Config
    from disentangle_mlp_tpu_torch.data.pipeline import SyntheticSource
    from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
    from disentangle_mlp_tpu_torch.utils.params import to_jax

    cfg = Config(**config_kwargs(batch))
    exp = VAEGANExperiment(cfg, "cpu")
    arrays = {"batches": _batches(SyntheticSource, batch, steps, cfg,
                                  noise)}
    for net, module in (("eg", exp.vae), ("d", exp.discriminator)):
        params, stats = to_jax(module)
        arrays.update({f"init/{net}/params/{k}": v
                       for k, v in flat(params).items()})
        arrays.update({f"init/{net}/stats/{k}": v
                       for k, v in flat(stats).items()})
    for s in range(steps):
        arrays.update({f"draws/{s}/{k}": v.numpy()
                       for k, v in exp.draw(batch).items()})
    np.savez(path, **arrays)


def compare(batch: int, only: str = "", noise: bool = False) -> dict:
    """Both walks at ``batch``, or the one ``only`` names ("jax", or
    "port" from the port's own start); ``noise``: on uniform noise."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "start.npz")
        out = {"batch": batch, "steps": WALK_STEPS}
        if only == "port":
            port_start(path, batch, noise=noise)
        else:
            out["jax"] = jax_walk(batch, out=path, save_start=only != "jax",
                                  noise=noise)
        if only != "jax":
            out["port"] = port_walk(path, batch)
    return out


@pytest.mark.slow
def test_port_two_rank_walk_is_the_jax_packages():
    """The port's two-rank walk of mu_bn's and lv_bn's running statistics
    and of the KL term, step by step, within WALK_MULTIPLE times the JAX
    package's two-device walk from the same start, batches and draws."""
    res = compare(WALK_BATCH)
    print(json.dumps(res))
    bound = envelope(res["jax"])
    over = [(s + 1, k, got, bound[s][k])
            for s, step in enumerate(envelope(res["port"], running=False))
            for k, got in step.items() if got > WALK_MULTIPLE * bound[s][k]]
    assert not over, (f"(step, reading, port, JAX) beyond x{WALK_MULTIPLE} "
                      f"the JAX walk: {over}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=WALK_BATCH)
    p.add_argument("--only", choices=("jax", "port"), default="")
    p.add_argument("--noise", action="store_true",
                   help="uniform noise images instead of the synthetic "
                        "source's")
    ns = p.parse_args(argv)
    print(json.dumps(compare(ns.batch, ns.only, ns.noise)), flush=True)


if __name__ == "__main__":
    main()
