"""The port's β search (disentangle_mlp_tpu_torch: bo/gp.py, bo/driver.py,
cli/bo.py) against the JAX package's on the same inputs, on the CPU at toy
width:

- the GP posterior and EI on the β grid, to rtol 1e-12 (both are float64
  numpy on the same data);
- the proposals of ``run``, ``propose_batch`` and the grid-exhausted ends,
  β for β; ``run_parallel`` persisting the same ``bo_history.json`` when a
  group fails;
- ``--posterior_only`` writing the same JSON; ``beta_run_config`` giving
  the same paths and fields;
- the port's training objectives: a toy β-VAE-GAN on the CPU to a finite
  FID in its own tree; two βs trained concurrently on two one-device
  groups, each giving the numbers it gives alone; groups of two devices
  refused; the search through the CLI with ``--bo_report``, also when it
  dies midway.
"""

import dataclasses
import glob
import json

import numpy as np
import pytest
import torch

from disentangle_mlp_tpu.bo import driver as jax_driver
from disentangle_mlp_tpu.bo import gp as jax_gp
from disentangle_mlp_tpu.cli import bo as jax_cli_bo
from disentangle_mlp_tpu.config import Config as JaxConfig
from disentangle_mlp_tpu_torch.bo import driver, gp
from disentangle_mlp_tpu_torch.cli import bo as cli_bo
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.models.nvae import FLAGS as NVAE_FLAGS
from tests.test_torch_port_loop import TOY_FLAGS, _stats_npz, _toy_kwargs

RTOL = 1e-12


def _observations(seed, n):
    rng = np.random.default_rng(seed)
    betas = rng.choice(np.arange(1.0, 151.0), size=n, replace=False)
    return betas, rng.uniform(100.0, 160.0, size=n)


@pytest.mark.parametrize("noise_var", [0.0, 1e-6])
@pytest.mark.parametrize("seed, n", [(0, 2), (1, 5), (2, 9)])
def test_port_gp_posterior_and_ei_equal_jax(seed, n, noise_var):
    x, y = _observations(seed, n)
    grid = np.arange(1.0, 151.0)
    for ell, sigma_f in ((30.0, 50.0), (10.0, 5.0)):
        want = jax_gp.GaussianProcess(ell=ell, sigma_f=sigma_f,
                                      noise_var=noise_var).fit(x, y)
        got = gp.GaussianProcess(ell=ell, sigma_f=sigma_f,
                                 noise_var=noise_var).fit(x, y)
        for a, b in zip(got.predict(grid), want.predict(grid)):
            np.testing.assert_allclose(a, b, rtol=RTOL)
        np.testing.assert_allclose(
            gp.expected_improvement(got, grid, xi=0.05),
            jax_gp.expected_improvement(want, grid, xi=0.05), rtol=RTOL)
    np.testing.assert_allclose(gp.rbf_kernel(x, grid),
                               jax_gp.rbf_kernel(x, grid), rtol=RTOL)


def _toy_objective(beta):
    """A toy FID landscape with its minimum at β = 70."""
    return 100.0 + 0.01 * (beta - 70.0) ** 2 + 3.0 * np.sin(beta / 7.0)


def test_port_beta_search_proposals_equal_jax(tmp_path):
    searches = [mod.BetaSearch(objective=_toy_objective,
                               log_path=str(tmp_path / f"{i}.json")).seed()
                for i, mod in enumerate((driver, jax_driver))]
    results = [s.run(n_iterations=6) for s in searches]
    assert searches[0].betas == searches[1].betas
    assert len(set(searches[0].betas)) == 5 + 6
    np.testing.assert_allclose(searches[0].fids, searches[1].fids,
                               rtol=RTOL)
    assert results[0] == results[1]
    assert json.loads((tmp_path / "0.json").read_text()) == \
        json.loads((tmp_path / "1.json").read_text())


def test_port_propose_batch_and_grid_exhausted_equal_jax(capsys):
    got = driver.BetaSearch(objective=_toy_objective).seed()
    want = jax_driver.BetaSearch(objective=_toy_objective).seed()
    batch = got.propose_batch(3)
    assert batch == want.propose_batch(3)
    assert len(set(batch)) == 3 and batch[0] == got.propose()

    def small(mod, observed):
        return mod.BetaSearch(objective=lambda b: 100.0 - b, grid_lo=1.0,
                              grid_hi=4.0).seed(
            [(b, 100.0 + b) for b in observed])

    for mod in (driver, jax_driver):
        # every grid point observed: propose and propose_batch raise, run
        # stops and keeps the observations
        full = small(mod, [1.0, 2.0, 3.0, 4.0])
        with pytest.raises(mod.GridExhausted, match="all 4 grid points"):
            full.propose()
        with pytest.raises(mod.GridExhausted, match="no untried"):
            full.propose_batch(2)
        assert full.run(3) == {"best_beta": 1.0, "best_fid": 101.0}
    assert capsys.readouterr().out.count("[bo] stopping:") == 2
    # one point left: a partial batch of one, the same in both
    assert small(driver, [1.0, 2.0, 4.0]).propose_batch(3) == \
        small(jax_driver, [1.0, 2.0, 4.0]).propose_batch(3) == [3.0]
    assert issubclass(driver.GridExhausted, RuntimeError)


def test_port_run_parallel_persists_the_same_history(tmp_path):
    """One group of three fails: both packages observe the other two,
    persist them, then raise the failure."""
    def fail(beta):
        raise RuntimeError(f"group died at beta {beta}")

    for i, mod in enumerate((driver, jax_driver)):
        search = mod.BetaSearch(objective=None,
                                log_path=str(tmp_path / f"{i}.json")).seed()
        with pytest.raises(RuntimeError, match="group died"):
            search.run_parallel(2, [_toy_objective, fail, _toy_objective])
    got, want = (json.loads((tmp_path / f"{i}.json").read_text())
                 for i in range(2))
    assert got == want and len(got["betas"]) == 5 + 2


def test_port_cli_bo_posterior_only_writes_the_jax_json(tmp_path, capsys):
    outs = []
    for name, main in (("port", cli_bo.main), ("jax", jax_cli_bo.main)):
        out = tmp_path / f"{name}.json"
        main(["--name", name, "--bo_output", str(out),
              "--save_path", str(tmp_path / "%"),
              "--log_path", str(tmp_path / "%/log")])
        outs.append(json.loads(out.read_text()))
    got, want = outs
    assert set(got) == set(want)
    assert got["proposed_beta"] == want["proposed_beta"]
    assert got["beta"] == want["beta"]
    assert got["observations"] == want["observations"]
    for k in ("posterior_mean", "band_low", "band_high",
              "expected_improvement"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    printed = capsys.readouterr().out
    assert printed.count(f"EI proposes beta={want['proposed_beta']:.0f}") \
        == 2


@pytest.mark.parametrize("finalized", [True, False])
def test_port_beta_run_config_equals_jax(tmp_path, finalized):
    """A finalized base nests each β under <save_path>/<name>_beta<β>; a
    templated one templates its own tree: the same fields either way."""
    kw = _toy_kwargs(tmp_path, "bo_cfg", epochs=7)
    bases = [Config(**kw), JaxConfig(**kw)]
    if finalized:
        bases = [b.finalize() for b in bases]
    got, want = (mod.beta_run_config(base, 12.5, epochs=2)
                 for mod, base in zip((driver, jax_driver), bases))
    got_fields = dataclasses.asdict(got)
    # the port's Config adds NVAE's fields, at their defaults here
    for name in NVAE_FLAGS:
        assert got_fields.pop(name) == getattr(Config, name)
    assert got_fields == dataclasses.asdict(want)
    assert got.beta == 12.5 and got.epochs == 2
    root = (f"{tmp_path}/bo_cfg/bo_cfg_beta12.5" if finalized
            else f"{tmp_path}/bo_cfg_beta12.5")
    assert got.save_path == root and got.model_path == f"{root}/models"
    assert got.log_path == f"{root}/log"


def _base(tmp_path, name="bo"):
    return Config(**_toy_kwargs(tmp_path, name, synthetic_data=True,
                                synthetic_train_size=8, batch_size_train=4,
                                checkpoint_every=0,
                                fid_path_pretrained=_stats_npz(tmp_path))
                  ).finalize()


def _records(cfg, beta):
    (log_file,) = glob.glob(f"{cfg.save_path}/{cfg.name}_beta{beta:g}/log/"
                            f"log_*.json")
    with open(log_file) as f:
        return json.load(f)["output"]


def test_port_training_objective_trains_a_toy_vaegan_in_its_own_tree(
        tmp_path):
    cfg = _base(tmp_path)
    objective = driver.make_training_objective(cfg, epochs=1, device="cpu")
    assert objective.devices == [torch.device("cpu")]
    fid = objective(25.0)
    assert isinstance(fid, float) and np.isfinite(fid)
    (rec,) = _records(cfg, 25.0)
    assert rec["FID"] == fid and rec["Epoch"] == 0
    pngs = glob.glob(f"{cfg.save_path}/bo_beta25/fid_results/recons/*.png")
    assert len(pngs) == cfg.n_samples


def test_port_group_objectives_train_two_betas_concurrently(tmp_path):
    """Two one-device groups (both the CPU) train two βs on two threads;
    each run's log is exactly the one it writes alone."""
    cfg = _base(tmp_path, "together")
    cpu = torch.device("cpu")
    groups = driver.make_group_objectives(cfg, 2, epochs=1,
                                          devices=[cpu, cpu])
    assert [g.devices for g in groups] == [[cpu], [cpu]]
    search = driver.BetaSearch(objective=None).seed()
    batch = search.propose_batch(2)
    search.run_parallel(1, groups)
    assert search.betas[5:] == batch
    alone = _base(tmp_path, "alone")
    objective = driver.make_training_objective(alone, epochs=1, device=cpu)
    for beta, fid in zip(batch, search.fids[5:]):
        assert objective(beta) == fid
        assert _records(cfg, beta) == _records(alone, beta)


def test_port_group_objectives_refuse_what_they_cannot_run(tmp_path):
    cfg = Config(**_toy_kwargs(tmp_path, "g", batch_size_train=3))
    cpu = torch.device("cpu")
    # a group of two devices trains data-parallel: the batch must split
    (pair,) = driver.make_group_objectives(cfg, 1, devices=[cpu, cpu])
    assert pair.devices == [cpu, cpu]
    with pytest.raises(ValueError, match="must divide the explicit "
                                         "2-device group"):
        pair(25.0)
    for n in (0, 3):
        with pytest.raises(ValueError) as got:
            driver.make_group_objectives(cfg, n, devices=[cpu, cpu])
        with pytest.raises(ValueError) as want:
            jax_driver.make_group_objectives(JaxConfig(name="g"), n,
                                             devices=[cpu, cpu])
        assert str(got.value) == str(want.value)


def _cli_argv(tmp_path, *extra):
    return ["--name", "bo_cli", "--device", "cpu", "--posterior_only",
            "False", "--synthetic_data", "True", "--synthetic_train_size",
            "8", "--batch_size_train", "4", "--dtype", "float32",
            "--calc_fid", "True", "--n_samples", "8", "--checkpoint_every",
            "0", "--fid_path_pretrained", _stats_npz(tmp_path),
            "--save_path", str(tmp_path / "%"),
            "--log_path", str(tmp_path / "%/log"), *TOY_FLAGS, *extra]


def test_port_cli_bo_search_writes_report_and_history(tmp_path, capsys):
    report_path = tmp_path / "report.json"
    cli_bo.main(_cli_argv(tmp_path, "--bo_iterations", "2", "--bo_epochs",
                          "1", "--bo_report", str(report_path)))
    rep = json.loads(report_path.read_text())
    assert rep["mode"] == "sequential" and rep["devices"] == ["cpu"]
    assert rep["synthetic_data"] is True and rep["epochs_per_eval"] == 1
    betas = [c["beta"] for c in rep["cycles"]]
    assert len(betas) == 2 and len(set(betas)) == 2
    assert all(1.0 <= b <= 150.0 for b in betas)
    assert all(np.isfinite(c["fid"]) and c["train_fid_wall_s"] >= 0
               for c in rep["cycles"])
    history = json.loads((tmp_path / "bo_cli" / "bo_history.json")
                         .read_text())
    assert history["betas"][5:] == betas and len(history["fids"]) == 7
    assert rep["best_fid"] == min(history["fids"])
    assert "best: beta=" in capsys.readouterr().out
    # two groups on the one visible device: the JAX package's ValueError
    with pytest.raises(ValueError, match=r"must be in \[1, 1\]"):
        cli_bo.main(_cli_argv(tmp_path, "--bo_parallel", "2"))


def test_port_bo_report_written_when_search_dies_midway(tmp_path,
                                                        monkeypatch):
    """A failed evaluation late in the search keeps the report: the
    completed cycles, the best of them and the error, then re-raises."""
    def fake_make_objective(cfg, epochs, device):
        def objective(beta):
            if objective.n >= 2:
                raise RuntimeError("card died")
            objective.n += 1
            return 100.0 + float(beta)
        objective.n = 0
        return objective

    monkeypatch.setattr(cli_bo, "make_training_objective",
                        fake_make_objective)
    report_path = tmp_path / "BO_RUN.json"
    with pytest.raises(RuntimeError, match="card died"):
        cli_bo.main(_cli_argv(tmp_path, "--bo_iterations", "5",
                              "--bo_report", str(report_path)))
    rep = json.loads(report_path.read_text())
    assert rep["partial"] is True and "card died" in rep["error"]
    assert len(rep["cycles"]) == 2
    assert rep["best_fid"] == min(c["fid"] for c in rep["cycles"])
    assert rep["best_beta"] in [c["beta"] for c in rep["cycles"]]


def test_port_fid_state_shared_by_concurrent_runs_holds_under_stress():
    """Concurrent runs share the FID's TF32 switch and its worker pool:
    with more threads than cores and a short switch interval, TF32 stays
    off inside every thread's section, comes back after the last one, and
    every thread gets the one pool."""
    import os
    import sys
    import threading
    import time

    from disentangle_mlp_tpu_torch.eval import inception
    from disentangle_mlp_tpu_torch.train import loop

    n = max(16, 2 * (os.cpu_count() or 1))
    errors, pools = [], set()
    start = threading.Barrier(n)

    def work():
        start.wait(timeout=30)
        for _ in range(200):
            with inception._cudnn_tf32_off():
                time.sleep(0)  # let the other threads enter and leave
                if torch.backends.cudnn.allow_tf32:
                    errors.append("TF32 on inside a section")
            pools.add(id(loop._fid_pool()))

    saved = (sys.getswitchinterval(), torch.backends.cudnn.allow_tf32,
             loop._FID_POOL)
    torch.backends.cudnn.allow_tf32 = True
    loop._FID_POOL = None
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=work) for _ in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert errors == [] and len(pools) == 1
        assert torch.backends.cudnn.allow_tf32 is True
        assert inception._tf32_users == 0
    finally:
        sys.setswitchinterval(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
        if loop._FID_POOL is not None:
            loop._FID_POOL.shutdown()
        loop._FID_POOL = saved[2]
