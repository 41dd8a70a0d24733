"""The port's β=25 reproduction harness (disentangle_mlp_tpu_torch:
eval/reproduce.py, cli/reproduce.py) against the JAX package's, on the CPU
at toy width:

- ``_curve_shape`` and ``rescore`` give the same fields on the same logs,
  stale gates dropped, the same errors;
- ``assets_report`` has the JAX structure, with the assets missing and
  present;
- ``run_reproduction`` on synthetic data: with one Inception parameter
  tree carried into both packages, its reference statistics agree with
  the JAX package's to the pool3 tolerance carried through μ and Σ, its
  real-vs-real calibration FID to rtol 1e-3 (the score is dominated by
  traces and means, which move far less than single activations), and the
  report has the JAX report's keys, with β=25 trained 2 epochs with FID
  in the loop to a finite final FID and its curve fields; the CLI on the
  CPU, traced into ``--profile_dir``.
"""

import json
import os

import numpy as np
import pytest

from disentangle_mlp_tpu.cli import reproduce as jax_cli_reproduce
from disentangle_mlp_tpu.config import Config as JaxConfig
from disentangle_mlp_tpu.eval import fid as jax_fid
from disentangle_mlp_tpu.eval import inception as jax_inception
from disentangle_mlp_tpu.eval import reproduce as jax_reproduce
from disentangle_mlp_tpu_torch.cli import reproduce as cli_reproduce
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.eval import inception as port_inception
from disentangle_mlp_tpu_torch.eval import reproduce
from disentangle_mlp_tpu_torch.utils.image_io import write_png
from tests.test_torch_port_fid import share_inception
from tests.test_torch_port_loop import TOY_FLAGS

# pool3 activations of the two frameworks on one Inception tree
# (tests/test_torch_port_inception.py), carried through μ and Σ
POOL3 = {"rtol": 2e-3, "atol": 2e-4}
CALIB_RTOL = 1e-3

HEALTHY = [
    {"Epoch": 0, "Avg Eec Loss": 1138.0, "Avg Dnc Loss": 1138.0,
     "Avg Dis Loss": 0.003, "FID": 223.4},
    {"Epoch": 1, "Avg Eec Loss": 950.0, "Avg Dnc Loss": 950.0,
     "Avg Dis Loss": 0.003, "FID": 180.0},
    {"Epoch": 2, "Avg Eec Loss": 776.0, "Avg Dnc Loss": 776.0,
     "Avg Dis Loss": 0.003, "FID": 128.3},
]
COLLAPSED = [dict(r, **{"Avg Eec Loss": v, "FID": f}) for r, v, f in
             zip(HEALTHY, [5064.0, 4800.0, 4791.0], [252.0, 102.0, 275.5])]
NO_FID = [{"Epoch": 0, "Avg Eec Loss": 1138.0, "FID": "N/A"},
          {"Epoch": 1, "Avg Eec Loss": 776.0, "FID": "N/A"}]
STALE = {"target_fid": 128.34, "fid_curve": [223.4, 128.3],
         "curve_ok": True, "curve_ratio": 0.57, "fid_min": 128.3,
         "fid_min_epoch": 1, "curve_min_ok": True}


def _write_log(log_dir, name, records, mtime=None):
    log_dir.mkdir(exist_ok=True)
    path = log_dir / name
    path.write_text(json.dumps({"output": records}))
    if mtime is not None:
        os.utime(path, (mtime, mtime))


def test_port_curve_shape_equals_jax(tmp_path):
    """The newest log by mtime (not by the month-first name) is read, and
    both gates come out the same in both packages."""
    log_dir = tmp_path / "log"
    assert reproduce._curve_shape(str(log_dir)) == {} == \
        jax_reproduce._curve_shape(str(log_dir))
    _write_log(log_dir, "log_12_31_2025_00_00_00.json", HEALTHY, 1000)
    healthy = reproduce._curve_shape(str(log_dir))
    assert healthy == jax_reproduce._curve_shape(str(log_dir))
    assert healthy["curve_ok"] is True and healthy["eec_ok"] is True
    assert healthy["fid_curve"] == [223.4, 180.0, 128.3]
    _write_log(log_dir, "log_01_01_2026_00_00_00.json", COLLAPSED, 2000)
    collapsed = reproduce._curve_shape(str(log_dir))
    assert collapsed == jax_reproduce._curve_shape(str(log_dir))
    assert collapsed["eec_ok"] is False and collapsed["curve_ok"] is False
    assert collapsed["fid_min"] == 102.0 and collapsed["fid_min_epoch"] == 1
    _write_log(log_dir, "log_01_02_2026_00_00_00.json", NO_FID, 3000)
    no_fid = reproduce._curve_shape(str(log_dir))
    assert no_fid == jax_reproduce._curve_shape(str(log_dir))
    assert "fid_curve" not in no_fid and no_fid["eec_ok"] is True


def test_port_rescore_equals_jax_and_drops_stale_gates(tmp_path, capsys):
    log_dir = tmp_path / "log"
    _write_log(log_dir, "log_08_18_2026_00_00_00.json", NO_FID)
    merged = []
    for name, mod in (("port", reproduce), ("jax", jax_reproduce)):
        report = tmp_path / f"{name}.json"
        report.write_text(json.dumps(STALE))
        merged.append(mod.rescore(str(log_dir), str(report)))
        assert json.loads(report.read_text()) == merged[-1]
    assert merged[0] == merged[1]
    assert merged[0]["target_fid"] == 128.34 and merged[0]["eec_ok"] is True
    for stale in ("fid_curve", "curve_ok", "curve_ratio", "fid_min",
                  "fid_min_epoch", "curve_min_ok"):
        assert stale not in merged[0], stale
    # through the CLI, into a report that does not exist yet
    fresh = tmp_path / "fresh.json"
    _write_log(log_dir, "log_08_18_2026_00_00_01.json", HEALTHY,
               os.stat(log_dir / "log_08_18_2026_00_00_00.json").st_mtime
               + 10)
    cli_reproduce.main(["--name", "rescore", "--rescore_log", str(log_dir),
                        "--report_out", str(fresh)])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(fresh.read_text()) == \
        jax_reproduce.rescore(str(log_dir))
    assert printed["curve_ok"] is True
    # the errors, the same in both
    empty = tmp_path / "empty"
    _write_log(empty, "log_08_18_2026_00_00_00.json",
               [{"Epoch": 0, "Avg Eec Loss": 100.0, "FID": "N/A"}])
    for mod in (reproduce, jax_reproduce):
        with pytest.raises(FileNotFoundError, match="--rescore_log"):
            mod.rescore(str(tmp_path / "no_such_dir"))
        with pytest.raises(ValueError, match="fewer than 2"):
            mod.rescore(str(empty))


def _keys(tree):
    """Nested key structure of a report."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__


@pytest.mark.parametrize("present", [False, True])
def test_port_assets_report_has_the_jax_structure(tmp_path, monkeypatch,
                                                  capsys, present):
    """--assets_check prints the same report as the JAX package's, with
    the assets missing and with an image tree and a weights file present
    (a stand-in file: its digest is reported, and not the expected one);
    no run directory is made."""
    flags = ["--name", "ac", "--assets_check",
             "--save_path", str(tmp_path / "%"),
             "--log_path", str(tmp_path / "%/log")]
    if present:
        for split in ("train", "val", "test"):
            d = tmp_path / "celebA" / split / "all"
            d.mkdir(parents=True)
            write_png(str(d / "0.png"), np.zeros((8, 8, 3), np.uint8))
            flags += [f"--image_root_{split}", str(tmp_path / "celebA" /
                                                   split)]
        weights = tmp_path / "pt_inception.pth"
        weights.write_bytes(b"not the real weights")
        search = (str(weights),)
    else:
        search = (str(tmp_path / "missing.pth"),)
    monkeypatch.setattr(port_inception, "WEIGHT_SEARCH_PATHS", search)
    monkeypatch.setattr(jax_inception, "WEIGHT_SEARCH_PATHS", search)
    cli_reproduce.main(flags)
    got = json.loads(capsys.readouterr().out)
    jax_cli_reproduce.main(flags)
    want = json.loads(capsys.readouterr().out)
    assert got == want
    assert _keys(got) == _keys(jax_cli_reproduce.assets_report(
        JaxConfig(name="ac").finalize(make_dirs=False)))
    assert got["ready"] is present
    assert got["inception_weights"]["ready"] is present
    assert all(v["ready"] is present and v["n_images"] == int(present)
               for v in got["celeba_images"].values())
    if present:
        assert got["inception_weights"]["sha256_ok"] is False
    assert not (tmp_path / "ac").exists()


def _repro_kwargs(tmp_path, name, **kw):
    base = dict(name=name, beta=25.0, epochs=2, synthetic_data=True,
                synthetic_train_size=32, batch_size_train=16,
                batch_size_val=16, batch_size_test=4, n_samples=8,
                n_hidden=8, img_size=32, n_z=[8, 4, 4],
                representation_size=4, head_width=32,
                decoder_channels=[8, 8, 8], disc_channels=[4, 8, 8, 8],
                disc_feature_dim=32, dtype="float32", calc_fid=True,
                checkpoint_every=0, save_path=str(tmp_path / "%"),
                log_path=str(tmp_path / "%/log"))
    base.update(kw)
    return base


@pytest.fixture
def inception_shared(monkeypatch):
    """One Inception tree in both packages (tests/test_torch_port_fid.py)."""
    share_inception(monkeypatch)
    yield
    monkeypatch.undo()
    jax_fid._jitted_features_cached.cache_clear()


def test_port_run_reproduction_on_synthetic_data_matches_jax(
        tmp_path, inception_shared, capsys):
    """The port's full run (statistics, calibration, β=25 for 2 epochs
    with FID in the loop, the verdict) against the JAX package's run with
    training skipped, one Inception tree in both: the statistics and the
    calibration agree, and the port's report has the JAX report's keys
    (its fields without training, the training's, and what its
    _curve_shape reads from the port's log)."""
    reports = {}
    for name, mod, make in (("port", reproduce, Config),
                            ("jax", jax_reproduce, JaxConfig)):
        cfg = make(**_repro_kwargs(tmp_path, name)).finalize()
        port = mod is reproduce
        reports[name] = mod.run_reproduction(
            cfg, str(tmp_path / f"{name}.npz"), stats_images=32,
            calib_images=32, skip_train=not port,
            report_out=str(tmp_path / f"{name}.json"),
            **({"device": "cpu"} if port else {}))
    got, want = reports["port"], reports["jax"]
    with np.load(tmp_path / "port.npz") as p, \
            np.load(tmp_path / "jax.npz") as j:
        np.testing.assert_allclose(p["mu"], j["mu"], **POOL3)
        np.testing.assert_allclose(p["sigma"], j["sigma"], **POOL3)
    np.testing.assert_allclose(got["calibration_fid"],
                               want["calibration_fid"], rtol=CALIB_RTOL)
    for k in ("stats_images", "calibration_images", "synthetic_data",
              "synthetic_basis_sigma", "inception_pretrained", "target_fid",
              "tolerance", "calibration_target"):
        assert got[k] == want[k], k
    assert got["synthetic_basis_sigma"] == 3.0
    trained = {"final_fid", "images_per_sec", "within_tolerance"}
    curve = jax_reproduce._curve_shape(str(tmp_path / "port" / "log"))
    assert set(got) == set(want) | trained | set(curve)
    assert {k: got[k] for k in curve} == curve
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads(json.dumps(got))
    assert isinstance(got["final_fid"], float)
    assert np.isfinite(got["final_fid"])
    assert got["inception_pretrained"] is False
    assert got["within_tolerance"] is False
    assert len(got["fid_curve"]) == len(got["eec_curve"]) == 2
    assert got["fid_curve"][-1] == got["final_fid"]
    assert capsys.readouterr().out.count("====> Epoch:") == 2


def test_port_reproduce_cli_runs_on_the_cpu_and_traces(tmp_path, capsys):
    """--device cpu with --skip_train and --profile_dir: the statistics
    and the calibration, the report, and the run's torch.profiler trace."""
    stats, report_path = tmp_path / "stats.npz", tmp_path / "report.json"
    profile = tmp_path / "trace"
    report = cli_reproduce.main([
        "--name", "repro", "--device", "cpu", "--synthetic_data", "True",
        "--synthetic_train_size", "32", "--batch_size_train", "16",
        "--batch_size_val", "16", "--img_size", "32", "--skip_train",
        "--stats_out", str(stats), "--stats_images", "32",
        "--calib_images", "32", "--report_out", str(report_path),
        "--profile_dir", str(profile),
        "--save_path", str(tmp_path / "%"),
        "--log_path", str(tmp_path / "%/log")])
    assert stats.is_file() and np.isfinite(report["calibration_fid"])
    assert "final_fid" not in report
    assert json.loads(report_path.read_text())["stats_images"] == 32
    (trace,) = profile.glob("trace_*.json")
    assert "aten::" in trace.read_text()
    assert f"[profile] trace written to {trace}" in capsys.readouterr().out
