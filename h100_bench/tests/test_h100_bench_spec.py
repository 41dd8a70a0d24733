"""The harness finds every configuration, cell and metric by name, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re

import pytest

from bench_toy import BENCH, REPO

BENCHMARK = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["h100_bench"]
    assert BENCHMARK["command"] == ["python3", "h100_bench/run.py"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCHMARK[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
    assert len(set(names)) == len(names)
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCHMARK["end_to_end"])
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_every_file_under_paths_is_named_from_name_characters():
    for p in BENCH.rglob("*"):
        rel = p.relative_to(REPO).as_posix()
        if "__pycache__" in rel or rel.startswith("h100_bench/_jpeg_tree"):
            continue
        for part in rel.split("/"):
            assert NAME.match(part), rel


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_cell_files_load_by_name(cell):
    import harness

    spec = harness.Spec(cell)
    assert spec.entry["chips"] == 1
    assert spec.cell["config"] == spec.entry["config"]
    assert spec.cell["traffic"] == spec.entry["traffic"]
    assert cell == f"{spec.entry['config']}.{spec.entry['traffic']}"
    metric = "|".join(re.escape(k) for k in spec.reference.METRICS)
    number = re.compile(rf"^(feed|feed_mean|nonfinite_steps"
                        rf"|loss[1-3]?\.({metric})"
                        rf"|(grad|change|stats|stats1)(_median)?"
                        rf"|grad\.\w+)$")
    assert spec.cell["limits"]
    for k in spec.cell["limits"]:
        assert number.match(k), k
    assert hasattr(spec.adapter(), "EXPERIMENT")
    for m in spec.per_layer():
        assert callable(spec.reader(m["name"]).read)
    for key in ("trace_steps", "window_checks", "feed"):
        assert key in spec.cell


@pytest.mark.parametrize("config", BENCHMARK["configs"],
                         ids=lambda c: c["name"])
def test_config_files(config):
    cfg = json.loads((REPO / config["file"]).read_text())
    assert config["file"].startswith("h100_bench/configs/")
    assert cfg["source"] == config["source"]
    assert set(config["reduced"]) <= set(cfg["reduced"])
    assert (BENCH / "reference" / f"{cfg['experiment']}.py").is_file()
    assert (BENCH / "experiments" / f"{cfg['experiment']}.py").is_file()


def test_a_cell_on_more_chips_is_refused():
    import harness

    bench = json.loads(json.dumps(BENCHMARK))
    bench["workloads"][0]["chips"] = 4
    with pytest.raises(ValueError, match="one device"):
        harness.Spec(bench["workloads"][0]["name"], bench)


def test_a_metric_with_workloads_is_read_in_those_cells_alone():
    import harness

    listed = {m["name"]: set(m["workloads"]) for m in BENCHMARK["per_layer"]
              if "workloads" in m}
    assert listed == {"feed_wait_ms": {"betavaegan_celeba64.jpeg_nocache"}}
    for w in BENCHMARK["workloads"]:
        names = {m["name"] for m in harness.Spec(w["name"]).per_layer()}
        assert ("feed_wait_ms" in names) == (w["name"] in
                                             listed["feed_wait_ms"])
