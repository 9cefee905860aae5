"""BENCHMARK.json against the contract's shapes, and the harness finding
cells, configurations, traffic and metric readers by name."""
import json
import os
import re
import shutil

import pytest

from radbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = lambda s: isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["radbench"]
    assert all(LINE(w) for w in manifest["command"]) and len(manifest["command"]) <= 32
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in manifest["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert LINE(c["source"]) and LINE(c["why"])
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and LINE(w["why"])
    for kind in ("configs", "workloads"):
        got = [n for g, n in names if g == kind]
        assert len(got) == len(set(got))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_entry_keys(manifest):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
    }
    for group, keys in allowed.items():
        for e in manifest[group]:
            assert set(e) <= keys, (group, set(e) - keys)
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])


@pytest.mark.parametrize("group", ["configs", "workloads"])
def test_every_file_found_by_name(manifest, group):
    for e in manifest[group]:
        if group == "configs":
            assert e["file"] == f"radbench/configs/{e['name']}.json"
            with open(os.path.join(ROOT, e["file"])) as f:
                cfg = json.load(f)
            assert cfg["name"] == e["name"] and cfg["reduced"] == e["reduced"]
            for key in ("lw_net", "sw_net"):
                assert cfg[key].startswith("radbench/") and os.path.exists(
                    os.path.join(ROOT, cfg[key]))
        else:
            cell, config, workload, _ = harness.find_cell(e["name"])
            assert workload["name"] == e["name"] and workload["traffic"] == e["traffic"]
            assert config["name"] == e["config"]
            assert set(workload["limits"]) == set(harness.entry_module(config).Cell.CHECKS)
            assert e["chips"] == 1


def test_per_layer_metrics_move_a_metric_each_cell_reports(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and LINE(m["layer"])
        assert m["moves"] == "columns_per_s"
        # without a list, every cell, those added later too, reports it
        listed = m.get("workloads", sorted(cells))
        assert set(listed) <= cells
        for cell in listed:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        assert os.path.exists(os.path.join(ROOT, "radbench", "metrics", f"{m['name']}.py"))
        assert callable(harness.metric_reader(m["name"]))


def test_a_new_cell_is_found_by_adding_files_alone(tmp_path, manifest):
    """A copy of the benchmark with one more cell: an entry in BENCHMARK.json
    and a workload file, nothing else edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "radbench"), root / "radbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = {"name": "rfmip-clearsky.c3600", "config": "rfmip-clearsky", "traffic": "c3600",
           "chips": 1, "why": "3600 columns a call"}
    (root / "BENCHMARK.json").write_text(json.dumps(
        {**manifest, "workloads": manifest["workloads"] + [new]}))
    with open(os.path.join(ROOT, "radbench", "workloads", "rfmip-clearsky.c1800.json")) as f:
        w = json.load(f)
    w.update(name=new["name"], traffic="c3600", sites=200)
    (root / "radbench" / "workloads" / "rfmip-clearsky.c3600.json").write_text(json.dumps(w))
    cell, config, workload, _ = harness.find_cell(new["name"], str(root))
    assert cell == new and config["entry"] == "rfmip" and workload["sites"] == 200
