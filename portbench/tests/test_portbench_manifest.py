"""BENCHMARK.json against the benchmark's contract: its keys, the
characters of names and units, every file it names under ``portbench/``,
the bounds, each per-layer metric reported where its end-to-end metric
is, and a configuration file that is the program's configuration."""

import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_runs_fit_the_check_with_every_cell():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_text(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_metrics_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in SOURCES
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _reported(name):
    return {m["name"] for m in BENCH["end_to_end"]
            if "workloads" not in m or name in m["workloads"]}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert w["chips"] == 1
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
    assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").exists()
    reported = _reported(w["name"])
    assert "setup_s" in reported and len(reported) >= 2
    layer = [m for m in BENCH["per_layer"]
             if w["name"] in m.get("workloads", [])]
    assert layer


def test_per_layer_metrics_move_what_their_cells_report():
    for m in BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for w in m["workloads"]:
            assert m["moves"] in _reported(w), (m["name"], w)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_pairs_appear_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_programs_configuration(c):
    from harness import manifest
    path = ROOT / c["file"]
    assert path.parts[len(ROOT.parts)] == "portbench"
    cfg = json.loads(path.read_text())
    assert c["reduced"] == []
    port = manifest.port_config(cfg)
    import dataclasses
    published = dataclasses.asdict(
        __import__("vae_gan_mark_tpu_torch.config", fromlist=["VARIANTS"])
        .VARIANTS[cfg["variant"]])
    for key, value in dataclasses.asdict(port).items():
        if isinstance(value, tuple):
            value = list(value)
        assert cfg[key] == value, key
        assert published[key] == (tuple(value) if isinstance(value, list)
                                  else value), key
    assert "assumed" in cfg
    assert c["source"] == cfg["source"]


def test_limits_files_hold_numbers_with_readings():
    for w in BENCH["workloads"]:
        limits = json.loads((ROOT / "portbench" / "limits"
                             / f"{w['name']}.json").read_text())
        numbers = {k: v for k, v in limits.items() if not k.startswith("_")}
        assert numbers
        # An exact comparison (a count that must be nought) has limit 0.
        assert all(isinstance(v, (int, float)) and math.isfinite(v)
                   and v >= 0 for v in numbers.values())
