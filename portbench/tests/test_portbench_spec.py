"""BENCHMARK.json against the benchmark contract's shape, and every name in
it resolved to its files; a cell added as files alone is found."""

import json
import re
import shutil

import pytest

from conftest import ROOT, with_held
from portbench.core.spec import Bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for path in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and ".." not in path
        assert not path.startswith("/") and not path.endswith("_torch")
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    # a full check of 24 cells fits its 43 200 s
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(SPEC["configs"]) <= 24
    assert sum(c["chips"] == 4 for c in SPEC["workloads"]) <= max(1, cells // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_the_contract_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(
        SPEC["workloads"])


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    bench = Bench(ROOT)
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = bench.per_layer(w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)
    for m in SPEC["per_layer"]:
        assert m["workloads"]       # a per-layer metric lists the cells that report it
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in bench.end_to_end(cell)}


def test_a_variant_of_a_metric_is_read_by_its_base_reader():
    bench = Bench(ROOT)
    assert bench.reader("device_idle_pct.sharded") is bench.reader("device_idle_pct")
    assert bench.reader("throughput.roundtrip").__file__.endswith("metrics/throughput.py")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_to_its_files(cell):
    bench = Bench(ROOT)
    w = bench.cell(cell)
    cfg = bench.config(w["config"])
    assert cfg["name"] == w["config"]
    traffic = bench.traffic(w["traffic"])
    entry = bench.module("entries", traffic["entry"])
    assert hasattr(entry, "Entry") and hasattr(entry, "verdict")
    bench.module("references", entry.REFERENCE)
    assert traffic["limits"]
    for m in bench.end_to_end(cell) + bench.per_layer(cell):
        assert callable(bench.reader(m["name"]).read)


def test_every_metric_and_roofline_stage_has_its_file():
    bench = Bench(ROOT)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        bench.reader(m["name"])
        if m["name"].endswith("_roofline"):
            bench.module("stages", m["name"][:-len("_roofline")])


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A later change adds a configuration, a traffic mix and a cell by
    adding files and entries; nothing under portbench/ is edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_traces", "__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((ROOT / "portbench/configs/chain48k.json").read_text())
    cfg.update(name="chain16k", sampling_rate=16000.0, samples=160000)
    (tmp_path / "portbench/configs/chain16k.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "portbench/traffic/power_high.json").read_text())
    traffic["precision"] = "highest"
    (tmp_path / "portbench/traffic/power_highest.json").write_text(json.dumps(traffic))
    spec["configs"].append({"name": "chain16k", "source": "https://example.org/x",
                            "file": "portbench/configs/chain16k.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "chain16k.power_highest", "config": "chain16k",
                              "traffic": "power_highest", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "chain48k.power_high" in m.get("workloads", []):
            m["workloads"].append("chain16k.power_highest")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tmp_path)
    assert bench.config(bench.cell("chain16k.power_highest")["config"])["samples"] == 160000
    assert bench.traffic("power_highest")["precision"] == "highest"
    assert bench.module("entries", "chain_power").__file__.startswith(str(tmp_path))
    assert {m["name"] for m in bench.per_layer("chain16k.power_highest")} == {
        m["name"] for m in bench.per_layer("chain48k.power_high")}
    with pytest.raises(KeyError):
        bench.cell("chain16k.nothing")


def test_a_held_cell_added_back_resolves_to_its_files(tmp_path):
    """A cell held out of BENCHMARK.json (portbench/held/) comes back as
    entries alone: its names are new and each resolves to its files."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_traces", "__pycache__"))
    spec = with_held(SPEC)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tmp_path)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names))
    held = [w["name"] for w in spec["workloads"][len(SPEC["workloads"]):]]
    assert held and sum(w["chips"] == 4 for w in spec["workloads"]) <= max(
        1, len(spec["workloads"]) // 4)
    for cell in held:
        w = bench.cell(cell)
        bench.config(w["config"])
        entry = bench.module("entries", bench.traffic(w["traffic"])["entry"])
        bench.module("references", entry.REFERENCE)
        e2e = {m["name"] for m in bench.end_to_end(cell)}
        assert "setup_s" in e2e and len(e2e) >= 2 and bench.per_layer(cell)
        for m in bench.end_to_end(cell) + bench.per_layer(cell):
            assert callable(bench.reader(m["name"]).read)
            assert m.get("moves", "setup_s") in e2e | {"setup_s"}
