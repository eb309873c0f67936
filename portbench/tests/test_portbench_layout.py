"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file the harness finds by it."""

import json
import os
import re

import pytest

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = core.benchmark()


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_the_contract_keys_and_names(kind, keys):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ({"why", "layer", "source"} & keys) - (
                {"source"} if kind != "configs" else set()):
            assert one_line(e[key]), (e["name"], key)

def test_every_name_finds_its_file():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        assert core.load_json(os.path.join(core.ROOT, c["file"]))["name"] \
            == c["name"]
    for w in BENCH["workloads"]:
        cell = core.Cell(w["name"], BENCH)
        assert core.load_module("drivers", cell.wl["driver"]).Driver
        assert set(cell.wl["limits"]) and cell.wl["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert callable(core.END_TO_END[m["name"]])
    for m in BENCH["per_layer"]:
        mod = core.load_module("metrics", m["name"])
        assert callable(mod.read)
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == \
            (m["layer"], m["unit"], m["moves"])


def test_bounds_sources_and_what_each_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        reporting = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(reporting)
    for name in cells:
        cell = core.Cell(name, BENCH)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(cells) // 4)


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_a_config_differs_from_its_source_only_where_reduced_says(entry):
    cfg = core.load_json(os.path.join(core.ROOT, entry["file"]))
    assert cfg["reduced"] == entry["reduced"]
    src = core.load_json(os.path.join(core.ROOT, "configs",
                                      entry["name"] + ".json"))
    changed = sorted(k for k in src if cfg.get(k, KeyError) != src[k])
    assert changed == sorted(entry["reduced"])
    for group in entry["reduced"]:  # a changed group keeps its widths
        if isinstance(src[group], dict):
            assert {k: v for k, v in cfg[group].items() if k != "method"} \
                == {k: v for k, v in src[group].items() if k != "method"}


def test_pairs_of_config_and_traffic_are_unique_and_configs_used():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in BENCH["configs"]} == {p[0] for p in pairs}


def test_a_cell_whose_workload_file_disagrees_is_refused(tmp_path,
                                                         monkeypatch):
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["chips"] = 4
    with pytest.raises(ValueError, match="chips"):
        core.Cell(bench["workloads"][0]["name"], bench)
