"""BENCHMARK.json and the files it names: the contract's shapes, and the
harness finding every configuration, traffic mix, limit and metric by name."""
import json
import re

import pytest

from bench import core

MAN = core.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert core.MANIFEST.stat().st_size <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert 1 <= len(MAN["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_text():
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for g in groups:
        names = [e["name"] for e in MAN[g]]
        assert len(names) == len(set(names)), g
        assert all(NAME.match(n) for n in names), g
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in MAN["configs"] + MAN["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for c in MAN["configs"]:
        assert 1 <= len(c["source"]) <= 200 and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in MAN["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_sources_and_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


def test_cells_and_chips():
    cells = MAN["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(len(cells) // 4, 1)
    used = {w["config"] for w in cells}
    assert used == {c["name"] for c in MAN["configs"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in core.metrics_of(MAN, w["name"], trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert core.metrics_of(MAN, w["name"], trace=True), w["name"]


def test_moves_is_reported_where_the_metric_is():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = [w["name"] for w in MAN["workloads"]]
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in target.get("workloads", cells), (m["name"], cell)


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in MAN["per_layer"]}
    # metrics of one layer give its name letter for letter: no two names
    # that differ only in case or spacing
    canon = {re.sub(r"\s+", " ", x.lower()) for x in layers}
    assert len(canon) == len(layers)


def test_config_files_hold_the_run_configuration():
    for c in MAN["configs"]:
        assert c["file"].startswith("bench/")
        cfg = core.config(MAN, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert "source" in cfg and "assumed" in cfg
    ds = core.config(MAN, "deepseek-67b-l24")
    assert ds["published"] == {"num_hidden_layers": 95} and ds["num_hidden_layers"] == 24
    assert (ds["hidden_size"], ds["intermediate_size"], ds["num_attention_heads"],
            ds["num_key_value_heads"], ds["vocab_size"]) == (8192, 22016, 64, 8, 102400)


def test_harness_finds_everything_by_name():
    for w in MAN["workloads"]:
        t = core.traffic(w["traffic"])
        assert callable(core.driver(t["driver"]).run)
        assert core.limits(w["name"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(core.metric_reader(m["name"]))
    with pytest.raises(KeyError):
        core.cell(MAN, "no-such-cell")


def test_check_budget_fits():
    # 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s a cell to
    # compile, 1200 s spare, all inside 43200 s, at the full 24 cells
    rs = MAN["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_manifest_is_plain_json():
    json.loads(core.MANIFEST.read_text())
