"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by that name."""

import json
import re

import pytest

from benchmark.harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
PENDING = sorted(p.stem for p in (spec.BENCH / "pending").glob("*.json"))


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\t" not in m["layer"]


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_four_card_cells_are_at_most_one():
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", CELLS + PENDING)
def test_every_name_resolves(cell):
    c = spec.Cell(cell, spec.with_pending(BENCH, cell) if cell in PENDING
                  else BENCH)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["driver"] in ("adam", "lbfgs")
    assert callable(c.driver().run)
    assert callable(c.driver().controls)
    ref = c.reference()
    for fn in ("features", "lift", "bubble", "residual"):
        assert callable(getattr(ref, fn))
    for name, reader in c.readers().items():
        assert callable(reader.read), name
    assert (spec.BENCH / "limits" / f"{cell}.json").exists()


@pytest.mark.parametrize("cell", CELLS + PENDING)
def test_each_cell_reports_what_it_must(cell):
    c = spec.Cell(cell, spec.with_pending(BENCH, cell) if cell in PENDING
                  else BENCH)
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], cell)


# keys of the recipe that a traffic file sets for its cell
RECIPE_KEYS = {"n_col", "n_band", "n_adaptive", "n_bd", "adam_epochs",
               "log_every"}


def test_configs_files():
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        # every key of the recipe that a cell's traffic sets is listed
        set_by = set()
        for w in BENCH["workloads"]:
            if w["config"] == c["name"]:
                set_by |= RECIPE_KEYS & set(spec.Cell(w["name"], BENCH)
                                            .traffic)
        assert cfg["reduced"] == c["reduced"]
        assert set(c["reduced"]) == set_by, c["name"]
        for key in c["reduced"]:
            assert NAME.match(key)
            # the configuration file says what each was set to, and why
            assert any(key in a.split(":")[0].split(", ")
                       for a in cfg["assumed"]), key
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_full_check_fits():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
