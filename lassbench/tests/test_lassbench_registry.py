"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration, traffic mix and per-layer metric resolves by name; a new
one is new files and new entries only."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from lassbench.harness import PKG, ROOT, Bench, reader

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
PENDING = sorted(f[:-len(".json")] for f in os.listdir(
    os.path.join(PKG, "pending")) if f.endswith(".json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["lassbench"]
    assert 1 <= len(SPEC["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = 24  # the budget holds at the most cells later PRs may add
    total = (2 + 14 * cells) * (SPEC["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert total <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"),
                          entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    assert len(set(names)) == len(names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_and_configs():
    configs = {c["name"]: c for c in SPEC["configs"]}
    used = set()
    pairs = set()
    four = 0
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("lassbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16


@pytest.mark.parametrize("workload", PENDING)
def test_pending_cell_keeps_to_the_contract(workload):
    """A cell kept out of BENCHMARK.json has entries that could be added to
    it as they stand: new names, known configuration and traffic."""
    extra = json.load(open(os.path.join(PKG, "pending", workload + ".json")))
    cell = extra["workload"]
    assert cell["name"] == workload
    assert workload not in {w["name"] for w in SPEC["workloads"]}
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    assert os.path.exists(os.path.join(PKG, "traffic",
                                       cell["traffic"] + ".json"))
    taken = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    moves = {m["name"] for m in extra["end_to_end"]}
    for m in extra["end_to_end"] + extra["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in taken
        assert UNIT.match(m["unit"]) and m["source"] in SOURCES
        assert m["workloads"] == [workload]
    for m in extra["per_layer"]:
        assert m["moves"] in moves


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]]
                         + PENDING)
def test_cell_resolves_by_name(workload):
    bench = Bench.load(workload)
    assert callable(bench.runner().run)
    names = {m["name"] for m in bench.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert bench.per_layer
    for m in bench.per_layer:
        assert callable(reader(m["name"]).read)
    assert bench.limits, "every cell has its limits for correct"


def test_a_new_cell_is_new_files_only(tmp_path):
    """A copy of the benchmark gains a traffic mix, a metric and a cell by
    new files and new entries alone, and the harness finds all three."""
    shutil.copytree(PKG, tmp_path / "lassbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    tr = json.load(open(os.path.join(PKG, "traffic", "sep_text_b16.json")))
    tr["batch"] = 8
    (tmp_path / "lassbench" / "traffic" / "sep_text_b8.json").write_text(
        json.dumps(tr))
    (tmp_path / "lassbench" / "metrics" / "new_metric.py").write_text(
        "def read(run, name):\n    return 1.0\n")
    (tmp_path / "lassbench" / "limits" / "sep_text_b8.json").write_text(
        json.dumps({"wave_rel_err": 1.0}))
    spec["workloads"].append({"name": "sep_text_b8", "config":
                              "resunet30_text", "traffic": "sep_text_b8",
                              "chips": 1, "why": "a smaller batch"})
    spec["per_layer"].append({"name": "new_metric.x", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "separator",
                              "moves": "sep_clips_per_s",
                              "workloads": ["sep_text_b8"]})
    for m in spec["end_to_end"]:
        if "sep_text_b16" in m.get("workloads", []):
            m["workloads"].append("sep_text_b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("from lassbench.harness import Bench, reader\n"
            "b = Bench.load('sep_text_b8')\n"
            "assert b.traffic['batch'] == 8, b.traffic\n"
            "assert b.runner().__name__ == 'lassbench.runners.separate'\n"
            "names = [m['name'] for m in b.per_layer]\n"
            "assert 'new_metric.x' in names, names\n"
            "assert reader('new_metric.x').read(None, 'new_metric.x') == 1.0\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_runs_nowhere_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, a run
    prints no result and exits non-zero."""
    shutil.copytree(PKG, tmp_path / "lassbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "lassbench.run", "--workload", "sep_text_b16",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
