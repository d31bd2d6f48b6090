"""The manifest, the files it names, the result line, and the rules on
names, units and imports."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from stereobench import harness
from stereobench.tests import tiny

BENCH = Path(harness.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def manifest():
    return harness.load_manifest()


@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_every_cell_resolves_its_files_by_name(workload):
    cell = harness.resolve(tiny.manifest(), workload)
    assert cell.config["name"] == workload.split(".")[0]
    assert harness.loop(cell).run
    for metric in cell.per_layer:
        assert callable(harness.reader(metric["name"]))
    if workload in {w["name"] for w in manifest()["workloads"]}:
        assert {"setup_s"} < {e["name"] for e in cell.end_to_end}
        assert cell.per_layer


def test_every_metric_has_its_reader():
    for metric in manifest()["per_layer"]:
        assert callable(harness.reader(metric["name"]))


def test_a_new_cell_needs_only_new_files(tmp_path):
    home = tmp_path / "bench"
    for sub in ("traffic", "limits"):
        shutil.copytree(BENCH / sub, home / sub)
    mix = json.loads((home / "traffic" / "stream.json").read_text())
    mix["inflight"] = 2
    (home / "traffic" / "stream2.json").write_text(json.dumps(mix))
    shutil.copy(home / "limits" / "kitti2015.stream.json",
                home / "limits" / "kitti2015.stream2.json")
    m = manifest()
    m["workloads"].append({"name": "kitti2015.stream2", "config": "kitti2015",
                           "traffic": "stream2", "chips": 1, "why": "x"})
    cell = harness.resolve(m, "kitti2015.stream2", home=home)
    assert cell.traffic["inflight"] == 2
    assert harness.loop(cell).__name__ == "stereobench.loops.stream"


def test_names_units_and_lengths_keep_the_rules():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((BENCH.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(m["paths"][0] + "/")
        names.append(c["name"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"])
        assert NAME.match(w["traffic"]) and w["config"] in names
        names.append(w["name"])
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        names.append(e["name"])
        if "layer" in e:
            assert LINE.match(e["layer"])
            moved = next(x for x in m["end_to_end"] if x["name"] == e["moves"])
            assert set(e["workloads"]) <= set(moved.get(
                "workloads", tiny.WORKLOADS))
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_a_tiny_run_prints_the_result_line(workload, trace, capsys):
    result = tiny.execute(workload, trace=trace)
    harness.emit(result)
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["checks"]
    assert line["correct"] is True, line["checks"]
    cell = tiny.cell(workload)
    if not trace:
        assert set(line["metrics"]) == {e["name"] for e in cell.end_to_end}
    assert set(line["metrics"]) <= {e["name"] for e in cell.end_to_end
                                    + cell.per_layer}
    last = out.err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") for s in last)


def imported_top_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        names = set(imported_top_names(path))
        assert not names & set(harness.FORBIDDEN), path


def test_nothing_reads_the_tpu_records():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for record in ("BASELINE.json", "BENCH_r", "MULTICHIP_r",
                       "bench.py"):
            assert record not in text, (path, record)


def test_without_a_card_it_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "kitti2015.stream", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=BENCH.parent,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_check_that_reads_nan_prints_null(capsys):
    result = {"correct": False, "attempted": 1, "failed": 0, "metrics": {},
              "device": {}, "checks": {"soft_gap": {"value": float("nan"),
                                                    "limit": 0.03}}}
    harness.emit(result)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["checks"]["soft_gap"] == {"value": None, "limit": 0.03}
