"""BENCHMARK.json against the contract, its files found by name, the runner
without a card, and the imports of everything under port_bench/."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = sorted((ROOT / "port_bench").rglob("*.py"))


def test_keys_and_counts():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and BENCH["command"][1] == "port_bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_names_units_and_lines():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    texts = [w["why"] for w in BENCH["workloads"] + BENCH["configs"]]
    texts += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_workload_resolves_to_its_files(name):
    entry, cell, config, metrics = harness.resolve(name)
    assert (ROOT / "port_bench" / "drivers" / f"{cell['driver']}.py").is_file()
    assert cell["chips"] == entry["chips"] and cell["why"] == entry["why"]
    assert config["hidden"] == 4 * config["n_in"] and config["reduced"] == []
    assert config["n_in"] == 2 * config["nvariables"] + 2
    assert {m["name"] for m in metrics["end_to_end"]} >= {"setup_s"}
    assert len(metrics["end_to_end"]) >= 2 and metrics["per_layer"]
    for m in metrics["end_to_end"] + metrics["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    for m in metrics["per_layer"]:
        assert m["moves"] in {e["name"] for e in metrics["end_to_end"]}
    if "reference_solver" in cell:
        for k, v in cell["reference_solver"].items():
            assert cell["solver"].get(k, v) == v


def test_configs_and_metric_layers():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files) and all(f.startswith("port_bench/") for f in files)
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] == []
    for m in BENCH["per_layer"]:
        assert m["workloads"] and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert all(w in {x["name"] for x in BENCH["workloads"]} for w in m["workloads"])


def test_a_workload_file_added_to_a_copy_is_found(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = dict(bench["workloads"][0], name="d43-fit-rk4-fused-b4096", traffic="fit-b4096")
    bench["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = json.loads((ROOT / "port_bench/workloads/d43-fit-rk4-fused.json").read_text())
    cell.update(traffic="fit-b4096", batch=4096)
    (tmp_path / "port_bench/workloads/d43-fit-rk4-fused-b4096.json").write_text(json.dumps(cell))
    code = ("import sys; sys.path.insert(0, '.'); from port_bench import harness; "
            "print(harness.resolve('d43-fit-rk4-fused-b4096')[1]['batch'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "4096"


def test_the_runner_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "d43-fit-rk4-fused",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                yield str(arg.value).split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in SOURCES:
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "continuousnormalizingflows_tpu"}, path
        assert not names & {"chip_smoke", "bench", "benchmarks", "chip_profile"}, path
        if "reference" in path.parts:
            assert names <= {"__future__", "math", "typing", "torch"}, (path, names)


def test_no_target_names_the_jax_package():
    # a span's target is imported by name: compared whole, by its top-level module
    for w in BENCH["workloads"]:
        cell = json.loads((ROOT / f"port_bench/workloads/{w['name']}.json").read_text())
        for s in cell.get("spans", []):
            assert s["target"].split(".")[0] == "continuousnormalizingflows_tpu_torch"


def test_no_source_reads_the_smoke_run_or_the_jax_benchmarks():
    for path in SOURCES:
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
                and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs and path.name != Path(__file__).name:
                assert not re.search(r"benchmarks/|chip_smoke|bench\.py", node.value), path
