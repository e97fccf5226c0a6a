"""BENCHMARK.json against the benchmark's contract, every name it holds
resolved to its file, the imports of the harness, and its refusal to run
without a card."""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gpubench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    paths = MANIFEST["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") \
            and ".." not in p.split("/") and (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word == p or word.startswith(p + "/") for p in paths)
    for f in BENCH.rglob("*"):
        if "__pycache__" not in f.parts:
            assert PATH.match(str(f.relative_to(ROOT))), f


def test_run_seconds_fit_a_full_check():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    files = set()
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert 1 <= len(MANIFEST["configs"]) <= 24
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("gpubench/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert "assumed" in body and "guarantees" in body


def test_workloads():
    cells = MANIFEST["workloads"]
    assert 1 <= len(cells) <= 24
    names = [w["name"] for w in cells]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        cell = harness.load_cell(MANIFEST, w["name"], ROOT)
        assert hasattr(cell.query, "judge") and cell.query.LIMITS


def test_metrics():
    e2e = MANIFEST["end_to_end"]
    layer = MANIFEST["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert "setup_s" in names
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert callable(harness.metric_reader(m["name"]))
    for name in cells:
        cell = harness.load_cell(MANIFEST, name, ROOT)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported


def imported_top_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def harness_sources():
    return sorted(p for p in BENCH.rglob("*.py")
                  if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", harness_sources(),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_the_harness(path):
    names = imported_top_names(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in names


def test_import_check_compares_whole_names():
    clean = ["torch", "repro_torch", "repro_torch.api", "gpubench.harness",
             "jax_like", "reprox"]
    assert harness.forbidden_modules(clean) == []
    assert harness.forbidden_modules(clean + ["repro.core", "jaxlib"]) == \
        ["jaxlib", "repro"]


def test_no_result_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", HOME=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         MANIFEST["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
