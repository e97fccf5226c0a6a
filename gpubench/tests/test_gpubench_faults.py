"""Whole runs of every cell on the CPU at a small size (SCALE 8, 1024-edge
chunks), past the harness's look for a card: sound, they come out
correct; with the timed path broken underneath, or with the control in
the program's place, they come out not correct."""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SEED = 2**31 + 77


def small_cell(name):
    cell = harness.load_cell(MANIFEST, name, ROOT)
    cell.config["scale"] = 8
    cell.config["bfs_config"]["edge_chunk"] = 1024
    return cell


def run(name, program="port", trace=False):
    return harness.run(small_cell(name), SEED, 0.0, trace, "cpu",
                       time.perf_counter(), program)


def unchanged_state(monkeypatch):
    """Every level step leaves the search's state as it found it."""
    from repro_torch.algos.engine import FrontierEngine
    monkeypatch.setattr(FrontierEngine, "_advance",
                        lambda self, run, graph, extra, limit=None: None)


def no_exchange(monkeypatch):
    """The exchange between the grid's processors left out."""
    from repro_torch.dist.topology import StackedTopology
    monkeypatch.setattr(StackedTopology, "col_all_to_all",
                        lambda self, x: x)


def altered_answer(monkeypatch):
    """One value of each answer altered where the engine produces it."""
    from repro_torch.algos.engine import FrontierEngine
    produce = FrontierEngine.assemble

    def assemble(self, outs, B):
        out = produce(self, outs, B)
        field = "level" if hasattr(out, "level") else "dist"
        vals = getattr(out, field).clone()
        v = int(torch.nonzero(vals > 0).flatten()[-1])
        vals[v] += 1
        return dataclasses.replace(out, **{field: vals})
    monkeypatch.setattr(FrontierEngine, "assemble", assemble)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run(name)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("fault", [unchanged_state, no_exchange,
                                   altered_answer],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result = run(name)
    assert not result["correct"] and result["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    result = run(name, program="control")
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_traced_run_reads_per_layer_metrics():
    result = run(CELLS[0], trace=True)
    assert result["correct"]
    assert "plan_s" in result["metrics"]
    assert "busy_s" in result["device"] and "breakdown" in result
