"""Every cell at SCALE 14 on the card, traced and not, and its control
(`python -m pytest -m gpu gpubench/tests` on a machine with a card)."""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def run(name, device, program="port", trace=False):
    cell = harness.load_cell(MANIFEST, name, ROOT)
    cell.config["scale"] = 14
    return harness.run(cell, 2**31 + 3, 1.0, trace, device,
                       time.perf_counter(), program)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card):
    result = run(name, card)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0
    assert {m["name"] for m in harness.load_cell(MANIFEST, name, ROOT)
            .end_to_end} == set(result["metrics"])
    traced = run(name, card, trace=True)
    assert traced["correct"]
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    assert traced["breakdown"]["device_ops"]
    assert set(traced["metrics"]) == {
        m["name"] for m in harness.load_cell(MANIFEST, name, ROOT).per_layer}


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card_is_not_correct(name, card):
    assert not run(name, card, program="control")["correct"]
