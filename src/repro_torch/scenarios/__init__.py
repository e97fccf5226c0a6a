"""Fault drills: scenario x injector x runner (DESIGN.md sec. 15)."""
from repro_torch.scenarios.base import DrillResult, Scenario, run_drill
from repro_torch.scenarios.fault_drills import run_matrix, standard_matrix
