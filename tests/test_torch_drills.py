"""The fault-drill harness in the port (`repro_torch.scenarios`, DESIGN.md
sec. 15): the standard matrix, `serve-drain` included, at 2x2 on the CPU,
every drill `ok` and its verdict equal to the JAX package's matrix on the
same graph (run once in a subprocess with four forced host devices,
tests/dist/torch_parity_ref.py --drills); the matrix's list equal to
JAX's.

Inputs as tests/test_recovery.py makes them: `repro.graphgen.rmat_edges(
jax.random.key(3), 7, 8)` as numpy, uint8 weights `(|31 u + v| mod 254) +
1`; the drills pick their roots themselves (`np.random.default_rng(0)`).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.graphgen import rmat_edges as jax_rmat_edges
from repro.scenarios import standard_matrix as jax_standard_matrix
from repro_torch.api import BFSConfig
from repro_torch.scenarios import run_matrix, standard_matrix

SCALE, EF = 7, 8
N = 1 << SCALE
REF_SCRIPT = os.path.join(os.path.dirname(__file__), "dist",
                          "torch_parity_ref.py")
DRILLS = standard_matrix()
# the verdict fields both packages must agree on (times and the error text
# are not part of the contract)
VERDICT = ("scenario", "injector", "runner", "ok", "bit_identical",
           "pred_valid", "lost_queries", "resumed_from_level", "grid_before",
           "grid_after", "retries", "resumes", "error")


@pytest.fixture(scope="module")
def gdata():
    edges = np.asarray(jax_rmat_edges(jax.random.key(3), SCALE, EF))
    w = ((np.abs(edges[0] * 31 + edges[1]) % 254) + 1).astype(np.uint8)
    return edges, w


@pytest.fixture(scope="module")
def port_rows(gdata):
    edges, w = gdata
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = [r.to_row() for r in run_matrix(
            edges, BFSConfig(grid=(2, 2), edge_chunk=512), weights=w, n=N,
            scenarios=DRILLS, device="cpu")]
    finally:
        torch.set_num_threads(n)
    return {r["name"]: r for r in rows}


@pytest.fixture(scope="module")
def jax_rows(gdata, tmp_path_factory):
    edges, w = gdata
    d = tmp_path_factory.mktemp("drill_ref")
    np.savez(d / "in.npz", edges=edges, roots=np.zeros(1, np.int32), n=N,
             weights=w)
    res = subprocess.run(
        [sys.executable, REF_SCRIPT, str(d / "in.npz"), str(d / "out.npz"),
         "2x2", "--drills"], capture_output=True, text=True, timeout=900,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stdout + res.stderr
    rows = json.loads(str(np.load(d / "out.npz")["drills"]))
    return {r["name"]: r for r in rows}


def test_standard_matrix_is_jax_list():
    """The same drills in the same order, serve-drain included."""
    ours = [dataclasses.asdict(s) for s in standard_matrix()]
    theirs = [dataclasses.asdict(s) for s in jax_standard_matrix()]
    assert ours == theirs
    assert "serve-drain/bfs/list" in [s.name for s in DRILLS]


@pytest.mark.parametrize("name", [s.name for s in DRILLS])
def test_drill_matches_jax(port_rows, jax_rows, name):
    """Every drill passes on the port, and its verdict equals JAX's:
    bit_identical, pred_valid, resumed_from_level, grid_after, retries."""
    mine, theirs = port_rows[name], jax_rows[name]
    assert mine["ok"], mine
    for k in VERDICT:
        assert mine[k] == theirs[k], (k, mine[k], theirs[k])
    if "shrink" in name:
        assert mine["grid_after"] != mine["grid_before"]
        assert mine["time_to_first_resumed_level_s"] > 0

