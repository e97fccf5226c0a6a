"""The port's 2D SpMM (`repro_torch.core.spmm2d`) against the JAX package's
(`repro.core.spmm2d`), on the CPU:

  * `make_spmm2d` at 1x1 in this process, and `spmm2d_device` with per-edge
    weights as tests/test_integration_extra.py runs JAX's under
    `shard_map`;
  * the same at 2x2 and 1x4 against tests/dist/torch_parity_ref.py --spmm
    (four forced host devices, one subprocess), with the gradient of
    sum(spmm(x) * gy) against `jax.grad`;
  * an edge chunk that splits columns equals one chunk, and the autograd
    gradient at 1x1 equals `jax.grad` of JAX's `make_spmm2d`;
  * one 2x2 run across 4 gloo ranks (tests/dist/torch_run_multihost.py
    --mode spmm): every rank's whole output equals the stacked grid's, and
    a tensor needing a gradient is refused there;
  * `spmm_reference` (the plain edge-list product the card check uses)
    equals JAX's.

Inputs: `repro.graphgen.rmat_edges(jax.random.key(5), 8, 8)` as numpy,
features from `np.random.default_rng(2)`: random normal and
integer-valued.  Tolerances: exact on integer-valued features (sums far
below 2^24), rtol 1e-5 / atol 1e-6 on random ones (summation order).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import Grid2D as JGrid2D
from repro.core import partition_2d as jax_partition_2d
from repro.core.partition import partition_edge_vals as jax_edge_vals
from repro.core.spmm2d import make_spmm2d as jax_make_spmm2d
from repro.core.spmm2d import spmm2d_device as jax_spmm2d_device
from repro.core.types import LocalGraph2D as JLocalGraph2D
from repro.dist.compat import make_mesh as jax_make_mesh
from repro.dist.compat import shard_map
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro_torch.core import partition as TP
from repro_torch.core import spmm2d as spmm2d_mod
from repro_torch.core.spmm2d import make_spmm2d, spmm_reference
from repro_torch.core.types import Grid2D
from repro_torch.dist import make_mesh

SCALE, EF, D = 8, 8, 6
N = 1 << SCALE
RTOL, ATOL = 1e-5, 1e-6
HERE = os.path.dirname(__file__)
REF_SCRIPT = os.path.join(HERE, "dist", "torch_parity_ref.py")
GROUP_SCRIPT = os.path.join(HERE, "dist", "torch_run_multihost.py")


@pytest.fixture(scope="module")
def data():
    edges = np.asarray(jax_rmat_edges(jax.random.key(5), SCALE, EF))
    rng = np.random.default_rng(2)
    return {"edges": edges,
            "x": rng.standard_normal((N, D)).astype(np.float32),
            "xi": rng.integers(-8, 9, (N, D)).astype(np.float32),
            "gy": rng.standard_normal((N, D)).astype(np.float32),
            "weights": rng.integers(1, 256, edges.shape[1]).astype(np.uint8)}


@pytest.fixture(scope="module")
def jax_ref(data, tmp_path_factory):
    """JAX's products at 2x2 and 1x4, from one subprocess."""
    d = tmp_path_factory.mktemp("jax_spmm")
    np.savez(d / "in.npz", roots=np.zeros(1, np.int32), n=N, **data)
    res = subprocess.run(
        [sys.executable, REF_SCRIPT, str(d / "in.npz"), str(d / "out.npz"),
         "2x2", "1x4", "--spmm"], capture_output=True, text=True,
        timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(d / "out.npz"))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port(data, grid):
    """(spmm callable, graph, per-block weights) of the port on the CPU."""
    R, C = grid
    g2 = Grid2D.for_vertices(N, R, C)
    g, w = TP.partition_2d_with_vals(_t(data["edges"]), _t(data["weights"]),
                                     g2)
    return make_spmm2d(g2, make_mesh((R, C), ("r", "c"), device="cpu")), g, w


def _chunk_edges(monkeypatch, edges):
    """Bound the local step's chunk to `edges` messages of D float32s."""
    monkeypatch.setattr(spmm2d_mod, "CHUNK_BYTES", edges * D * 4)


def _run(spmm, g, x, **kw):
    return spmm(g.col_off, g.row_idx, g.nnz, _t(x), **kw)


def _jax_1x1(data):
    grid = JGrid2D.for_vertices(N, 1, 1)
    lg = jax_partition_2d(data["edges"], grid)
    mesh = jax_make_mesh((1, 1), ("r", "c"))
    arrays = [jnp.asarray(a) for a in (lg.col_off, lg.row_idx, lg.nnz)]
    return grid, mesh, arrays


def test_1x1_equals_jax(data):
    grid, mesh, arrays = _jax_1x1(data)
    jspmm = jax_make_spmm2d(grid, mesh)
    spmm, g, _ = _port(data, (1, 1))
    for key, exact in (("x", False), ("xi", True)):
        want = np.asarray(jspmm(*arrays, jnp.asarray(data[key])))
        got = _run(spmm, g, data[key]).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_1x1_edge_weights_equal_jax(data):
    """As tests/test_integration_extra.py::
    test_spmm2d_edge_weights_single_cell runs JAX's per-device body."""
    grid, mesh, (co, ri, nz) = _jax_1x1(data)
    w = jnp.asarray(jax_edge_vals(data["edges"], data["weights"], grid))

    def f(co, ri, nnz, x, w):
        g = JLocalGraph2D(col_off=co[0, 0], row_idx=ri[0, 0], nnz=nnz[0, 0])
        return jax_spmm2d_device(g, x, grid=grid, row_axes=("r",),
                                 col_axes=("c",), edge_weight=w[0, 0])

    dev = P(("r",), ("c",))
    jf = jax.jit(shard_map(f, mesh=mesh, in_specs=(dev, dev, dev, P(), dev),
                           out_specs=P(), check_vma=False))
    spmm, g, wb = _port(data, (1, 1))
    np.testing.assert_array_equal(wb.numpy(), np.asarray(w))
    for key, exact in (("x", False), ("xi", True)):
        want = np.asarray(jf(co, ri, nz, jnp.asarray(data[key]), w))
        got = _run(spmm, g, data[key], edge_weight=wb).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_edge_chunk_splitting_columns_changes_nothing(data, grid,
                                                       monkeypatch):
    """A 7-edge chunk splits many columns (the mean degree is 16): on
    integer-valued features, weighted or not, the product is exactly one
    whole-block chunk's (the default CHUNK_BYTES holds every edge)."""
    spmm, g, w = _port(data, grid)
    whole = [_run(spmm, g, data["xi"], **kw)
             for kw in ({}, {"edge_weight": w})]
    _chunk_edges(monkeypatch, 7)
    split = [_run(spmm, g, data["xi"], **kw)
             for kw in ({}, {"edge_weight": w})]
    for a, b in zip(split, whole):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("edge_chunk", [None, 5])
def test_1x1_gradient_equals_jax_grad(data, edge_chunk, monkeypatch):
    grid, mesh, arrays = _jax_1x1(data)
    jspmm = jax_make_spmm2d(grid, mesh)
    want = np.asarray(jax.grad(lambda x: jnp.sum(
        jspmm(*arrays, x) * jnp.asarray(data["gy"])))(
            jnp.asarray(data["x"])))
    if edge_chunk is not None:
        _chunk_edges(monkeypatch, edge_chunk)
    spmm, g, _ = _port(data, (1, 1))
    x = _t(data["x"]).requires_grad_(True)
    (spmm(g.col_off, g.row_idx, g.nnz, x) * _t(data["gy"])).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_grids_equal_jax(data, jax_ref, grid):
    tag = f"{grid[0]}x{grid[1]}_spmm"
    spmm, g, w = _port(data, grid)
    np.testing.assert_array_equal(_run(spmm, g, data["xi"]).numpy(),
                                  jax_ref[f"{tag}_yi"])
    np.testing.assert_allclose(_run(spmm, g, data["x"]).numpy(),
                               jax_ref[f"{tag}_y"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        _run(spmm, g, data["x"], edge_weight=w).numpy(),
        jax_ref[f"{tag}_yw"], rtol=RTOL, atol=ATOL)
    x = _t(data["x"]).requires_grad_(True)
    (spmm(g.col_off, g.row_idx, g.nnz, x) * _t(data["gy"])).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), jax_ref[f"{tag}_gx"],
                               rtol=RTOL, atol=ATOL)


def test_four_gloo_ranks_equal_the_stacked_grid():
    res = subprocess.run(
        [sys.executable, GROUP_SCRIPT, "4", "1", "--grid", "2x2", "--mode",
         "spmm", "--scale", "8"], capture_output=True, text=True,
        timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "16 outputs bit-identical to the stacked grid's" in res.stdout


def test_spmm_reference_equals_jax(data, monkeypatch):
    grid, mesh, arrays = _jax_1x1(data)
    want = np.asarray(jax_make_spmm2d(grid, mesh)(
        *arrays, jnp.asarray(data["xi"])))
    # 100 float64 messages a chunk (200 float32 ones)
    monkeypatch.setattr(spmm2d_mod, "CHUNK_BYTES", 100 * D * 8)
    y, mag = spmm_reference(_t(data["edges"]), _t(data["xi"]), N,
                            dtype=torch.float64)
    np.testing.assert_array_equal(y.numpy(), want.astype(np.float64))
    absum, _ = spmm_reference(_t(data["edges"]), _t(np.abs(data["xi"])), N)
    np.testing.assert_array_equal(mag.numpy(), absum.numpy())
