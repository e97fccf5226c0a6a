"""The port across a real `torch.distributed` process group: every rank's
session outputs equal the JAX package's, bit for bit.

Each layout spawns its ranks on the CPU under gloo
(`tests/dist/torch_run_multihost.py`, a `file://` store under the test's
temporary directory) and plans the graph of `tests/dist/run_multihost.py`
(`np.random.default_rng(7)`, SCALE 9, EF 8, symmetrised, uint8 weights)
with `DistGraph.from_edges(..., mesh=multihost.global_mesh(...))`, each rank
building only its blocks:

  * 1x4 over 4 ranks, one processor each;
  * 1x4 over 2 ranks of (1, 2) -- JAX's `run_multihost.py 2 2`;
  * 2x2 over 4 ranks;
  * 2x2 over 2 ranks, each holding a grid row (the row gather crosses
    ranks, the fold does not).

Every rank runs bfs(3), bfs([1, 5, 3]), connected_components(), sssp(3)
and multi_bfs([1, 5, 3]) under the flat and the butterfly exchange, for
top-down under the list codec and direction-optimised (adaptive) under the
bitmap and the delta codec -- the adaptive searches run top-down levels as
well, so every codec's set and value folds cross the group, the bitmap's
32-bit and the delta codec's 16-bit words included.  Every field (levels,
preds, n_levels, exact edges_scanned, labels, distances, multi-BFS levels
and sources, the directions trace) of every rank is held to one JAX run of
the same queries (`tests/dist/torch_parity_ref.py --multihost --cover`,
forced host devices, flat exchange, whose outputs the JAX butterfly
equals), which runs while the first group does.  Every group launch has
its own deadline and kills its ranks on expiry.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

DIST = os.path.join(os.path.dirname(__file__), "dist")
spec = importlib.util.spec_from_file_location(
    "torch_run_multihost", os.path.join(DIST, "torch_run_multihost.py"))
TMH = importlib.util.module_from_spec(spec)
spec.loader.exec_module(TMH)

LAYOUTS = {"1x4-4ranks": ("4", "1", "--grid", "1x4"),
           "1x4-2ranks": ("2", "2", "--grid", "1x4"),
           "2x2-4ranks": ("4", "1", "--grid", "2x2"),
           "2x2-2ranks": ("2", "2", "--grid", "2x2")}
GROUP_TIMEOUT = 120        # seconds a group launch may take
REF_TIMEOUT = 300          # seconds the JAX reference may take


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX outputs of both grids, computed in a child that starts at
    the first use and runs beside the first group; returns a function
    that waits for it and gives its .npz."""
    td = tmp_path_factory.mktemp("jax_ref")
    n, edges, w = TMH.make_inputs(9)
    src, ref = str(td / "edges.npz"), str(td / "ref.npz")
    np.savez(src, edges=edges, roots=np.asarray(TMH.BATCH, np.int32), n=n,
             weights=w)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(DIST, "torch_parity_ref.py"), src, ref,
         "1x4", "2x2", "--multihost", "--cover"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait():
        try:
            out, _ = proc.communicate(timeout=REF_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError("the JAX reference did not finish in "
                                 f"{REF_TIMEOUT} s")
        assert proc.returncode == 0, f"the JAX reference failed:\n{out}"
        return ref

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_group_outputs_equal_jax(layout, jax_ref, tmp_path):
    """Every output field on every rank equals the JAX package's, under
    the flat and the butterfly exchange."""
    argv = list(LAYOUTS[layout]) + ["both", "--configs", "cover",
                                    "--timeout", str(GROUP_TIMEOUT)]
    a, _ = TMH.run_group(argv, str(tmp_path))
    n_keys = TMH.compare(a, jax_ref(), str(tmp_path))
    # 3 configs x 5 queries x >= 4 fields x 2 exchanges x every rank
    assert n_keys >= 3 * 5 * 4 * 2 * a.nproc


def test_block_shapes_and_refusals():
    """A world whose runs of processors are not rectangles is refused with
    a ValueError; the blocks of the rectangular ones are JAX's
    device-to-process assignment (row-major runs)."""
    from repro_torch.dist.multihost import block_shape
    assert block_shape(2, 2, 4) == (1, 1)
    assert block_shape(2, 2, 2) == (1, 2)
    assert block_shape(1, 4, 2) == (1, 2)
    assert block_shape(4, 2, 2) == (2, 2)
    assert block_shape(2, 4, 1) == (2, 4)
    assert block_shape(2, 3, 2) == (1, 3)
    with pytest.raises(ValueError, match="not a rectangle"):
        block_shape(3, 4, 2)            # runs of 6 on rows of 4
    with pytest.raises(ValueError, match="not a multiple"):
        block_shape(2, 2, 3)
