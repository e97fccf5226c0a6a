"""`repro_torch.dist.topology.GroupTopology` and `dist.multihost` across a
real gloo process group on the CPU (`tests/dist/torch_run_multihost.py`
spawns the ranks, each launch under its own deadline):

  * `row_gather`, `col_all_to_all` under the flat and the butterfly
    exchange, `psum_all` (int32 wrapping) and `fetch` equal
    `StackedTopology`'s on random int32, int64, uint32, uint16 and bool
    tensors -- gloo refuses the uint32, uint16 and int16 dtypes, so this
    holds the uint8 wire to be bit-exact for every dtype;
  * a counting wrapper: flat makes one all_to_all a fold; the butterfly
    makes log2(C) stages a fold and no all_to_all, a stage whose partner
    column lies on another rank being one pairwise exchange (both stages
    at 1x4 over 4 ranks, one of two over 2 ranks of (1, 2));
  * `DistGraph.from_partition(..., mesh=)` of a whole-grid partition
    keeps a rank's blocks and answers as `from_edges(..., mesh=)` does;
    GraphServer raises NotImplementedError naming ROADMAP A13 part 3 in a
    group, and the group answers afterwards;
  * marked `gpu`: 2 ranks on cuda:0 (gloo, staged through the host) at
    SCALE 10 equal the stacked session on the card, every field.
"""
import os
import subprocess
import sys

import pytest
import torch

SCRIPT = os.path.join(os.path.dirname(__file__), "dist",
                      "torch_run_multihost.py")
TIMEOUT = 120


def run(*args, timeout=TIMEOUT):
    """The script's orchestrator with `args`; its output, asserting OK."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, SCRIPT, *args, "--timeout",
                        str(timeout)], env=env, capture_output=True,
                       text=True, timeout=timeout + 60)
    assert r.returncode == 0 and r.stdout.rstrip().endswith("OK"), \
        f"{args}: exit {r.returncode}\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}"
    return r.stdout


@pytest.mark.parametrize("layout", [("4", "1", "--grid", "1x4"),
                                    ("2", "2", "--grid", "1x4"),
                                    ("4", "1", "--grid", "2x2"),
                                    ("2", "2", "--grid", "2x2")],
                         ids=["1x4-4ranks", "1x4-2ranks", "2x2-4ranks",
                              "2x2-2ranks"])
def test_collectives_equal_stacked(layout):
    """Every collective equals the stacked topology's on every dtype, and
    the transfers are counted as the docstring says (each rank checks)."""
    out = run(*layout, "--mode", "collectives")
    assert out.count("DONE") == int(layout[0])


def test_from_partition_and_unported_features_in_a_group():
    """`from_partition(..., mesh=)` keeps a rank's blocks and answers as
    the `from_edges` graph does (top-down and direction-optimised BFS and
    SSSP); GraphServer refuses a process group with ROADMAP A13 part 3 in
    the message; then the group still answers (each rank checks)."""
    out = run("2", "2", "--grid", "2x2", "--mode", "surface")
    assert out.count("DONE") == 2


@pytest.mark.gpu
def test_group_on_the_card_equals_stacked():
    """2 ranks on cuda:0 at SCALE 10 (top-down and adaptive under every
    codec, flat and butterfly) equal the stacked session on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    run("2", "2", "both", "--grid", "2x2", "--device", "cuda", "--scale",
        "10", timeout=600)
