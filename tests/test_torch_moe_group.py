"""The expert-parallel MoE and `shard_batch` across a real gloo process
group (ROADMAP A21), held to the JAX package on the CPU.

One `tests/dist/torch_parity_ref.py ... 2x2 --moe` child runs the JAX
package on 4 forced host devices: `moe_apply` under `shard_map` (tokens
over ("data", "model"), experts over "model") for each (quant_dispatch,
fsdp_axis) case -- output, aux and the gradients of sum(y * gy) + aux --
and every device's `shard_batch` shard for five PartitionSpecs.  Then
`tests/dist/torch_run_multihost.py --mode moe` runs the port over a 2x2
`ProcessMesh` in two layouts at once: 4 ranks of one processor (every
collective crosses ranks) and 2 ranks of two processors (the expert axis
within a rank, the FSDP axis across).  Every rank is held to JAX: outputs
and gradients within rtol 1e-4, atol 1e-5 of each tensor's largest entry,
aux rtol 1e-6, its shard equal to the JAX shards its processors hold (or
refused where they are not one block); and one train step of a 2-layer MoE
LM over the group equals the same step over a stacked mesh (loss equal,
parameters within rtol 1e-5, atol 1e-7).  The runner prints one
"CHECK <name> ok" line per item; each test below reads its items.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
RUNNER = os.path.join(HERE, "dist", "torch_run_multihost.py")
REF_SCRIPT = os.path.join(HERE, "dist", "torch_parity_ref.py")
LAYOUTS = {"4x1": ("4", "1"), "2x2": ("2", "2")}
MOE_TAGS = ["moe_0_None", "moe_1_None", "moe_0_data", "moe_1_data"]
SPECS = ["default", "data_model", "model_data", "model", "rows_cols"]


def _runner():
    spec = importlib.util.spec_from_file_location("torch_run_multihost",
                                                  RUNNER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{layout: the runner's output} after one JAX child and both group
    launches (side by side)."""
    d = tmp_path_factory.mktemp("moe_group")
    np.savez(d / "in.npz", **_runner().moe_inputs())
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, REF_SCRIPT, str(d / "in.npz"),
                          str(d / "ref.npz"), "2x2", "--moe"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    procs = {k: subprocess.Popen(
        [sys.executable, RUNNER, nproc, local, "--grid", "2x2", "--mode",
         "moe", "--ref", str(d / "ref.npz"), "--timeout", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, (nproc, local) in LAYOUTS.items()}
    out = {}
    try:
        for k, p in procs.items():
            out[k] = p.communicate(timeout=300)[0]
            assert p.returncode == 0, out[k][-4000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _ranks(layout):
    return range(int(LAYOUTS[layout][0]))


def _checked(runs, layout, item):
    for r in _ranks(layout):
        line = f"CHECK {item}_rank{r} ok"
        assert line in runs[layout].splitlines(), (line, runs[layout][-3000:])


@pytest.mark.parametrize("tag", MOE_TAGS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_moe_over_a_group_equals_shard_map(runs, layout, tag):
    _checked(runs, layout, tag)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_shard_batch_gives_each_rank_its_jax_shards(runs, layout, spec):
    _checked(runs, layout, f"shard_{spec}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_train_step_over_a_group_equals_the_stacked_step(runs, layout):
    _checked(runs, layout, "train_step")
    assert runs[layout].rstrip().endswith("OK")
