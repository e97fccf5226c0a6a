"""The port's launcher and example twins run end to end on the CPU:

  * `python -m repro_torch.launch.bfs_run --device cpu --grid 2x2 --scale 8
    --roots 4 --validate 2`, top-down and with `--direction --fold
    bitmap`, exits 0 and prints the JAX driver's summary line with
    "(2 validated)";
  * without --device and without a card (CUDA_VISIBLE_DEVICES empty) it
    exits non-zero naming --device cpu;
  * scripts/torch_quickstart.py, torch_distributed_bfs.py,
    torch_obs_quickstart.py and torch_serve_quickstart.py run at SCALE 8
    with --device cpu and print the JAX examples' lines;
  * scripts/torch_gnn_fullgraph_2d.py trains GraphSAGE on the 2D SpMM at
    the example's SCALE 10 for its 80 steps and prints its loss line.
"""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
       "OMP_NUM_THREADS": "1"}
SUMMARY = re.compile(
    r"grid=2x2 scale=8 ef=16 fold=(list|bitmap) dir=(False|True): "
    r"harmonic TEPS \d\.\d{3}e[+-]\d\d \(2 validated\) \| 4-root sweep "
    r"\d+\.\d{3}s, amortised \d\.\d{3}e[+-]\d\d TEPS, harmonic "
    r"\d\.\d{3}e[+-]\d\d TEPS")


def _run(args, env=ENV):
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=120, cwd=ROOT, env=env)


@pytest.mark.parametrize("flags", [[], ["--direction", "--fold", "bitmap"]])
def test_bfs_run_prints_the_jax_summary(flags):
    res = _run(["-m", "repro_torch.launch.bfs_run", "--device", "cpu",
                "--grid", "2x2", "--scale", "8", "--roots", "4",
                "--validate", "2"] + flags)
    assert res.returncode == 0, res.stderr
    line = res.stdout.strip().splitlines()[-1]
    m = SUMMARY.fullmatch(line)
    assert m, line
    assert m.group(2) == str(bool(flags))


def test_bfs_run_needs_a_card_or_device_cpu():
    res = _run(["-m", "repro_torch.launch.bfs_run", "--scale", "8"],
               env={**ENV, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "--device cpu" in res.stderr


@pytest.mark.parametrize("script,args,expect", [
    ("torch_quickstart.py", ["8", "8", "4"],
     r"harmonic mean TEPS over 4 roots: \S+"),
    ("torch_distributed_bfs.py", ["2", "2", "8", "8", "4", "bitmap"],
     r"batched 4-root sweep: \S+s, amortised \S+ TEPS"),
    ("torch_obs_quickstart.py", ["8", "8"], r"OK"),
    ("torch_serve_quickstart.py", ["8", "8"],
     r"OK \(coalesced; every result bit-identical to a direct session "
     r"call\)"),
    ("torch_gnn_fullgraph_2d.py", [],
     r"loss \d+\.\d{3} -> \d+\.\d{4} \(learning works\)"),
])
def test_script_twins_run_on_the_cpu(script, args, expect):
    res = _run([os.path.join("scripts", script)] + args
               + ["--device", "cpu"])
    assert res.returncode == 0, res.stdout + res.stderr
    assert re.fullmatch(expect, res.stdout.strip().splitlines()[-1])
    if script == "torch_quickstart.py":
        assert res.stdout.count("[validated]") == 4
    if script == "torch_distributed_bfs.py":
        assert "(4 searches fully validated)" in res.stdout
