"""The port's LM data stream, smokes and training entry points, on the CPU:

  * `synthetic_lm_batches` bit for bit equal to the JAX package's for a
    few (vocab, batch, seq, seed);
  * `Prefetcher` yields the stream in order and stops; `shard_batch` puts
    a batch on a `StackedMesh`'s device and gives a `ProcessMesh`'s rank
    the rows its processors hold (tests/test_torch_moe_group.py holds 4
    gloo ranks to JAX's shards);
  * `SHAPES` equal to JAX's; `smoke_lm` of all five configs with
    `device="cpu"`, and the entry points raising without a card when no
    device is named;
  * `python -m repro_torch.launch.train --device cpu` (in process: its
    `main`) for 26 steps: the loss drops and checkpoints 0 and 25 land --
    JAX's launcher's schedule -- in the directory given;
  * `scripts/torch_train_lm.py 21 --device cpu` (a child): the loss drops
    by more than 0.2 ("IMPROVED"), as the JAX example reports.
"""
import dataclasses
import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import lm_common as JLC
from repro.data import synthetic_lm_batches as jax_batches
from repro_torch.configs import lm_common as LC
from repro_torch.data import shard_batch, synthetic_lm_batches
from repro_torch.data.pipeline import Prefetcher
from repro_torch.dist import make_mesh
from repro_torch.dist.multihost import ProcessMesh

HERE = os.path.dirname(__file__)
ROOT = os.path.join(HERE, "..")
FULL = ("gemma2_2b", "glm4_9b", "h2o_danube_1_8b", "kimi_k2_1t_a32b",
        "qwen2_moe_a2_7b")


@pytest.mark.parametrize("vocab,batch,seq,seed", [
    (512, 8, 128, 0), (97, 3, 17, 5), (32000, 2, 64, 11)])
def test_synthetic_batches_bit_equal_jax(vocab, batch, seq, seed):
    got = list(synthetic_lm_batches(vocab, batch, seq, seed=seed,
                                    n_batches=9))
    want = list(jax_batches(vocab, batch, seq, seed=seed, n_batches=9))
    assert len(got) == len(want) == 9
    for (t, l), (jt, jl) in zip(got, want):
        assert t.dtype == jt.dtype == np.int32
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(l, jl)


def test_synthetic_data_shapes():
    """tests/test_substrate.py's: labels are the next tokens."""
    batches = list(synthetic_lm_batches(101, 4, 16, n_batches=3))
    assert len(batches) == 3
    t, l = batches[0]
    assert t.shape == (4, 16) and l.shape == (4, 16)
    assert (t[:, 1:] == l[:, :-1]).all()
    assert t.max() < 101 and t.min() >= 0


def test_prefetcher_and_shard_batch():
    stream = synthetic_lm_batches(61, 2, 8, n_batches=5)
    got = list(Prefetcher(stream, depth=2))
    want = list(synthetic_lm_batches(61, 2, 8, n_batches=5))
    assert len(got) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0], b[0])
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    placed = shard_batch(got[0], mesh)
    assert isinstance(placed, tuple)
    assert placed[0].device == mesh.device
    np.testing.assert_array_equal(placed[1].numpy(), got[0][1])
    named = shard_batch({"tokens": got[1][0]}, mesh)
    assert torch.equal(named["tokens"], torch.from_numpy(got[1][0]))
    # a ProcessMesh (once refused, ROADMAP A21): a rank receives the rows
    # its processors hold -- a 1-rank group all of them, rank 1 of four
    # ("data" coordinate 0) the first half of P(("pod", "data"))'s rows,
    # rank 2 ("data" 1) the second half of P(("data", "model"))'s quarter
    pm = ProcessMesh(shape=(2, 2), axis_names=("data", "model"), rank=0,
                     world=1, i0=0, j0=0, Rl=2, Cl=2,
                     device=torch.device("cpu"), backend="gloo")
    whole = shard_batch(got[0], pm)
    assert all(torch.equal(w, torch.from_numpy(g))
               for w, g in zip(whole, got[0]))
    quad = np.arange(8 * 3).reshape(8, 3)
    r1 = dataclasses.replace(pm, rank=1, world=4, i0=0, j0=1, Rl=1, Cl=1)
    np.testing.assert_array_equal(shard_batch(quad, r1).numpy(), quad[:4])
    r2 = dataclasses.replace(r1, rank=2, i0=1, j0=0)
    np.testing.assert_array_equal(
        shard_batch(quad, r2, (("data", "model"),)).numpy(), quad[4:6])


def test_shapes_equal_jax():
    assert LC.SHAPES == JLC.SHAPES


@pytest.mark.parametrize("mod", FULL)
def test_smoke_lm_on_the_cpu(mod):
    cfg = importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
    LC.smoke_lm(cfg, device="cpu")


def test_entry_points_raise_without_a_device(monkeypatch):
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm as L

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = importlib.import_module("repro_torch.configs.gemma2_2b").CONFIG
    for call in (lambda: LC.smoke_lm(cfg),
                 lambda: L.init_cache(cfg, 1, 8),
                 lambda: launch_train.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _losses(text):
    return [float(x) for x in re.findall(r"loss=([0-9.]+)", text)]


def test_launch_train_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    ckpt = tmp_path / "ckpts"
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        launch_train.main(["--device", "cpu", "--steps", "26", "--batch",
                           "4", "--seq", "64", "--ckpt-dir", str(ckpt),
                           "--arch", "h2o-danube-1.8b"])
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out
    losses = _losses(out)
    assert len(losses) == 3 and losses[-1] < losses[0], out
    assert "done; checkpoints in" in out
    assert sorted(os.listdir(ckpt)) == ["step_0", "step_25"]


def test_train_lm_script_on_the_cpu(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_train_lm.py"),
         "21", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "IMPROVED" in res.stdout, res.stdout
    assert os.listdir(tmp_path / "ck") == ["step_0"]
