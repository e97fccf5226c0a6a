"""The port's optimizer, gradient compression and configs against the JAX
package's, on the CPU:

  * `adamw_update` for 3 steps with the clip active and inactive, under
    warm-up and cosine: the parameters (a GraphSAGE module's, updated in
    place and handed back by `convert.params_to_numpy`), moments, step,
    grad norm and lr equal JAX's `adamw_update` on the same gradients;
    `schedule` over a range of steps;
  * `topk_compress` (compressed pairs, error feedback, `densify`) and the
    int8 codec;
  * every ported CONFIG, SHAPES, SKIP_SHAPES, SAMPLE_SIZES, TABLE1,
    EDGE_FACTOR, N_USER_FIELDS and `MeshAxes` / `ArchDef` field for field;
  * each smoke on `device="cpu"`, and the entry points raising without a
    card when no device is named.

Tolerances: rtol 1e-6 on AdamW's parameters and moments, with atol 1e-6 of
each tensor's largest entry (entries that cancel to near zero keep their
operands' absolute error); codecs and config fields exactly.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as JC
from repro.models.gnn import graphsage as jsage
from repro.optim import adamw as JA
from repro.optim import grad_compress as JG
from repro_torch.configs import common as C
from repro_torch.convert import load_jax_params, params_to_numpy
from repro_torch.models.gnn import graphsage
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               int8_compress, int8_decompress, topk_compress,
                               topk_compress_init)
from repro_torch.optim.adamw import schedule, tree_map

RTOL = 1e-6


def _close(got, want):
    """rtol 1e-6, with atol 1e-6 of the tensor's largest entry: an entry
    that cancels to near zero (a parameter a step crosses, a moment whose
    gradient changed sign) keeps the absolute error of its operands, and
    the global norm's float32 sum runs in another order than XLA's."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _flat(tree) -> dict:
    def name(path):
        return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
    return {name(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("clip", [0.05, 1e3], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("warmup", [2, 0], ids=["warmup", "cosine"])
def test_adamw_three_steps_equal_jax(clip, warmup):
    cfg = dict(lr=1e-2, weight_decay=0.1, warmup_steps=warmup,
               total_steps=6, grad_clip=clip)
    scfg = graphsage.SAGEConfig("s", 2, 16, 8, 5)
    jp = jsage.init_params(jsage.SAGEConfig("s", 2, 16, 8, 5),
                           jax.random.key(0))
    model = graphsage.init_params(scfg, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jp))
    params = dict(model.named_parameters())
    state = adamw_init(params)
    jstate = JA.adamw_init(jp)
    jupdate = jax.jit(JA.adamw_update, static_argnums=0)
    rng = np.random.default_rng(4)
    for step in range(3):
        jgrads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)), jp)
        grads = {k: _t(v) for k, v in _flat(jgrads).items()}
        _, state, stats = adamw_update(AdamWConfig(**cfg), params, grads,
                                       state)
        jp, jstate, jstats = jupdate(JA.AdamWConfig(**cfg), jp, jgrads,
                                     jstate)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                       rtol=RTOL)
        back = params_to_numpy(model)
        assert jax.tree.structure(back) == jax.tree.structure(jp)
        for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
            _close(got, want)
        for m in ("mu", "nu"):
            want = _flat(jstate[m])
            for k, v in state[m].items():
                _close(v.numpy(), want[k])
    assert (float(stats["grad_norm"]) > clip) == (clip < 1)


def test_schedule_equals_jax():
    """Near the end of the cosine 1 + cos(pi * prog) cancels: there the
    lr keeps float32's absolute resolution of that sum, lr * 2^-23."""
    for cfg in (dict(warmup_steps=10, total_steps=100), dict(warmup_steps=0,
                                                             total_steps=1)):
        steps = np.arange(0, 120, 7, dtype=np.int32)
        got = schedule(AdamWConfig(**cfg), _t(steps))
        want = JA.schedule(JA.AdamWConfig(**cfg), jnp.asarray(steps))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=AdamWConfig().lr * 2.0**-23)


def test_adamw_on_a_nested_tree_keeps_jax_leaf_order():
    tree = {"b": [_t(np.ones(3, np.float32)), _t(np.zeros(2, np.float32))],
            "a": _t(np.full(4, 2.0, np.float32))}
    st = adamw_init(tree)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    out = tree_map(lambda p: p.shape, tree)
    assert list(out) == ["a", "b"] and out["b"][1] == (2,)


def _grad_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": [rng.standard_normal(40).astype(np.float32),
                       rng.standard_normal((3, 3)).astype(np.float32)]}


@pytest.mark.parametrize("frac", [0.01, 0.2, 1.0])
def test_topk_compress_equals_jax(frac):
    rng = np.random.default_rng(9)
    jgrads = _grad_tree(rng)
    grads = tree_map(_t, jgrads)
    err, jerr = topk_compress_init(grads), JG.topk_compress_init(jgrads)
    for _ in range(2):                            # error feedback carries
        comp, err, densify = topk_compress(grads, err, frac=frac)
        jcomp, jerr, jdensify = JG.topk_compress(jgrads, jerr, frac=frac)
        assert len(comp) == len(jcomp)
        for (idx, val), (jidx, jval) in zip(comp, jcomp):
            assert idx.dtype == torch.int32
            # no ties among random magnitudes: the same kept set
            np.testing.assert_array_equal(np.sort(idx.numpy()),
                                          np.sort(np.asarray(jidx)))
            order = np.argsort(idx.numpy())
            np.testing.assert_array_equal(
                val.numpy()[order], np.asarray(jval)[np.argsort(
                    np.asarray(jidx))])
        for got, want in zip(jax.tree.leaves(tree_map(
                lambda x: x.numpy(), err)), jax.tree.leaves(jerr)):
            np.testing.assert_array_equal(got, np.asarray(want))
        dense, jdense = densify(comp, grads), jdensify(jcomp, jgrads)
        for got, want in zip(jax.tree.leaves(tree_map(
                lambda x: x.numpy(), dense)), jax.tree.leaves(jdense)):
            np.testing.assert_array_equal(got, np.asarray(want))


def test_int8_codec_equals_jax():
    rng = np.random.default_rng(2)
    for g in (rng.standard_normal((7, 9)).astype(np.float32) * 3,
              np.zeros(5, np.float32), np.array([0.5, -1.5, 2.5], np.float32)):
        q, s = int8_compress(_t(g))
        jq, js = JG.int8_compress(jnp.asarray(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(s), float(js), rtol=RTOL)
        np.testing.assert_allclose(int8_decompress(q, s).numpy(),
                                   np.asarray(JG.int8_decompress(jq, js)),
                                   rtol=RTOL)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

CONFIG_MODULES = ["graphsage_reddit", "nequip", "mace", "egnn", "deepfm",
                  "gnn_common", "recsys_common", "bfs_rmat"]
NAMES = ["CONFIG", "SHAPES", "SKIP_SHAPES", "SAMPLE_SIZES", "TABLE1",
         "EDGE_FACTOR", "N_USER_FIELDS"]


def _plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("name", CONFIG_MODULES)
def test_configs_equal_jax(name):
    port = importlib.import_module(f"repro_torch.configs.{name}")
    jmod = importlib.import_module(f"repro.configs.{name}")
    shared = [k for k in NAMES if hasattr(jmod, k)]
    assert shared
    for k in shared:
        got, want = getattr(port, k), getattr(jmod, k)
        assert type(got).__name__ == type(want).__name__, k
        assert _plain(got) == _plain(want), k


def test_mesh_axes_and_arch_def_equal_jax():
    axes, jaxes = C.MeshAxes(dp=("pod", "data")), JC.MeshAxes(dp=("pod",
                                                                  "data"))
    assert dataclasses.asdict(axes) == dataclasses.asdict(jaxes)
    assert axes.all == jaxes.all == ("pod", "data", "model")
    assert [f.name for f in dataclasses.fields(C.ArchDef)] == \
        [f.name for f in dataclasses.fields(JC.ArchDef)]


@pytest.mark.parametrize("smoke", ["gnn_common.smoke_sage",
                                   "gnn_common.smoke_equiv:1",
                                   "gnn_common.smoke_equiv:3",
                                   "gnn_common.smoke_egnn",
                                   "recsys_common.smoke_deepfm",
                                   "bfs_rmat.smoke_bfs"])
def test_smokes_run_on_the_cpu(smoke):
    where, _, arg = smoke.partition(":")
    mod, fn = where.split(".")
    f = getattr(importlib.import_module(f"repro_torch.configs.{mod}"), fn)
    with pytest.warns(DeprecationWarning) if fn == "smoke_bfs" else \
            _no_warning():
        f(*([int(arg)] if arg else []), device="cpu")


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_entry_points_need_a_card_or_device_cpu(monkeypatch):
    from repro_torch.configs import gnn_common, recsys_common
    from repro_torch.models.gnn import egnn, equivariant
    from repro_torch.models.recsys import deepfm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: graphsage.init_params(graphsage.SAGEConfig(
                     "s", 1, 4, 4)),
                 lambda: equivariant.init_params(equivariant.EquivConfig(
                     "e", 1, 4, 4, 2.5)),
                 lambda: egnn.init_params(egnn.EGNNConfig("g", 1, 4)),
                 lambda: deepfm.init_params(deepfm.DeepFMConfig(
                     "d", vocabs=(4, 4))),
                 gnn_common.smoke_sage, recsys_common.smoke_deepfm):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
