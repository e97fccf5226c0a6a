"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
package's (`repro.models.moe`), on the CPU:

  * `_route`: top-k indices and weights and the aux loss exactly, with
    random logits, tied probabilities (a zero router: `jax.lax.top_k`
    takes the lower expert first) and phantom experts (-1e30 logits, no
    copy);
  * `_moe_local` (EP = 1): output and aux with a capacity factor that
    drops copies and one that does not, and with an expert that overflows
    its per-expert capacity where ceil(flat / E) < 8;
  * the MoE LM's gradients (tests/test_models_lm_recsys.py's
    `test_lm_moe_train_grads` config), every leaf equal to JAX's;
  * int8 dispatch quantisation close to exact (tests/
    test_integration_extra.py's `test_moe_quant_dispatch_close_to_exact`),
    the port's numbers equal to JAX's;
  * the EP path on a 2x2 ("data", "model") `StackedMesh` against JAX's
    `shard_map` on 4 forced host devices (tests/dist/torch_parity_ref.py
    --moe, one subprocess, jitted): 30 tokens padded to 32, 8 experts of
    which 6 route, top-2, quant_dispatch off and on, with and without
    fsdp_axis="data" -- output, aux and the gradients of x, router, w1,
    w3, w2; the EP result is not the EP = 1 one (each shard has its own
    capacity, padded tokens route, aux is the shards' mean);
  * `moe_apply` over a `ProcessMesh` raises NotImplementedError.

Tolerances: routing indices exactly, weights and aux rtol 1e-6; outputs
and gradients rtol 1e-4 with atol 1e-5 of each tensor's largest entry
(int8 dispatch: the same, its rounding being JAX's half-to-even).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as JL
from repro.models import moe as JM
from repro_torch.convert import load_jax_params
from repro_torch.dist import make_mesh
from repro_torch.dist.multihost import ProcessMesh
from repro_torch.models import lm as L
from repro_torch.models import moe as M

HERE = os.path.dirname(__file__)
REF_SCRIPT = os.path.join(HERE, "dist", "torch_parity_ref.py")
RTOL, ATOL = 1e-4, 1e-5
EP = dict(N=30, d=12, f=16, E=8, n_real=6, top_k=2, capacity_factor=1.25,
          cap_e_mult=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(float(np.abs(want).max()),
                                               1e-30))


def _layer(seed, N, d, f, E):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((N, d)).astype(np.float32),
            "router": (rng.standard_normal((d, E)) * 0.3).astype(np.float32),
            "w1": (rng.standard_normal((E, d, f)) * 0.2).astype(np.float32),
            "w3": (rng.standard_normal((E, d, f)) * 0.2).astype(np.float32),
            "w2": (rng.standard_normal((E, f, d)) * 0.2).astype(np.float32)}


class Cfg:
    n_experts = 8
    top_k = 2
    capacity_factor = 8.0
    cap_e_mult = 64


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "phantom"])
def test_route_equals_jax(case):
    p = _layer(0, 24, 12, 16, 8)
    router = np.zeros_like(p["router"]) if case == "ties" else p["router"]
    n_real = 5 if case == "phantom" else None
    for k in (1, 2, 3):
        ti, tv, aux = M._route(_t(p["x"]), _t(router), k, n_real)
        ji, jv, jaux = jax.jit(JM._route, static_argnums=(2, 3))(
            jnp.asarray(p["x"]), jnp.asarray(router), k, n_real)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
        if case == "ties":
            assert (ti.numpy() == np.arange(k)).all()
            assert bool((tv == 1.0 / k).all())
        if case == "phantom":
            assert int(ti.max()) < n_real


# ---------------------------------------------------------------------------
# the local path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.5, 8.0], ids=["dropping", "no-drop"])
def test_moe_local_equals_jax(cf):
    p = _layer(1, 40, 12, 16, 8)
    kw = dict(top_k=2, capacity_factor=cf, cap_e_mult=4, n_real=7)
    names = ("x", "router", "w1", "w3", "w2")
    y, aux = M._moe_local(*(_t(p[k]) for k in names), **kw)
    jax_moe = jax.jit(lambda cf, *a: JM._moe_local(
        *a, **{**kw, "ep": 1, "capacity_factor": cf}), static_argnums=0)
    jy, jaux = jax_moe(cf, *(jnp.asarray(p[k]) for k in names))
    _close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # cap_s = max(8, ceil(80 * cf)): 40 slots for 80 copies drop half
    full, _ = jax_moe(8.0, *(jnp.asarray(p[k]) for k in names))
    assert (cf < 1) == (not np.allclose(np.asarray(jy), np.asarray(full)))


@pytest.mark.parametrize("top_k,cap_e_mult", [(1, 4), (2, 2)])
def test_moe_local_drops_at_the_expert_capacity(top_k, cap_e_mult):
    """16 tokens, every one routed first to expert 3 (a large constant on
    its router row of a positive feature), no copy dropped at the send
    bucket: cap_e = min(flat, max(8, ceil(flat / E) * cap_e_mult)) = 8
    slots for expert 3's 16 copies, so half of them drop -- as in JAX,
    where ceil(flat / E) < 8 and the floor of 8 applies after the
    multiplier."""
    p = _layer(4, 16, 12, 16, 8)
    p["x"][:, 0] = 1.0 + np.abs(p["x"][:, 0])
    p["router"][0, 3] += 40.0
    names = ("x", "router", "w1", "w3", "w2")
    kw = dict(top_k=top_k, capacity_factor=1.0, cap_e_mult=cap_e_mult,
              n_real=8)
    y, aux = M._moe_local(*(_t(p[k]) for k in names), **kw)
    ti, _, _ = M._route(_t(p["x"]), _t(p["router"]), top_k, 8)
    assert (ti[:, 0] == 3).all()
    jax_moe = jax.jit(lambda mult, *a: JM._moe_local(
        *a, **{**kw, "ep": 1, "cap_e_mult": mult}), static_argnums=0)
    jy, jaux = jax_moe(cap_e_mult, *(jnp.asarray(p[k]) for k in names))
    _close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # with room for all 16 copies of expert 3 the output differs
    full, _ = jax_moe(64, *(jnp.asarray(p[k]) for k in names))
    assert not np.allclose(np.asarray(jy), np.asarray(full))
    # the rows of 8 tokens lose expert 3's contribution
    lost = ~np.isclose(np.asarray(jy), np.asarray(full)).all(axis=1)
    assert lost.sum() == 8


def test_moe_lm_grads_equal_jax():
    """tests/test_models_lm_recsys.py's MoE LM: every gradient equals JAX's,
    and those of w1, router and sw1 are non-zero."""
    kw = dict(name="tmoe", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
              d_head=16, d_ff=64, vocab=61, remat=False)
    moe = dict(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1)
    jcfg = JL.LMConfig(**kw, moe=JL.MoESettings(**moe), dtype=jnp.float32)
    cfg = L.LMConfig(**kw, moe=L.MoESettings(**moe), dtype=torch.float32)
    jp = JL.init_params(jcfg, jax.random.key(2))
    model = load_jax_params(L.init_params(cfg, device="cpu"),
                            jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(1).integers(0, 61, (2, 8)).astype(np.int32)
    jg = jax.jit(jax.grad(lambda p: JL.loss_fn(
        jcfg, p, jnp.asarray(toks), jnp.asarray(toks))))(jp)
    loss = model.loss(_t(toks), _t(toks))
    grads = dict(zip((k for k, _ in model.named_parameters()),
                     torch.autograd.grad(loss, list(model.parameters()))))
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        _close(grads[".".join(k.key for k in path)], g)
    for k in ("mlp.w1", "mlp.router", "mlp.sw1"):
        assert float(grads[k].abs().sum()) > 0


def test_moe_quant_dispatch_close_to_exact():
    """The int8 codec applied to the input by hand (EP = 1 skips the
    all_to_all): same routing, a small error, both numbers JAX's."""
    ks = jax.random.split(jax.random.key(0), 5)
    x = jax.random.normal(ks[0], (16, 12))
    mp = {"router": jax.random.normal(ks[1], (12, 8)) * 0.3,
          "w1": jax.random.normal(ks[2], (8, 12, 16)) * 0.2,
          "w3": jax.random.normal(ks[3], (8, 12, 16)) * 0.2,
          "w2": jax.random.normal(ks[4], (8, 16, 12)) * 0.2}
    kw = dict(top_k=2, capacity_factor=8.0, cap_e_mult=64, n_real=8)
    w = [mp[k] for k in ("router", "w1", "w3", "w2")]
    tw = [_t(a) for a in w]
    sc = jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0
    jxq = jnp.round(x / sc).astype(jnp.int8).astype(jnp.float32) * sc
    q, tsc = M._quantised(_t(x))
    xq = q.to(torch.float32) * tsc
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    y, _ = M._moe_local(_t(x), *tw, **kw)
    y_q, _ = M._moe_local(xq, *tw, **kw)
    rel = float(torch.linalg.norm(y_q - y) / torch.clamp(
        torch.linalg.norm(y), min=1e-9))
    jax_moe = jax.jit(lambda *a: JM._moe_local(*a, ep=1, **kw)[0])
    jy, jy_q = jax_moe(x, *w), jax_moe(jxq, *w)
    jrel = float(jnp.linalg.norm(jy_q - jy) / jnp.maximum(
        jnp.linalg.norm(jy), 1e-9))
    assert rel < 0.02, rel
    np.testing.assert_allclose(rel, jrel, rtol=1e-3)
    _close(y_q, jy_q)


def test_moe_apply_through_the_config_takes_the_local_path():
    p = _layer(3, 20, 12, 16, 8)
    mp = {k: _t(p[k]) for k in ("router", "w1", "w3", "w2")}
    y, aux = M.moe_apply(_t(p["x"]), mp, Cfg)
    jy, jaux = jax.jit(lambda x, w: JM.moe_apply(x, w, Cfg))(
        jnp.asarray(p["x"]), {k: jnp.asarray(p[k]) for k in mp})
    _close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    one = M.MoEShard(mesh=make_mesh((2, 1), ("data", "model"),
                                    device="cpu"),
                     token_axes=("data",), expert_axis="model")
    assert one.ep == 1
    y1, _ = M.moe_apply(_t(p["x"]), mp, Cfg, mesh=one)
    assert torch.equal(y1, y)


# ---------------------------------------------------------------------------
# EP on a stacked 2x2 mesh against shard_map
# ---------------------------------------------------------------------------

class EPCfg:
    n_experts = EP["n_real"]
    top_k = EP["top_k"]
    capacity_factor = EP["capacity_factor"]
    cap_e_mult = EP["cap_e_mult"]


@pytest.fixture(scope="module")
def ep_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_moe")
    p = _layer(4, EP["N"], EP["d"], EP["f"], EP["E"])
    p["gy"] = np.random.default_rng(5).standard_normal(
        (EP["N"], EP["d"])).astype(np.float32)
    np.savez(d / "in.npz", top_k=EP["top_k"], n_experts=EP["n_real"],
             capacity_factor=EP["capacity_factor"],
             cap_e_mult=EP["cap_e_mult"], **p)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, REF_SCRIPT, str(d / "in.npz"), str(d / "out.npz"),
         "2x2", "--moe"], capture_output=True, text=True, env=env,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return p, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("quant", [False, True], ids=["exact", "int8"])
@pytest.mark.parametrize("fsdp", [None, "data"], ids=["replicated", "fsdp"])
def test_ep_on_a_stacked_mesh_equals_shard_map(ep_data, quant, fsdp):
    p, ref = ep_data
    tag = f"moe_{int(quant)}_{fsdp}"
    mesh = M.MoEShard(mesh=make_mesh((2, 2), ("data", "model"),
                                     device="cpu"),
                      token_axes=("data", "model"), expert_axis="model",
                      fsdp_axis=fsdp, quant_dispatch=quant)
    assert mesh.ep == 2
    names = ("x", "router", "w1", "w3", "w2")
    args = {k: _t(p[k]).requires_grad_() for k in names}
    mp = {k: args[k] for k in names[1:]}
    y, aux = M.moe_apply(args["x"], mp, EPCfg, mesh=mesh)
    _close(y, ref[f"{tag}_y"])
    np.testing.assert_allclose(float(aux.detach()), float(ref[f"{tag}_aux"]),
                               rtol=1e-6)
    grads = torch.autograd.grad(torch.sum(y * _t(p["gy"])) + aux,
                                [args[k] for k in names])
    for k, g in zip(names, grads):
        _close(g, ref[f"{tag}_g{k}"])
    local, _ = M.moe_apply(args["x"], mp, EPCfg)
    assert not np.allclose(local.detach().numpy(), ref[f"{tag}_y"],
                           atol=1e-3)


def test_ep_over_a_process_group_raises():
    pm = ProcessMesh(shape=(2, 2), axis_names=("data", "model"), rank=0,
                     world=1, i0=0, j0=0, Rl=2, Cl=2,
                     device=torch.device("cpu"), backend="gloo")
    shard = M.MoEShard(mesh=pm, token_axes=("data", "model"),
                       expert_axis="model")
    p = _layer(6, 8, 12, 16, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP A21"):
        M.moe_apply(_t(p["x"]), {k: _t(p[k]) for k in
                                 ("router", "w1", "w3", "w2")}, Cfg,
                    mesh=shard)
