"""The port's architecture registry, dry run and roofline
(`repro_torch.configs.registry`, `launch/dryrun.py`, `launch/roofline.py`,
`launch/mesh.py`) against the JAX package's, on the CPU:

  * the registry: the same ids, families, shapes, skip_shapes and source
    lines as `repro.configs.ARCHS`; the port's copies of
    tests/test_arch_smokes.py (all assigned archs, 40 cells, every smoke,
    here with device="cpu");
  * every arch x shape x mesh cell's spec: its argument leaves have the
    JAX spec's paths, shapes and dtypes, and each leaf's per-device shard
    shape under the port's splits equals `NamedSharding.shard_shape` under
    JAX's in_shardings (tests/dist/torch_dryrun_ref.py, one child on 512
    forced host devices, specs built without lowering); and
    `model_flops_global` of every LM cell equals JAX's;
  * FLOPs: the port's count of a traced step equals `analyze_hlo`'s count
    of the JAX step compiled on the CPU, exactly, at the smoke widths --
    prefill, decode and train (remat=False) of a dense LM and of the MoE
    LM at EP = 1, DeepFM's serve and train steps, and GraphSAGE's loss
    gradient; with remat=True the port's count is the forward recomputed
    whole (`torch.utils.checkpoint`), above JAX's, which recomputes only
    the attention dots (PERF.md);
  * the ring factors equal `parse_collective_bytes`' on the same size and
    group, and a 6-step matmul loop counts 6x (tests/test_roofline.py's
    scan), the stacked collectives record their wire bytes;
  * `python -m repro_torch.launch.dryrun` writes its resumable records:
    status ok with per-device memory (alias and code bytes null) and the
    roofline, skipped cells with JAX's reasons, and touches no card.
"""
import dataclasses
import functools
import importlib
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.launch import roofline as JR
from repro.models import lm as JL
from repro.models.gnn import graphsage as JGS
from repro.models.recsys import deepfm as JD
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.common import (abstract, apply_params, leaf_splits,
                                        param_tree, shard_shape,
                                        value_and_grad)
from repro_torch.dist import make_mesh, wire
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import make_production_mesh, mesh_axes
from repro_torch.models import lm as L
from repro_torch.models import moe as M
from repro_torch.models.common import cross_entropy
from repro_torch.models.gnn import graphsage as GS
from repro_torch.models.recsys import deepfm as D
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)

HERE = os.path.dirname(os.path.abspath(__file__))
REF_SCRIPT = os.path.join(HERE, "dist", "torch_dryrun_ref.py")
ROOT = os.path.dirname(HERE)
CELLS = [(a, s, m) for a in sorted(ARCHS) for s in ARCHS[a].shapes
         if s not in ARCHS[a].skip_shapes for m in ("single", "multi")]
LM_CELLS = [(a, s) for a in sorted(ARCHS) if ARCHS[a].family == "lm"
            for s in ARCHS[a].shapes if s not in ARCHS[a].skip_shapes]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_equals_jax():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for k, a in ARCHS.items():
        j = JAX_ARCHS[k]
        assert (a.arch_id, a.family, a.shapes, a.skip_shapes, a.source) == \
            (j.arch_id, j.family, j.shapes, j.skip_shapes, j.source), k


def test_registry_has_all_assigned():
    want = {"kimi-k2-1t-a32b", "qwen2-moe-a2.7b", "glm4-9b", "gemma2-2b",
            "h2o-danube-1.8b", "nequip", "mace", "graphsage-reddit", "egnn",
            "deepfm", "bfs-rmat"}
    assert want <= set(ARCHS)


def test_cells_count():
    """40 assigned cells: 5 LM x 4 + 4 GNN x 4 + 1 recsys x 4."""
    cells = sum(len(a.shapes) for a in ARCHS.values() if a.family != "bfs")
    assert cells == 40


@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_smoke(arch_id):
    get_arch(arch_id).smoke(device="cpu")


def test_get_arch_names_the_known_archs():
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


def test_production_meshes_are_meta_descriptors():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.shape, one.axis_names, one.device.type) == \
        ((16, 16), ("data", "model"), "meta")
    assert (two.shape, two.axis_names) == ((2, 16, 16),
                                           ("pod", "data", "model"))
    assert mesh_axes(one).dp == ("data",)
    assert mesh_axes(two).dp == ("pod", "data") and mesh_axes(two).tp == \
        "model"


# ---------------------------------------------------------------------------
# FLOPs of traced steps against analyze_hlo of the compiled JAX steps
# ---------------------------------------------------------------------------

def _small(mod, pkg, dtype, remat=False):
    """The arch's LM at the smoke widths (`smoke_lm`'s config)."""
    cfg = importlib.import_module(f"{pkg}.configs.{mod}").CONFIG
    lm = JL if pkg == "repro" else L
    return lm.LMConfig(
        name=cfg.name + "-smoke", n_layers=2, d_model=64,
        n_heads=min(4, cfg.n_heads), n_kv_heads=min(2, cfg.n_kv_heads),
        d_head=16, d_ff=128, vocab=256, rope_fraction=cfg.rope_fraction,
        attn_softcap=cfg.attn_softcap, logit_softcap=cfg.logit_softcap,
        window_pattern=tuple(min(w, 8) for w in cfg.window_pattern),
        post_norms=cfg.post_norms, tie_embeddings=cfg.tie_embeddings,
        moe=None if cfg.moe is None else lm.MoESettings(
            n_experts=8, top_k=min(2, cfg.moe.top_k), d_ff_expert=32,
            n_shared=min(1, cfg.moe.n_shared)),
        dtype=dtype, remat=remat)


def _jax_flops(fn, *args) -> float:
    return JR.analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())[
        "flops"]


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


B, T, CACHE = 2, 16, 32


@functools.lru_cache(maxsize=None)
def _lm_flops(mod, kind, remat=False):
    """(port FLOPs, JAX FLOPs) of one LM step at the smoke widths."""
    jc = _small(mod, "repro", jnp.float32, remat)
    tc = _small(mod, "repro_torch", torch.float32, remat)
    jp = jax.eval_shape(lambda k: JL.init_params(jc, k), jax.random.key(0))
    model = L.init_params(tc, None, "meta")
    tp = param_tree(model)
    jt, tt = _sds((B, T), jnp.int32), _meta((B, T), torch.int32)
    if kind == "prefill":
        want = _jax_flops(lambda p, t: JL.forward(jc, p, t)[0], jp, jt)
        got = R.count_step(lambda p, t: apply_params(model, p)(t)[0], tp, tt)
    elif kind == "decode":
        jcache = jax.eval_shape(lambda: JL.init_cache(jc, B, CACHE))
        want = _jax_flops(lambda p, c, t, pos: JL.decode_step(
            jc, p, c, t, pos), jp, jcache, _sds((B,), jnp.int32),
            _sds((), jnp.int32))
        cache = abstract(L.init_cache(tc, B, CACHE, device="meta"))
        got = R.count_step(apply_params(model, tp, "decode_step"), cache,
                           _meta((B,), torch.int32), _meta((), torch.int32))
    else:
        jtc = JTrainConfig(optimizer=JAdamWConfig())
        jstep = jmake_train_step(lambda p, b: JL.loss_fn(jc, p, b[0], b[1]),
                                 jtc)
        jst = jax.eval_shape(lambda p: jinit_state(jtc, p).tree(), jp)
        want = _jax_flops(jstep, jst, (jt, jt))
        ttc = TrainConfig(optimizer=AdamWConfig())
        step = make_train_step(lambda p, b: apply_params(model, p, "loss")(
            b[0], b[1]), ttc)
        got = R.count_step(step, abstract(init_state(ttc, tp).tree()),
                           (tt, tt))
    return got.flops, want


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("mod", ["h2o_danube_1_8b", "qwen2_moe_a2_7b"],
                         ids=["dense", "moe"])
def test_lm_flops_equal_analyze_hlo(mod, kind):
    got, want = _lm_flops(mod, kind)
    assert want > 0 and got == want


def test_remat_recomputes_the_layers_forward():
    """remat=True: `torch.utils.checkpoint` recomputes each layer's forward
    in the backward pass, up to the last tensor the backward needs (its
    early stop leaves out each layer's down-projection, whose output is
    not saved); XLA's compiled program recomputes only the attention
    dots, so JAX's count lies between the two."""
    got, want = _lm_flops("h2o_danube_1_8b", "train", remat=True)
    plain, jplain = _lm_flops("h2o_danube_1_8b", "train")
    fwd, _ = _lm_flops("h2o_danube_1_8b", "prefill")
    cfg = _small("h2o_danube_1_8b", "repro_torch", torch.float32)
    logits = 2 * B * T * cfg.d_model * cfg.vocab
    down = cfg.n_layers * 2 * B * T * cfg.d_ff * cfg.d_model
    assert plain == jplain
    assert got == plain + fwd - logits - down
    assert jplain < want < got


def test_deepfm_flops_equal_analyze_hlo():
    cfg = dataclasses.replace(D.DeepFMConfig(name="deepfm-smoke",
                                             embed_dim=4, mlp=(16, 16),
                                             vocabs=(8, 16, 32, 8)))
    jcfg = JD.DeepFMConfig(name="deepfm-smoke", embed_dim=4, mlp=(16, 16),
                           vocabs=(8, 16, 32, 8))
    jp = jax.eval_shape(lambda k: JD.init_params(jcfg, k), jax.random.key(0))
    model = D.init_params(cfg, None, "meta")
    tp = param_tree(model)
    idx, y = _sds((64, 4), jnp.int32), _sds((64,), jnp.float32)
    tidx, ty = _meta((64, 4), torch.int32), _meta((64,), torch.float32)
    want = _jax_flops(lambda p, i: JD.forward(jcfg, p, i), jp, idx)
    got = R.count_step(lambda p, i: apply_params(model, p)(i), tp, tidx)
    assert want > 0 and got.flops == want
    jtc = JTrainConfig(optimizer=JAdamWConfig())
    jstep = jmake_train_step(lambda p, b: JD.loss_fn(jcfg, p, b[0], b[1]),
                             jtc)
    want = _jax_flops(jstep, jax.eval_shape(
        lambda p: jinit_state(jtc, p).tree(), jp), (idx, y))
    ttc = TrainConfig(optimizer=AdamWConfig())
    step = make_train_step(lambda p, b: apply_params(model, p, "loss")(
        b[0], b[1]), ttc)
    got = R.count_step(step, abstract(init_state(ttc, tp).tree()),
                       (tidx, ty))
    # the logit layer's input gradient, g (64, 1) @ w.T (1, 16), has a
    # contraction of size 1: XLA rewrites that dot as a broadcast multiply,
    # which its dot count leaves out; torch's mm counts it
    assert got.flops == want + 2 * 64 * 1 * cfg.mlp[-1]


def test_graphsage_flops_equal_analyze_hlo():
    jcfg = JGS.SAGEConfig("sage-smoke", 2, 16, 8, 5)
    cfg = GS.SAGEConfig("sage-smoke", 2, 16, 8, 5)
    n, e = 128, 512
    jp = jax.eval_shape(lambda k: JGS.init_params(jcfg, k),
                        jax.random.key(0))
    want = _jax_flops(jax.grad(lambda p, x, s, d, lab: JGS.loss_fn(
        jcfg, p, x, s, d, lab)), jp, _sds((n, 8), jnp.float32),
        _sds((e,), jnp.int32), _sds((e,), jnp.int32), _sds((n,), jnp.int32))
    model = GS.init_params(cfg, None, "meta")
    step = value_and_grad(lambda p, x, s, d, lab: cross_entropy(
        apply_params(model, p)(x, s, d), lab))
    got = R.count_step(step, param_tree(model), _meta((n, 8), torch.float32),
                       _meta((e,), torch.int32), _meta((e,), torch.int32),
                       _meta((n,), torch.int32))
    assert want > 0 and got.flops == want


def test_a_matmul_loop_counts_every_trip():
    """tests/test_roofline.py's 6-step scan: the port traces the loop as
    it runs, so it counts 6x, as the JAX analyzer's trip-weighted body."""
    def loop(x, w):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x
    got = R.count_step(loop, _meta((64, 64), torch.float32),
                       _meta((6, 64, 64), torch.float32))
    assert got.flops == 2 * 64 ** 3 * 6
    assert got.bytes >= 6 * 3 * 64 * 64 * 4     # each matmul's operands


# ---------------------------------------------------------------------------
# wire bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,op,n", [
    ("all-gather", "all-gather", 4), ("all-gather", "all-gather", 16),
    ("all-reduce", "all-reduce", 2), ("all-reduce", "all-reduce", 256),
    ("all-to-all", "all-to-all", 16), ("reduce-scatter", "reduce-scatter",
                                       8),
    ("collective-permute", "collective-permute", 2)])
def test_ring_factors_equal_parse_collective_bytes(kind, op, n):
    ids = ",".join(str(i) for i in range(n))
    line = (f"  %c = f32[64,256]{{1,0}} {op}(%x), replica_groups={{{{{ids}}}}}"
            + (", source_target_pairs={{0,1}}" if op == "collective-permute"
               else ""))
    size = 64 * 256 * 4
    assert R.ring_bytes(kind, size, n) == JR.parse_collective_bytes(line)[
        kind]
    assert R.COLLECTIVES == JR.COLLECTIVES


def test_stacked_collectives_record_their_wire():
    """The MoE's four all_to_alls (x, expert ids, valid, y back) over a
    2-wide expert axis of a stacked 2x2 mesh and the 2D SpMM's expand and
    fold: each records (n-1)/n of the stacked tensor it moves."""
    class Cfg:
        n_experts, top_k, capacity_factor = 8, 2, 1.25
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    shard = M.MoEShard(mesh=mesh, token_axes=("data", "model"),
                       expert_axis="model")
    x = _meta((32, 12), torch.float32)
    mp = {"router": _meta((12, 8), torch.float32),
          "w1": _meta((8, 12, 16), torch.float32),
          "w3": _meta((8, 12, 16), torch.float32),
          "w2": _meta((8, 16, 12), torch.float32)}
    with wire.counting() as wc:
        M.moe_apply(x, mp, Cfg, mesh=shard)
    assert wc.counts["all-to-all"] == 4
    cap_s = max(8, math.ceil(8 * 2 / 2 * 1.25))
    slots = 4 * 2 * cap_s                       # D x ep x cap_s
    moved = slots * (12 * 4 + 4 + 1 + 12 * 4)   # x, ids, valid, y
    assert wc.bytes["all-to-all"] == moved / 2
    assert wc.total == wc.bytes["all-to-all"]


def test_the_backward_pass_records_the_transposed_collectives():
    """Differentiated, the MoE over a stacked 2x2 mesh with fsdp_axis
    records the float all_to_alls again (their transposes) and each FSDP
    all-gather's reduce-scatter, as JAX's differentiated program holds
    them; the integer ones (expert ids, valid) carry no gradient."""
    class Cfg:
        n_experts, top_k, capacity_factor = 8, 2, 1.25
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    shard = M.MoEShard(mesh=mesh, token_axes=("data", "model"),
                       expert_axis="model", fsdp_axis="data")
    x = _meta((32, 12), torch.float32).requires_grad_()
    mp = {k: _meta(s, torch.float32).requires_grad_() for k, s in (
        ("router", (12, 8)), ("w1", (8, 12, 16)), ("w3", (8, 12, 16)),
        ("w2", (8, 16, 12)))}
    with wire.counting() as wc:
        y, aux = M.moe_apply(x, mp, Cfg, mesh=shard)
        fwd = dict(wc.counts)
        torch.autograd.grad(y.sum() + aux, [x] + list(mp.values()))
    assert fwd["all-gather"] == 3 and fwd["reduce-scatter"] == 0
    assert wc.counts["all-to-all"] == fwd["all-to-all"] + 2
    assert wc.counts["reduce-scatter"] == 3
    assert wc.bytes["reduce-scatter"] == wc.bytes["all-gather"]


# ---------------------------------------------------------------------------
# the dry run's command line
# ---------------------------------------------------------------------------

def test_dryrun_cli_records_cells(tmp_path):
    """A cheap cell on both meshes through the module's command line with
    the card hidden, then a skipped cell and a rerun through `main`: each
    record as JAX's (arch, shape, mesh, status, note, lower_s, memory,
    roofline), alias and code bytes null, the skipped cell with JAX's
    reason; the rerun skips the done cell."""
    out = tmp_path / "dr.json"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--out", str(out), "--arch", "deepfm", "--shape",
                          "serve_p99", "--mesh", "both"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert DR.main(["--out", str(out), "--arch", "glm4-9b", "--shape",
                    "long_500k", "--mesh", "single"]) == 0
    with open(out) as f:
        recs = json.load(f)
    rec = recs["deepfm|serve_p99|single"]
    assert rec["status"] == "ok" and rec["note"] == "serve batch=512"
    assert rec["lower_s"] >= 0
    mem = rec["memory"]
    assert mem["alias_bytes"] is None and mem["code_bytes"] is None
    # the table and linear rows split over 256 devices; the MLP replicated
    cfg = importlib.import_module("repro_torch.configs.deepfm").CONFIG
    rows = -(-cfg.total_rows // 256)
    mlp = sum(i * o for i, o in zip(
        (cfg.n_fields * cfg.embed_dim,) + cfg.mlp, cfg.mlp + (1,)))
    idx = 512 // 16 * cfg.n_fields
    assert mem["argument_bytes"] == 4 * (rows * (cfg.embed_dim + 1) + mlp
                                         + 1 + idx)
    assert mem["output_bytes"] == 4 * 512 // 16
    rl = rec["roofline"]
    assert rl["flops"] > 0 and rl["dominant"] in ("compute", "memory")
    assert rl["compute_s"] == rl["flops"] / R.PEAK_FLOPS
    assert recs["deepfm|serve_p99|multi"]["roofline"]["flops"] == \
        rl["flops"] / 2
    skipped = recs["glm4-9b|long_500k|single"]
    assert skipped["status"] == "skipped" and skipped["reason"] == \
        JAX_ARCHS["glm4-9b"].skip_shapes["long_500k"]
    done = dict(recs)
    DR.run_cell("deepfm", "serve_p99", "single", done, str(out))
    assert done["deepfm|serve_p99|single"] == rec


def test_run_cell_records_the_moe_wire(tmp_path):
    """qwen2-moe decode on the single pod: the expert all_to_alls put
    bytes on the wire; the record's per-device figures are the stacked
    totals / 256."""
    results = {}
    DR.run_cell("qwen2-moe-a2.7b", "decode_32k", "single", results,
                str(tmp_path / "dr.json"))
    rec = results["qwen2-moe-a2.7b|decode_32k|single"]
    assert rec["status"] == "ok", rec.get("error")
    det = rec["roofline"]["collective_detail"]
    assert det["all-to-all"] > 0 and det["_counts"]["all-to-all"] == 24 * 4
    assert rec["roofline"]["wire_bytes"] == pytest.approx(
        sum(v for k, v in det.items() if k != "_counts"))


# ---------------------------------------------------------------------------
# every cell's spec against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def jax_specs_child(tmp_path_factory):
    """The JAX child, started when the module starts so that it runs
    beside the in-process tests: (Popen, its output path)."""
    out = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.Popen([sys.executable, REF_SCRIPT, str(out)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    yield p, out
    if p.poll() is None:
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def jax_specs(jax_specs_child):
    p, out = jax_specs_child
    _, err = p.communicate(timeout=300)
    assert p.returncode == 0, err[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def meshes():
    return {"single": make_production_mesh(),
            "multi": make_production_mesh(multi_pod=True)}


def _rows(spec, mesh):
    """[path, shape, dtype, per-device shard shape] of every argument leaf,
    as tests/dist/torch_dryrun_ref.py writes JAX's."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    assert all(leaf.device.type == "meta"
               for _, leaf, _ in leaf_splits(spec.args, spec.in_splits))
    return [[list(p), list(leaf.shape), str(leaf.dtype).replace("torch.", ""),
             list(shard_shape(leaf.shape, s, sizes))]
            for p, leaf, s in leaf_splits(spec.args, spec.in_splits)]


@pytest.mark.parametrize("arch_id,shape,mesh_kind", CELLS,
                         ids=["|".join(c) for c in CELLS])
def test_spec_arguments_and_shards_equal_jax(jax_specs, meshes, arch_id,
                                             shape, mesh_kind):
    mesh = meshes[mesh_kind]
    spec = get_arch(arch_id).build_dryrun(shape, mesh, mesh_axes(mesh))
    assert _rows(spec, mesh) == \
        jax_specs["cells"][f"{arch_id}|{shape}|{mesh_kind}"]


# tests/dist/torch_dryrun_ref.py's VARIANTS: scripts/hillclimb.py's knobs
VARIANTS = {
    "moe_train_knobs": ("qwen2_moe_a2_7b", "train_4k", dict(
        microbatches=2, moe_fsdp_axis="data", moe_quant=True,
        capacity_factor=2.0, remat=False, token_axes=("data",))),
    "decode_seq_shard": ("qwen2_moe_a2_7b", "decode_32k",
                         dict(cache_seq_shard=True)),
    "dense_microbatches": ("gemma2_2b", "train_4k", dict(microbatches=4)),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_lm_variant_arguments_and_shards_equal_jax(jax_specs, meshes, name):
    from repro_torch.configs.lm_common import build_lm_dryrun
    mod, shape, variant = VARIANTS[name]
    cfg = importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
    mesh = meshes["single"]
    spec = build_lm_dryrun(cfg, shape, mesh, mesh_axes(mesh),
                           variant=variant)
    assert _rows(spec, mesh) == jax_specs["variants"][name]


@pytest.mark.parametrize("arch_id,shape", LM_CELLS,
                         ids=["|".join(c) for c in LM_CELLS])
def test_model_flops_global_equals_jax(jax_specs, arch_id, shape):
    assert DR.model_flops_global(get_arch(arch_id), shape) == \
        jax_specs["model_flops"][f"{arch_id}|{shape}"]


def test_model_flops_global_is_none_off_the_lm_family():
    assert DR.model_flops_global(get_arch("deepfm"), "serve_p99") is None
