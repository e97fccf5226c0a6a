"""The perf hillclimb on the PyTorch port, the twin of
scripts/hillclimb.py.

Each experiment is a dry-run cell plus a variant: its step is traced once
on the meta device over the production `StackedMesh` (16x16, or 2x16x16
for `@2pods`; `launch/mesh.py`) and reduced to roofline terms at the
H100's datasheet rates (`launch/dryrun.trace_spec`, `launch/roofline.py`).
Nothing is allocated, no card is used (CUDA is hidden) and no JAX is
imported.  The terms are counts of shapes times datasheet rates, not
measurements.

    PYTHONPATH=src python scripts/torch_hillclimb.py [exp_name ...]

No names runs all 15 experiments of `EXPS`, in its order.  Each record
goes to hillclimb_results.json in the working directory, written after
every experiment; a name already in the file is skipped, and an
experiment that raises is recorded with status "error", its message and
the tail of its traceback, and the next one runs.  A record holds
status, lower_s (build and trace seconds), compute_s, memory_s,
collective_s, dominant, flops, hbm_bytes, wire_bytes (per device),
arg_gib and temp_gib (per device), detail (wire bytes by collective) and
variant.

The BFS experiments trace one top-down level with a full frontier and one
chunk of the engine's own `edge_chunk` a processor, then `finalize`
(`configs/bfs_rmat._one_level`): JAX's analyzer weights the level loop
and the chunk loop once.
"""
import importlib
import json
import math
import os
import sys
import time
import traceback
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

OUT = "hillclimb_results.json"

_KIMI = ("kimi_k2_1t_a32b", "train_4k")
_FSDP_CAP_QUANT = {"moe_fsdp_axis": "data", "capacity_factor": 1.0,
                   "moe_quant": True}

# name -> (cell, positional arguments, keyword arguments): scripts/
# hillclimb.py's experiments, in its order, with its arguments
EXPS = {
    # --- cell A: kimi-k2 x train_4k (1T MoE) ---
    "kimi_train/base": ("lm_cell", _KIMI, {}),
    "kimi_train/fsdp": ("lm_cell", _KIMI + ({"moe_fsdp_axis": "data"},),
                        {}),
    "kimi_train/fsdp+cap1.0": ("lm_cell", _KIMI + (
        {"moe_fsdp_axis": "data", "capacity_factor": 1.0},), {}),
    "kimi_train/fsdp+cap1.0+quant": ("lm_cell", _KIMI + (_FSDP_CAP_QUANT,),
                                     {}),
    "kimi_train/fsdp+cap1.0+quant+mb4": ("lm_cell", _KIMI + (
        dict(_FSDP_CAP_QUANT, microbatches=4),), {}),
    "kimi_train/fsdp+cap1.0+quant@2pods": ("lm_cell", _KIMI + (
        _FSDP_CAP_QUANT,), {"multi": True}),
    # --- cell B: gemma2-2b x decode_32k ---
    "gemma_decode/base": ("lm_cell", ("gemma2_2b", "decode_32k"), {}),
    "gemma_decode/seqshard": ("lm_cell", ("gemma2_2b", "decode_32k",
                                          {"cache_seq_shard": True}), {}),
    # --- cell C: graphsage x ogb_products (the paper's expand/fold SpMM) ---
    "sage_products/base": ("sage_cell", ("f32",), {}),
    "sage_products/bf16": ("sage_cell", ("bf16",), {}),
    # --- the paper's own workload ---
    "bfs/base": ("bfs_cell", (), {}),
    "bfs/sort_dedup": ("bfs_cell", (), {"dedup": "sort"}),
    "bfs/fold_bitmap": ("bfs_cell", (), {"fold_bitmap": True}),
    "bfs/sort+bitmap": ("bfs_cell", (), {"dedup": "sort",
                                         "fold_bitmap": True}),
    "bfs/chunk_256k": ("bfs_cell", (), {"edge_chunk": 1 << 18}),
}


def production_mesh(multi: bool = False):
    """(the production `StackedMesh` on the meta device, its MeshAxes)."""
    from repro_torch.launch.mesh import make_production_mesh, mesh_axes
    mesh = make_production_mesh(multi_pod=multi)
    return mesh, mesh_axes(mesh)


def lm_cell(arch_mod, shape, variant=None, multi=False):
    from repro_torch.configs.lm_common import build_lm_dryrun
    mesh, axes = production_mesh(multi)
    cfg = importlib.import_module(f"repro_torch.configs.{arch_mod}").CONFIG
    spec = build_lm_dryrun(cfg, shape, mesh, axes, variant=variant)
    return spec, mesh, {"variant": variant}


def bf16_floats(tree):
    """Every float32 leaf of a tree of meta tensors as a bfloat16 one."""
    import torch
    if isinstance(tree, dict):
        return {k: bf16_floats(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(bf16_floats(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return torch.empty(tree.shape, dtype=torch.bfloat16,
                           device=tree.device)
    return tree


def sage_cell(dtype="f32"):
    from repro_torch.configs import graphsage_reddit as gs
    from repro_torch.configs.gnn_common import build_sage_dryrun
    mesh, axes = production_mesh()
    spec = build_sage_dryrun(gs.CONFIG, "ogb_products", mesh, axes)
    if dtype == "bf16":
        # features AND params in bf16 (otherwise layer outputs promote
        # back to f32 and only the first gather shrinks)
        spec.args = bf16_floats(spec.args)
    return spec, mesh, {"variant": {"dtype": dtype}}


def bfs_cell(**kw):
    import torch

    from repro_torch.configs.bfs_rmat import EDGE_FACTOR, TABLE1, _one_level
    from repro_torch.configs.common import DryrunSpec
    from repro_torch.core.bfs2d import BFS2D
    from repro_torch.core.types import Grid2D
    mesh, axes = production_mesh()
    _, scale = TABLE1[mesh.size]
    # 16x16 on the single pod (JAX's R = 16, or 32 over two pods; C = 16)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    R = math.prod(sizes[a] for a in axes.dp)
    C = sizes[axes.tp]
    grid = Grid2D.for_vertices(1 << scale, R, C)
    e_max = int(2 * EDGE_FACTOR * (1 << scale) / (R * C) * 1.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        bfs = BFS2D(grid, mesh, row_axes=axes.dp, col_axes=(axes.tp,),
                    edge_chunk=kw.pop("edge_chunk", 1 << 20), **kw)
    i32 = dict(dtype=torch.int32, device=mesh.device)
    args = (torch.empty((R, C, grid.n_cols_local + 1), **i32),
            torch.empty((R, C, e_max), **i32), torch.empty((R, C), **i32),
            torch.empty((), **i32))
    spec = DryrunSpec(fn=lambda *a: _one_level(bfs.engine, *a), args=args,
                      in_splits=None, out_splits=None)
    return spec, mesh, {"variant": kw}


CELLS = {"lm_cell": lm_cell, "sage_cell": sage_cell, "bfs_cell": bfs_cell}


def build(name):
    """(spec, mesh, extra record fields) of experiment `name`."""
    cell, args, kw = EXPS[name]
    return CELLS[cell](*args, **dict(kw))


def run(name, build, results, path=OUT):
    """Trace one experiment (`build()` -> (spec, mesh, extra)) into
    results[name] and write every result to `path`."""
    from repro_torch.launch.dryrun import trace_spec, write_results
    if name in results:
        print(f"[skip] {name}")
        return
    t0 = time.time()
    try:
        spec, mesh, extra = build()
        mem, rl = trace_spec(spec, mesh)
        rec = dict(status="ok", lower_s=round(time.time() - t0, 1),
                   compute_s=rl.compute_s, memory_s=rl.memory_s,
                   collective_s=rl.collective_s, dominant=rl.dominant,
                   flops=rl.flops, hbm_bytes=rl.hbm_bytes,
                   wire_bytes=rl.wire_bytes,
                   arg_gib=mem["argument_bytes"] / 2**30,
                   temp_gib=mem["temp_bytes"] / 2**30,
                   detail={k: v for k, v in rl.collective_detail.items()
                           if not k.startswith("_")}, **(extra or {}))
        print(f"[ok] {name}: dom={rl.dominant} c={rl.compute_s:.3e} "
              f"m={rl.memory_s:.3e} w={rl.collective_s:.3e} "
              f"arg={rec['arg_gib']:.1f}GiB tmp={rec['temp_gib']:.1f}GiB",
              flush=True)
    except Exception as e:  # noqa: BLE001 -- record and go on
        rec = dict(status="error", error=f"{type(e).__name__}: {e}",
                   tb=traceback.format_exc()[-1500:])
        print(f"[FAIL] {name}: {rec['error'][:200]}", flush=True)
    results[name] = rec
    write_results(results, path)


def main(argv=None):
    # the trace needs no card: hide it before anything initialises CUDA
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    results = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)
    wanted = (sys.argv[1:] if argv is None else argv) or list(EXPS)
    for name in wanted:
        run(name, lambda n=name: build(n), results)


if __name__ == "__main__":
    main()
