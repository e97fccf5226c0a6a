"""The JAX package's dry-run specs as JSON, for the port's dry-run tests
(tests/test_torch_dryrun.py): no lowering, only the specs' shapes.

    torch_dryrun_ref.py OUT.json

Runs on 512 forced host devices (set here, before jax is imported).  For
every architecture of `repro.configs.ARCHS`, every shape not in its
skip_shapes and both production meshes (16x16, 2x16x16) it builds the cell's `DryrunSpec` and records every argument leaf in JAX's
leaf order: its path (dict keys and sequence indices), shape, dtype and
per-device shard shape under the spec's in_shardings (`NamedSharding.
shard_shape`; a None sharding is a replicated leaf).  Also records
`repro.launch.dryrun.model_flops_global` of every LM cell, and the
arguments of each VARIANTS entry's spec: `build_lm_dryrun` under the
knobs scripts/hillclimb.py passes, on the entry's mesh, and its
graphsage-reddit ogb_products cell with every float32 leaf cast to
bfloat16 as its `sage_cell("bf16")` does.  OUT.json:
{"cells": {"arch|shape|mesh": [[path, shape, dtype, shard], ...]},
 "model_flops": {"arch|shape": float}, "variants": {name: rows},
 "variant_args": {name: [module, shape, variant, mesh]}}.
"""
import importlib
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs.lm_common import build_lm_dryrun  # noqa: E402
from repro.launch.dryrun import model_flops_global  # noqa: E402
from repro.launch.mesh import make_production_mesh, mesh_axes  # noqa: E402


_KIMI_KNOBS = dict(moe_fsdp_axis="data", capacity_factor=1.0,
                  moe_quant=True)

# name -> (config module, shape, variant, mesh): every knob of
# `build_lm_dryrun`, then scripts/hillclimb.py's LM and GraphSAGE
# experiments under their names (the graphsage_reddit entry's variant is
# its dtype)
VARIANTS = {
    "moe_train_knobs": ("qwen2_moe_a2_7b", "train_4k", dict(
        microbatches=2, moe_fsdp_axis="data", moe_quant=True,
        capacity_factor=2.0, remat=False, token_axes=("data",)), "single"),
    "decode_seq_shard": ("qwen2_moe_a2_7b", "decode_32k",
                         dict(cache_seq_shard=True), "single"),
    "dense_microbatches": ("gemma2_2b", "train_4k", dict(microbatches=4),
                           "single"),
    "kimi_train/base": ("kimi_k2_1t_a32b", "train_4k", None, "single"),
    "kimi_train/fsdp": ("kimi_k2_1t_a32b", "train_4k",
                        dict(moe_fsdp_axis="data"), "single"),
    "kimi_train/fsdp+cap1.0": ("kimi_k2_1t_a32b", "train_4k", dict(
        moe_fsdp_axis="data", capacity_factor=1.0), "single"),
    "kimi_train/fsdp+cap1.0+quant": ("kimi_k2_1t_a32b", "train_4k",
                                     _KIMI_KNOBS, "single"),
    "kimi_train/fsdp+cap1.0+quant+mb4": ("kimi_k2_1t_a32b", "train_4k",
                                         dict(_KIMI_KNOBS, microbatches=4),
                                         "single"),
    "kimi_train/fsdp+cap1.0+quant@2pods": ("kimi_k2_1t_a32b", "train_4k",
                                           _KIMI_KNOBS, "multi"),
    "gemma_decode/base": ("gemma2_2b", "decode_32k", None, "single"),
    "gemma_decode/seqshard": ("gemma2_2b", "decode_32k",
                              dict(cache_seq_shard=True), "single"),
    "sage_products/base": ("graphsage_reddit", "ogb_products",
                           {"dtype": "f32"}, "single"),
    "sage_products/bf16": ("graphsage_reddit", "ogb_products",
                           {"dtype": "bf16"}, "single"),
}


def variant_spec(mod, shape, variant, mesh):
    """The spec scripts/hillclimb.py lowers for one VARIANTS entry."""
    if mod != "graphsage_reddit":
        cfg = importlib.import_module(f"repro.configs.{mod}").CONFIG
        return build_lm_dryrun(cfg, shape, mesh, mesh_axes(mesh),
                               variant=variant)
    import jax.numpy as jnp

    from repro.configs.gnn_common import build_sage_dryrun
    gs = importlib.import_module(f"repro.configs.{mod}")
    spec = build_sage_dryrun(gs.CONFIG, shape, mesh, mesh_axes(mesh))
    if variant["dtype"] == "bf16":
        def cast(x):
            if hasattr(x, "dtype") and x.dtype == jnp.float32:
                return jax.ShapeDtypeStruct(x.shape, jnp.bfloat16)
            return x
        spec.args = jax.tree.map(cast, spec.args)
    return spec


def _key(k):
    if isinstance(k, jax.tree_util.DictKey):
        return k.key
    if isinstance(k, jax.tree_util.SequenceKey):
        return k.idx
    raise TypeError(f"unexpected key {k!r}")


def leaves(args, shardings):
    """[(path, leaf, sharding or None)]: a None or NamedSharding where the
    args have a subtree applies to all of it (JAX's prefix rule)."""
    def walk(t, s, prefix):
        if t is None:
            return []
        if s is None or isinstance(s, NamedSharding):
            flat, _ = jax.tree_util.tree_flatten_with_path(t)
            return [(prefix + tuple(_key(k) for k in p), leaf, s)
                    for p, leaf in flat]
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in walk(t[k], s[k],
                                                       prefix + (k,))]
        return [x for i, v in enumerate(t) for x in walk(v, s[i],
                                                         prefix + (i,))]
    return walk(args, shardings, ())


def rows(spec):
    out = []
    for path, leaf, s in leaves(spec.args, spec.in_shardings):
        shard = tuple(leaf.shape) if s is None \
            else tuple(s.shard_shape(leaf.shape))
        out.append([list(path), list(leaf.shape), str(leaf.dtype),
                    list(shard)])
    return out


def main():
    out_path = sys.argv[1]
    meshes = {"single": make_production_mesh(multi_pod=False),
              "multi": make_production_mesh(multi_pod=True)}
    cells, mflops = {}, {}
    for arch_id in sorted(ARCHS):
        arch = ARCHS[arch_id]
        for shape in arch.shapes:
            if shape in arch.skip_shapes:
                continue
            if arch.family == "lm":
                mflops[f"{arch_id}|{shape}"] = model_flops_global(arch,
                                                                  shape)
            for kind, mesh in meshes.items():
                spec = arch.build_dryrun(shape, mesh, mesh_axes(mesh))
                cells[f"{arch_id}|{shape}|{kind}"] = rows(spec)
    variants = {}
    for name, (mod, shape, variant, kind) in VARIANTS.items():
        variants[name] = rows(variant_spec(mod, shape, variant,
                                           meshes[kind]))
    with open(out_path, "w") as f:
        json.dump({"cells": cells, "model_flops": mflops,
                   "variants": variants,
                   "variant_args": {k: list(v) for k, v in
                                    VARIANTS.items()}}, f)
    print("OK")


if __name__ == "__main__":
    main()
