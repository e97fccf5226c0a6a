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
arguments of `build_lm_dryrun` under each VARIANTS entry (the knobs
scripts/hillclimb.py passes) on the single-pod mesh.  OUT.json:
{"cells": {"arch|shape|mesh": [[path, shape, dtype, shard], ...]},
 "model_flops": {"arch|shape": float}, "variants": {name: rows}}.
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


# name -> (LM config module, shape, variant)
VARIANTS = {
    "moe_train_knobs": ("qwen2_moe_a2_7b", "train_4k", dict(
        microbatches=2, moe_fsdp_axis="data", moe_quant=True,
        capacity_factor=2.0, remat=False, token_axes=("data",))),
    "decode_seq_shard": ("qwen2_moe_a2_7b", "decode_32k",
                         dict(cache_seq_shard=True)),
    "dense_microbatches": ("gemma2_2b", "train_4k", dict(microbatches=4)),
}


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
    mesh = meshes["single"]
    for name, (mod, shape, variant) in VARIANTS.items():
        cfg = importlib.import_module(f"repro.configs.{mod}").CONFIG
        variants[name] = rows(build_lm_dryrun(cfg, shape, mesh,
                                              mesh_axes(mesh),
                                              variant=variant))
    with open(out_path, "w") as f:
        json.dump({"cells": cells, "model_flops": mflops,
                   "variants": variants}, f)
    print("OK")


if __name__ == "__main__":
    main()
