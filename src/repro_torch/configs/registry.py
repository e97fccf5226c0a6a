"""Architecture registry, the port of `repro/configs/registry.py`: --arch
<id> resolution for the dry run and the smokes.  Each `ArchDef.smoke(
device=None)` runs on the card unless given "cpu"; `build_dryrun(shape,
mesh, axes)` gives the `DryrunSpec` `launch/dryrun.py` traces."""
from __future__ import annotations

import functools
import importlib

from repro_torch.configs.common import ArchDef


def _source(mod) -> str:
    return mod.__doc__.split("\n")[0]


def _lm(arch_module_name: str) -> ArchDef:
    from repro_torch.configs import lm_common as LC
    mod = importlib.import_module(f"repro_torch.configs.{arch_module_name}")
    cfg = mod.CONFIG
    return ArchDef(
        arch_id=cfg.name, family="lm", shapes=tuple(LC.SHAPES),
        skip_shapes=mod.SKIP_SHAPES,
        build_dryrun=functools.partial(LC.build_lm_dryrun, cfg),
        smoke=functools.partial(LC.smoke_lm, cfg), source=_source(mod))


def _make_archs() -> dict:
    from repro_torch.configs import bfs_rmat as BF
    from repro_torch.configs import deepfm as df
    from repro_torch.configs import egnn as eg
    from repro_torch.configs import gnn_common as GC
    from repro_torch.configs import graphsage_reddit as gs
    from repro_torch.configs import mace as mc
    from repro_torch.configs import nequip as nq
    from repro_torch.configs import recsys_common as RC

    archs = {}
    for m in ("kimi_k2_1t_a32b", "qwen2_moe_a2_7b", "glm4_9b", "gemma2_2b",
              "h2o_danube_1_8b"):
        a = _lm(m)
        archs[a.arch_id] = a

    archs["nequip"] = ArchDef(
        "nequip", "gnn", tuple(GC.SHAPES),
        functools.partial(GC.build_equiv_dryrun, nq.CONFIG),
        functools.partial(GC.smoke_equiv, 1), nq.SKIP_SHAPES, _source(nq))
    archs["mace"] = ArchDef(
        "mace", "gnn", tuple(GC.SHAPES),
        functools.partial(GC.build_equiv_dryrun, mc.CONFIG),
        functools.partial(GC.smoke_equiv, 3), mc.SKIP_SHAPES, _source(mc))
    archs["graphsage-reddit"] = ArchDef(
        "graphsage-reddit", "gnn", tuple(GC.SHAPES),
        functools.partial(GC.build_sage_dryrun, gs.CONFIG),
        GC.smoke_sage, gs.SKIP_SHAPES, _source(gs))
    archs["egnn"] = ArchDef(
        "egnn", "gnn", tuple(GC.SHAPES),
        functools.partial(GC.build_egnn_dryrun, eg.CONFIG),
        GC.smoke_egnn, eg.SKIP_SHAPES, _source(eg))
    archs["deepfm"] = ArchDef(
        "deepfm", "recsys", tuple(RC.SHAPES),
        functools.partial(RC.build_deepfm_dryrun, df.CONFIG),
        RC.smoke_deepfm, df.SKIP_SHAPES, _source(df))
    archs["bfs-rmat"] = ArchDef(
        "bfs-rmat", "bfs", tuple(BF.SHAPES),
        functools.partial(BF.build_bfs_dryrun, None),
        BF.smoke_bfs, BF.SKIP_SHAPES, _source(BF))
    return archs


ARCHS = _make_archs()


def get_arch(arch_id: str) -> ArchDef:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]
