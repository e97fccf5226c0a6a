"""The distributed-engine layer (the port of `repro.dist`): the grid
topologies (stacked on one device, or a rank's block of a
`torch.distributed` process group: `topology`, `multihost`), the mesh
descriptor (`compat.make_mesh`), the exchange strategies, the fold codecs
and `DistBFSEngine`.

Re-exports are PEP 562 lazy, as in the JAX package: `from repro_torch.dist
import multihost` (the first thing a process-group worker does) does not
pull the engine in.  The JAX package's `shard_map` and `axis_types_kwargs`
have no counterpart (`dist/compat.py` says why).
"""
_EXPORTS = {
    "make_mesh": "repro_torch.dist.compat",
    "Topology": "repro_torch.dist.topology",
    "FOLD_CODECS": "repro_torch.dist.exchange",
    "get_fold_codec": "repro_torch.dist.exchange",
    "DistBFSEngine": "repro_torch.dist.engine",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(target), name)
