"""Carry a partitioned graph from the JAX package into the port.

`graph_from_partition` takes the arrays of `repro.core.partition.
partition_2d` (numpy, leading (R, C) dims) and builds the port's
`LocalGraph2D` on a device, and `csr_from_partition` does the same for the
CSR twin of `partition_2d_csr`, and `edge_vals_from_partition` for the
per-edge values of `partition_edge_vals(_csr)` (SSSP's weights), so both
packages can search the very same partition with the very same weights.

`load_jax_params` copies a JAX parameter tree (nested dicts and lists of
numpy arrays, as `jax.tree.map(np.asarray, params)` gives) into a model of
the port, whose parameter names are the tree's paths (`layers.0.w_self`,
`mlp.2`, `embed`), and `params_to_numpy` gives the tree back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import Grid2D, LocalGraph2D


def graph_from_partition(grid: Grid2D, col_off, row_idx, nnz,
                         device) -> LocalGraph2D:
    """(R, C, ncl + 1), (R, C, e_max), (R, C) int32 arrays -> LocalGraph2D
    on `device`, shapes checked against `grid`."""
    arrays = {"col_off": col_off, "row_idx": row_idx, "nnz": nnz}
    out = {k: torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)
           for k, a in arrays.items()}
    R, C, ncl = grid.R, grid.C, grid.n_cols_local
    if (out["col_off"].shape != (R, C, ncl + 1)
            or out["row_idx"].dim() != 3
            or out["row_idx"].shape[:2] != (R, C)
            or out["nnz"].shape != (R, C)):
        raise ValueError(
            f"partition shapes {[tuple(t.shape) for t in out.values()]} do "
            f"not fit grid {R}x{C} with {ncl} local columns")
    return LocalGraph2D(**out)


def csr_from_partition(grid: Grid2D, row_off, col_idx, nnz, device) -> dict:
    """(R, C, nrl + 1), (R, C, e_max), (R, C) int32 arrays -> the port's
    CSR twin dict on `device`, shapes checked against `grid`."""
    arrays = {"row_off": row_off, "col_idx": col_idx, "nnz": nnz}
    out = {k: torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)
           for k, a in arrays.items()}
    R, C, nrl = grid.R, grid.C, grid.n_rows_local
    if (out["row_off"].shape != (R, C, nrl + 1)
            or out["col_idx"].dim() != 3
            or out["col_idx"].shape[:2] != (R, C)
            or out["nnz"].shape != (R, C)):
        raise ValueError(
            f"CSR shapes {[tuple(t.shape) for t in out.values()]} do not "
            f"fit grid {R}x{C} with {nrl} local rows")
    return out


def edge_vals_from_partition(grid: Grid2D, vals, device) -> torch.Tensor:
    """(R, C, e_max) per-edge values (numpy, any integer dtype, e.g. the
    uint8 weights of `partition_edge_vals`) -> a tensor of that dtype on
    `device`, its leading dims checked against `grid`."""
    out = torch.as_tensor(np.asarray(vals), device=device)
    if out.dim() != 3 or out.shape[:2] != (grid.R, grid.C):
        raise ValueError(f"edge values of shape {tuple(out.shape)} do not "
                         f"fit grid {grid.R}x{grid.C}")
    return out


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _tensor(leaf) -> torch.Tensor:
    """A numpy leaf as a CPU tensor; JAX's bfloat16 leaves (numpy's
    `ml_dtypes.bfloat16`, which `torch.from_numpy` refuses) carried bit for
    bit through a uint16 view."""
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_jax_params(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a JAX parameter tree into `module` (in place, returned): every
    leaf to the parameter named by its path.  Raises ValueError on a
    missing or extra leaf, or a leaf whose shape or dtype differs from
    its parameter's."""
    leaves = dict(_flatten(tree))
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise ValueError(f"parameter tree does not fit the module: missing "
                         f"{missing}, extra {extra}")
    for name, p in params.items():
        src = _tensor(leaves[name])
        if tuple(src.shape) != tuple(p.shape) or src.dtype != p.dtype:
            raise ValueError(
                f"{name}: the tree holds {tuple(src.shape)} {src.dtype}, "
                f"the module {tuple(p.shape)} {p.dtype}")
        with torch.no_grad():
            p.copy_(src.to(p.device))
    return module


def params_to_numpy(module: torch.nn.Module):
    """The module's parameters as a JAX-shaped tree of numpy arrays: dicts
    by name, lists where every key of a level is 0 .. k-1."""
    root = {}
    for name, p in module.named_parameters():
        *path, last = name.split(".")
        node = root
        for key in path:
            node = node.setdefault(key, {})
        node[last] = p.detach().cpu().numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if set(out) == {str(i) for i in range(len(out))}:
            return [out[str(i)] for i in range(len(out))]
        return out
    return lists(root)
