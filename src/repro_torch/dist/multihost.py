"""Process-group bootstrap, placement and the wire (DESIGN.md sec. 14), the
port of `repro/dist/multihost.py` over `torch.distributed`.

The stacked grid (`dist.topology.StackedTopology`) holds every processor of
the R x C grid on one device.  Across a process group each rank holds a
rectangular block of it instead, and the exchanges become collectives
(`dist.topology.GroupTopology`).  This module is the whole process-group
surface:

  initialize()      `torch.distributed.init_process_group`: NCCL on a CUDA
                    device, gloo on the CPU or when asked for.
  is_multiprocess() more than one rank in the group.
  global_mesh()     the grid's `ProcessMesh`: rank p holds the row-major run
                    of processors [p*L, (p+1)*L), L = R*C / world -- the
                    devices process p owns in the JAX package's
                    `global_mesh` (all devices in process order, reshaped
                    row-major).
  put_dev()         a host (R, C, ...) array -> this rank's (Rl, Cl, ...)
                    blocks on its device (every rank holds the same host
                    copy).
  put_replicated()  a host array whole on this rank's device.
  fetch()           this rank's (Rl, Cl, ...) blocks -> the whole
                    (R, C, ...) array on every rank (`process_allgather`).

The wire: every tensor crosses the group as a uint8 view of its contiguous
bytes and is viewed back to its dtype on arrival -- bit-exact for every
dtype, and gloo refuses uint16, uint32 and int16 tensors but takes uint8.
Under gloo a CUDA tensor is staged through a host copy explicitly (nothing
relies on gloo's CUDA support); under NCCL device tensors go to the
collective as they are.  The sums (`all_reduce_i64`) travel as int64, which
both backends take.
"""
from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.types import resolve_device

# the device and backend `initialize` bound this process to
_STATE = {"device": None, "backend": None}


def initialize(init_method: str, num_processes: int, process_id: int, *,
               device=None, backend: str | None = None,
               timeout_s: float = 600.0) -> torch.device:
    """Join the process group (once, before any graph is planned).

    init_method: the rendezvous, e.g. "file:///tmp/x/store" or
    "tcp://localhost:PORT" (no port is hard-wired here).  device: the
    rank's device (None = CUDA, raising without a card; "cpu" for the CPU
    tests).  backend: None = "nccl" on CUDA, "gloo" on the CPU; "gloo" may
    be asked for on CUDA too (its messages are then staged through the
    host).  timeout_s bounds every collective, so a rank whose peers have
    diverged or died fails instead of waiting for ever.  Returns the
    rank's device."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    _STATE.update(device=dev, backend=backend)
    return dev


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, backend=None)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The grid over the process group, and this rank's block of it.

    shape (R, C); the rank holds processors (i, j) with i0 <= i < i0 + Rl
    and j0 <= j < j0 + Cl -- the row-major run [rank*L, (rank+1)*L)."""
    shape: tuple
    axis_names: tuple
    rank: int
    world: int
    i0: int
    j0: int
    Rl: int
    Cl: int
    device: torch.device
    backend: str

    @property
    def block_grid(self) -> tuple:
        """(block rows, block columns) of the ranks' blocks."""
        return self.shape[0] // self.Rl, self.shape[1] // self.Cl

    def block_of(self, rank: int) -> tuple:
        """Rank `rank`'s (block row, block column)."""
        nbc = self.block_grid[1]
        return rank // nbc, rank % nbc

    def rank_of(self, bi: int, bj: int) -> int:
        return bi * self.block_grid[1] + bj


def block_shape(R: int, C: int, world: int) -> tuple:
    """(Rl, Cl) of every rank's block: L = R*C / world processors, a run
    within one grid row (L divides C) or whole grid rows (C divides L).
    Any other world raises a ValueError."""
    P = R * C
    if world < 1 or P % world:
        raise ValueError(f"a {R}x{C} grid cannot be split over {world} "
                         f"ranks: R*C = {P} is not a multiple of the world")
    L = P // world
    if C % L == 0:
        return 1, L
    if L % C == 0:
        return L // C, C
    raise ValueError(
        f"a {R}x{C} grid over {world} ranks gives each rank a run of "
        f"{L} processors, which is not a rectangle: the run length must "
        f"divide C = {C} or be a multiple of it")


def global_mesh(axis_shapes, axis_names=("r", "c")) -> ProcessMesh:
    """The grid's mesh over the joined process group (every rank builds
    the same one)."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh needs a process group: call "
                           "multihost.initialize(...) first")
    R, C = (int(x) for x in axis_shapes)
    world, rank = dist.get_world_size(), dist.get_rank()
    Rl, Cl = block_shape(R, C, world)
    p0 = rank * Rl * Cl
    return ProcessMesh(shape=(R, C), axis_names=tuple(axis_names),
                       rank=rank, world=world, i0=p0 // C, j0=p0 % C,
                       Rl=Rl, Cl=Cl, device=_STATE["device"],
                       backend=_STATE["backend"])


def put_dev(x, mesh: ProcessMesh):
    """Host (R, C, ...) array (numpy or tensor) -> this rank's
    (Rl, Cl, ...) blocks on its device.  No data moves between ranks."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    blk = x[mesh.i0:mesh.i0 + mesh.Rl, mesh.j0:mesh.j0 + mesh.Cl]
    return blk.to(mesh.device).contiguous()


def put_replicated(x, mesh: ProcessMesh):
    """Host array (search roots, source sets) whole on this rank's
    device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(mesh.device)


# ----------------------------------------------------------------------------
# The wire
# ----------------------------------------------------------------------------

def _staged(t: torch.Tensor) -> bool:
    return _STATE["backend"] == "gloo" and t.device.type != "cpu"


def to_wire(x: torch.Tensor) -> torch.Tensor:
    """x's contiguous bytes as a flat uint8 tensor where the collective
    reads it: the host under gloo, x's device under NCCL."""
    b = x.contiguous().reshape(-1).view(torch.uint8)
    return b.cpu() if _staged(b) else b


def wire_buffer(nbytes: int, like: torch.Tensor) -> torch.Tensor:
    """An uninitialised uint8 receive buffer of `nbytes` where the
    collective writes it."""
    dev = torch.device("cpu") if _staged(like) else like.device
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def from_wire(buf: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """Received bytes -> a tensor of `like`'s dtype and device."""
    return buf.view(like.dtype).reshape(shape).to(like.device)


def all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every member's x stacked in group-rank order: (size, *x.shape)."""
    src = to_wire(x)
    buf = wire_buffer(size * src.numel(), x)
    dist.all_gather_into_tensor(buf, src, group=group)
    return from_wire(buf, x, (size,) + tuple(x.shape))


def all_to_all(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """x (size, ...): x[k] goes to member k; returns recv (size, ...) with
    recv[k] what member k sent here."""
    src = to_wire(x)
    buf = wire_buffer(src.numel(), x)
    dist.all_to_all_single(buf, src, group=group)
    return from_wire(buf, x, x.shape)


def exchange_pair(x: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send x to global rank `peer` and receive its tensor of the same
    shape and dtype (one pairwise exchange)."""
    src = to_wire(x)
    buf = wire_buffer(src.numel(), x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, peer, group),
        dist.P2POp(dist.irecv, buf, peer, group)])
    for r in reqs:
        r.wait()
    return from_wire(buf, x, x.shape)


def all_reduce_i64(values, group=None) -> torch.Tensor:
    """The elementwise int64 sum of `values` (a tensor or ints) over the
    group, as a host int64 tensor."""
    t = torch.as_tensor(values).to(torch.int64).reshape(-1)
    dev = _STATE["device"]
    on_dev = _STATE["backend"] == "nccl"
    t = t.to(dev) if on_dev else t.cpu()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.cpu()


def fetch(x, mesh: ProcessMesh | None = None):
    """This rank's (Rl, Cl, ...) blocks -> the whole (R, C, ...) array on
    every rank, an all-gather over the world (identity without a mesh)."""
    if mesh is None or not isinstance(x, torch.Tensor):
        return x
    nbr, nbc = mesh.block_grid
    g = all_gather(x, None, mesh.world)       # (world, Rl, Cl, ...)
    g = g.reshape((nbr, nbc, mesh.Rl, mesh.Cl) + tuple(x.shape[2:]))
    return g.transpose(1, 2).reshape(mesh.shape + tuple(x.shape[2:]))


def fetch_all(xs, mesh: ProcessMesh | None = None) -> tuple:
    """`fetch` over a tuple of outputs."""
    return tuple(fetch(x, mesh) for x in xs)
