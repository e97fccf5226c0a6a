"""The graph-learning and recsys models of the port at their configurations'
full width on one card, each leg checked: `chip_smoke.py` phase 19.

    python scripts/torch_models_card.py [--seed 1] [--out FILE.json]

It runs on the card (it raises without one).

Legs (every check raises; the script exits non-zero on the first):
  a  GraphSAGE-Reddit on `minibatch_lg`: an R-MAT SCALE 18 edge list
     truncated to e = 114,615,892 directed edges, ids folded mod n =
     232,965, its CSR on the host for `NeighborSampler`; 602 features and
     41 classes on the card; 20 steps of batch 1024, fanout 15-10:
     sample_block -> feature gather -> apply_block -> loss -> backward ->
     adamw_update.  Check: the first step's loss and gradients equal the
     CPU path's on the same block.  Logged: the host share of a step
     (1 - the device section's event span / the step's wall time).
  b  GraphSAGE full graph on the 2D SpMM, `ogb_products` (n = 2,449,029,
     e = 61,859,140 from R-MAT SCALE 22 folded mod n, 100 features, 47
     classes, d_hidden 128): planned on a stacked 2x2 grid, 5 steps of
     apply_fullgraph(spmm=make_spmm2d) -> loss -> backward -> AdamW.
     Check: the SpMM equals `spmm_reference` over the unpartitioned edge
     list, exactly on integer-valued features, and within 2^-20 of each
     row's sum |x| of a float64 reference on random ones.  Logged: one
     SpMM's time, the median of 5 warm calls.
  c  spmm2d on the paper's graph: R-MAT SCALE 26, edgefactor 16,
     symmetrised (2^31 edges), 2x2, d = 16 fp32, unweighted and with
     `chip_smoke.py` phase 4's uint8 weights (drawn from --seed + 1) as
     floats.  Check: each element within 2^-20 of its row's sum |w x| of a
     float64 reference.
  d  NequIP, MACE and EGNN at their configs' width on `molecule`: 128
     molecules of 30 atoms and 64 edges as one disjoint union;
     energy_and_forces and one value-and-grad AdamW step in fp32.  Checks
     in float64 (the fp32 weights cast) within F64_RTOL per molecule, its
     energy against its own magnitude and each atom's force against the
     molecule's largest: the union equals each molecule alone, energies
     invariant and forces covariant under a random rotation, the card
     equal to the CPU path.  Then fp32 against float64 within F32_RTOL,
     per molecule in the same units (these random-weight nets reach
     energies of 1e4-1e16).  An atom's own force is no scale: forces
     cancel, and fp32 lands hundreds of times an atom's own force from
     float64 where it is 1e-4 of the molecule's largest.
  e  DeepFM at the Criteo vocabularies (33.8M-row table): `train_batch`
     65536 (forward, loss, backward, AdamW), `serve_p99` 512 over 200
     calls (p50, p99), `serve_bulk` 262144, `retrieval_cand` 1 query x
     1,000,000 candidates.  Checks: FM equals the pairwise sum on 64 rows;
     the card equal to the CPU path on 512 rows.

Tolerances: legs (a), (e) rtol 1e-4 and atol 1e-5 card against CPU, the
atol in units of a tensor's largest entry once that passes 1; leg (d) as
above.  Matmuls run in fp32 (TF32 off).  Each leg logs wall seconds,
device seconds (host clock around synchronised work) and peak memory.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
F64_RTOL = 1e-9                 # (d) float64, per molecule / atom
F32_RTOL = 1e-2                 # (d) fp32 against float64, per molecule
BOUND = 2.0 ** -20              # spmm2d: |y - ref| <= BOUND * sum |w x|


def log(msg: str) -> None:
    print(f"[19 models] {msg}", flush=True)


class Card:
    """Synchronisation, timing and peak memory on the card."""

    def __init__(self, dev: torch.device):
        self.dev = dev

    def sync(self):
        torch.cuda.synchronize()

    def timed(self, fn):
        """(result, seconds) of fn() on the host clock, synchronised."""
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0

    def reset_peak(self):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def peak(self):
        return torch.cuda.max_memory_allocated()

    def gen(self, seed):
        return torch.Generator(device=self.dev).manual_seed(seed)


def gib(b) -> str:
    return f"{b / 2**30:.2f} GiB"


def check_close(what, got, want, rtol=RTOL, atol=ATOL):
    """got against its reference want (the CPU path, or the unrotated
    run) within rtol and atol in units of want's largest entry once that
    passes 1; returns the largest |got - want|."""
    got, want = got.detach().cpu(), want.detach().cpu()
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = (got - want).abs()
    ok = err <= atol * scale + rtol * want.abs()
    if got.shape != want.shape or not bool(ok.all()):
        raise AssertionError(
            f"{what}: differs from its reference (max |diff| "
            f"{float(err.max())}, scale {scale})")
    return float(err.max()) if err.numel() else 0.0


def grads(model):
    return {k: torch.zeros_like(p) if p.grad is None else p.grad.detach()
            for k, p in model.named_parameters()}


def fold_edges(scale, ef, e, n, card, seed):
    """An R-MAT edge list (on the card) truncated to e directed edges, ids
    folded mod n."""
    from repro_torch.graphgen import rmat_edges
    edges = rmat_edges(scale, ef, card.gen(seed), card.dev)[:, :e]
    return torch.remainder(edges, n).contiguous()


# ---------------------------------------------------------------------------
# (a) GraphSAGE-Reddit, minibatch_lg
# ---------------------------------------------------------------------------

def leg_a(card, seed):
    from repro_torch.configs import graphsage_reddit
    from repro_torch.configs.gnn_common import SHAPES
    from repro_torch.graphgen import build_csr
    from repro_torch.models.common import cross_entropy
    from repro_torch.models.gnn.graphsage import GraphSAGE, SAGEConfig
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.sparse import NeighborSampler

    sh = dict(SHAPES["minibatch_lg"])
    cfg = graphsage_reddit.CONFIG
    scale, steps = 18, 20
    n, e, B = sh["n"], sh["e"], sh["batch"]
    f1, f2 = sh["fanout"]
    card.reset_peak()
    t0 = time.perf_counter()
    ef = math.ceil(e / (2 << scale))
    edges = fold_edges(scale, ef, e, n, card, seed)
    row_off, col_idx = build_csr(edges, n)
    sampler = NeighborSampler(row_off.cpu().numpy(), col_idx.cpu().numpy(),
                              seed=seed)
    del edges, row_off, col_idx
    feats = torch.randn((n, sh["d_feat"]), generator=card.gen(seed + 1),
                        device=card.dev)
    labels = torch.randint(0, sh["classes"], (n,), generator=card.gen(
        seed + 2), device=card.dev)
    model = GraphSAGE(SAGEConfig(cfg.name, cfg.n_layers, cfg.d_hidden,
                                 sh["d_feat"], sh["classes"],
                                 cfg.aggregator), card.gen(seed + 3),
                      card.dev)
    cpu_model = copy.deepcopy(model).cpu()
    params = dict(model.named_parameters())
    opt, oc = adamw_init(params), AdamWConfig()
    card.sync()
    setup_s = time.perf_counter() - t0
    log(f"(a) minibatch_lg: R-MAT SCALE {scale} edgefactor {ef} truncated "
        f"to {e} edges, ids mod {n}, CSR to the host, {sh['d_feat']} "
        f"features on the card, in {setup_s:.2f} s")
    rng = np.random.default_rng(seed)
    rows, first = [], None
    for step in range(steps):
        seeds = rng.choice(n, B, replace=False)
        t0 = time.perf_counter()
        block = sampler.sample_block(seeds, [f1, f2])
        t1 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        nodes = [torch.from_numpy(v).to(card.dev) for v in block["nodes"]]
        bf = [feats[v] for v in nodes]
        lab = labels[nodes[0]]
        model.zero_grad(set_to_none=True)
        loss = cross_entropy(model.apply_block(bf, [f1, f2]), lab)
        loss.backward()
        if step == 0:
            first = (block, loss.item(), {k: g.cpu() for k, g in
                                          grads(model).items()})
        adamw_update(oc, params, {k: p.grad for k, p in params.items()},
                     opt)
        end.record()
        card.sync()
        t2 = time.perf_counter()
        rows.append({"sample_ms": (t1 - t0) * 1e3,
                     "device_ms": (t2 - t1) * 1e3,
                     "step_ms": (t2 - t0) * 1e3,
                     "event_ms": start.elapsed_time(end),
                     "loss": loss.item()})
    # the first step's block through the CPU path
    block, loss0, g0 = first
    bf = [feats[torch.from_numpy(v).to(card.dev)].cpu()
          for v in block["nodes"]]
    closs = cross_entropy(cpu_model.apply_block(bf, [f1, f2]),
                          labels[torch.from_numpy(block["nodes"][0]).to(
                              card.dev)].cpu())
    closs.backward()
    err = check_close("(a) first-step loss", torch.tensor(loss0),
                      closs.detach())
    for k, g in grads(cpu_model).items():
        err = max(err, check_close(f"(a) first-step grad {k}", g0[k], g))
    steady = rows[1:] or rows
    sample_ms = float(np.mean([r["sample_ms"] for r in steady]))
    dev_ms = float(np.mean([r["device_ms"] for r in steady]))
    step_ms = float(np.mean([r["step_ms"] for r in steady]))
    host = 1 - float(np.mean([r["event_ms"] / r["step_ms"] for r in steady]))
    log(f"(a) {steps} steps of batch {B}, fanout {f1}-{f2}: losses "
        f"{rows[0]['loss']:.4f} -> {rows[-1]['loss']:.4f}; steady step "
        f"{step_ms:.2f} ms = sampling {sample_ms:.2f} ms (host) + device "
        f"section {dev_ms:.2f} ms; {B / step_ms * 1e3:.1f} seeds/s; host "
        f"share {host:.4f} (1 - the device section's event span / step, "
        f"not a traced idle share); first step {rows[0]['step_ms']:.1f} ms; "
        f"first-step loss and grads = CPU path (max |diff| {err:.3g}); "
        f"peak {gib(card.peak())}")
    return {"setup_s": setup_s, "steps": rows, "sample_ms": sample_ms,
            "device_ms": dev_ms, "step_ms": step_ms,
            "seeds_per_s": B / step_ms * 1e3, "host_share": host,
            "max_abs_err": err, "peak_bytes": card.peak()}


# ---------------------------------------------------------------------------
# (b) GraphSAGE full graph on the 2D SpMM, ogb_products
# ---------------------------------------------------------------------------

def check_spmm(what, y, ref, mag, rows=1 << 22):
    """y within BOUND * mag of the reference, element by element (exact
    where a row has no edge), a block of rows at a time; returns (max
    |diff|, max |diff| / mag)."""
    err_max, rel_max = 0.0, 0.0
    for lo in range(0, y.shape[0], rows):
        d = (y[lo:lo + rows].double() - ref[lo:lo + rows].double()).abs_()
        m = mag[lo:lo + rows].double()
        bad = d > BOUND * m
        if bool(bad.any()):
            raise AssertionError(
                f"{what}: {int(bad.sum())} elements of rows {lo}.. past "
                f"2^-20 of their row's sum |w x| (max |diff| "
                f"{float(d.max())})")
        err_max = max(err_max, float(d.max()))
        rel_max = max(rel_max, float((d / m.clamp_(min=1e-30)).max()))
    return err_max, rel_max


def leg_b(card, seed):
    from repro_torch.configs import graphsage_reddit
    from repro_torch.configs.gnn_common import SHAPES
    from repro_torch.core import Grid2D, partition_2d
    from repro_torch.core.spmm2d import make_spmm2d, spmm_reference
    from repro_torch.dist import make_mesh
    from repro_torch.models.common import cross_entropy
    from repro_torch.models.gnn.graphsage import GraphSAGE, SAGEConfig
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    sh = dict(SHAPES["ogb_products"])
    cfg = graphsage_reddit.CONFIG
    scale, steps = 22, 5
    n, e = sh["n"], sh["e"]
    card.reset_peak()
    t0 = time.perf_counter()
    ef = math.ceil(e / (2 << scale))
    edges = fold_edges(scale, ef, e, n, card, seed + 10)
    grid = Grid2D.for_vertices(n, 2, 2)
    g = partition_2d(edges, grid)
    spmm2d = make_spmm2d(grid, make_mesh((2, 2), ("r", "c"),
                                         device=card.dev))
    card.sync()
    plan_s = time.perf_counter() - t0

    def spmm(h):
        return spmm2d(g.col_off, g.row_idx, g.nnz, h)

    # the SpMM against the plain edge-list reference
    deg_max = int(torch.bincount(edges[1].long(), minlength=grid.n).max())
    xi = torch.randint(-4, 5, (grid.n, sh["d_feat"]), generator=card.gen(
        seed + 11), device=card.dev).float()
    if 4 * deg_max >= 2**24:
        raise AssertionError(f"(b) in-degree {deg_max}: integer sums could "
                             f"pass 2^24")
    yi = spmm(xi)
    yi_s = float(np.median([card.timed(lambda: spmm(xi))[1]
                            for _ in range(5)]))
    ref, _ = spmm_reference(edges, xi, grid.n)
    if not torch.equal(yi, ref):
        raise AssertionError("(b) spmm2d differs from the edge-list "
                             "reference on integer-valued features")
    del xi, yi, ref
    x = torch.randn((grid.n, sh["d_feat"]), generator=card.gen(seed + 12),
                    device=card.dev)
    y = spmm(x)
    ref, mag = spmm_reference(edges, x, grid.n, dtype=torch.float64)
    err, rel = check_spmm("(b) spmm2d on random features", y, ref, mag)
    del y, ref, mag, edges
    labels = torch.randint(0, sh["classes"], (grid.n,),
                           generator=card.gen(seed + 13), device=card.dev)
    model = GraphSAGE(SAGEConfig(f"{cfg.name}-ogb_products", cfg.n_layers,
                                 cfg.d_hidden, sh["d_feat"], sh["classes"],
                                 cfg.aggregator), card.gen(seed + 14),
                      card.dev)
    params = dict(model.named_parameters())
    opt, oc = adamw_init(params), AdamWConfig()
    rows = []
    for _ in range(steps):
        t0 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        (loss, fwd_s) = card.timed(
            lambda: cross_entropy(model(x, None, None, spmm=spmm), labels))
        _, bwd_s = card.timed(loss.backward)
        _, opt_s = card.timed(lambda: adamw_update(
            oc, params, {k: p.grad for k, p in params.items()}, opt))
        rows.append({"step_s": time.perf_counter() - t0, "fwd_s": fwd_s,
                     "bwd_s": bwd_s, "opt_s": opt_s, "loss": loss.item()})
    steady = rows[1:] or rows
    fwd = float(np.mean([r["fwd_s"] for r in steady]))
    step = float(np.mean([r["step_s"] for r in steady]))
    eps = cfg.n_layers * e / fwd
    log(f"(b) ogb_products: {e} edges (R-MAT SCALE {scale} edgefactor {ef} "
        f"folded mod {n}) planned 2x2 in {plan_s:.2f} s; spmm2d = the "
        f"edge-list reference exactly on integer features (max in-degree "
        f"{deg_max}, one SpMM at d {sh['d_feat']} {yi_s * 1e3:.1f} ms, the median "
        f"of 5 warm calls) and within "
        f"2^-20 * sum|x| on random ones (max |diff| {err:.3g}, max "
        f"|diff| / sum|x| {rel:.3g}); {steps} steps: losses "
        f"{rows[0]['loss']:.4f} -> {rows[-1]['loss']:.4f}, steady step "
        f"{step:.3f} s (forward {fwd:.3f}, backward "
        f"{np.mean([r['bwd_s'] for r in steady]):.3f}, AdamW "
        f"{np.mean([r['opt_s'] for r in steady]):.4f}), {eps:.4g} "
        f"aggregated edges/s forward; peak {gib(card.peak())}")
    return {"plan_s": plan_s, "steps": rows, "step_s": step, "fwd_s": fwd,
            "agg_edges_per_s": eps, "spmm_int_s": yi_s, "deg_max": deg_max,
            "max_abs_err": err, "max_rel_err": rel,
            "peak_bytes": card.peak()}


# ---------------------------------------------------------------------------
# (c) spmm2d on the paper's graph
# ---------------------------------------------------------------------------

def leg_c(card, seed):
    from repro_torch.core import Grid2D
    from repro_torch.core.partition import partition_2d_with_vals
    from repro_torch.core.spmm2d import make_spmm2d, spmm_reference
    from repro_torch.dist import make_mesh
    from repro_torch.graphgen import rmat_edges

    scale, ef, d = 26, 16, 16
    n = 1 << scale
    card.reset_peak()
    t0 = time.perf_counter()
    edges = rmat_edges(scale, ef, card.gen(seed), card.dev)
    weights = torch.randint(1, 256, (edges.shape[1],), dtype=torch.uint8,
                            device=card.dev, generator=card.gen(seed + 1))
    x = torch.randn((n, d), generator=card.gen(seed + 20), device=card.dev)
    card.sync()
    gen_s = time.perf_counter() - t0
    refs = {}
    for tag, w in (("unweighted", None), ("weighted", weights)):
        (ref, mag), s = card.timed(lambda: spmm_reference(
            edges, x, n, w, dtype=torch.float64))
        refs[tag] = (ref.float(), mag, s)
        del ref
    grid = Grid2D.for_vertices(n, 2, 2)
    (g, wb), plan_s = card.timed(lambda: partition_2d_with_vals(
        edges, weights, grid))
    n_edges = int(edges.shape[1])
    del edges, weights
    gc.collect()
    spmm = make_spmm2d(grid, make_mesh((2, 2), ("r", "c"), device=card.dev))
    out = {"edges": n_edges, "gen_s": gen_s, "plan_s": plan_s}
    for tag, w in (("unweighted", None), ("weighted", wb)):
        y, s = card.timed(lambda: spmm(g.col_off, g.row_idx, g.nnz, x,
                                       edge_weight=w))
        ref32, mag, ref_s = refs.pop(tag)
        # the float32 copy of the float64 reference adds at most 2^-24 |y|
        mag.mul_(1 + 2.0**-4)
        err, rel = check_spmm(f"(c) spmm2d {tag}", y, ref32, mag)
        del y, ref32, mag
        out[tag] = {"s": s, "edges_per_s": n_edges / s, "ref_s": ref_s,
                    "max_abs_err": err, "max_rel_err": rel}
        log(f"(c) SCALE {scale} edgefactor {ef}, {n_edges} edges, 2x2, d "
            f"{d} fp32, {tag}: {s:.3f} s, {n_edges / s:.4g} edges/s "
            f"(float64 edge-list reference {ref_s:.2f} s); every element "
            f"within 2^-20 of its row's sum |w x| (max |diff| {err:.3g}, "
            f"max |diff| / sum {rel:.3g})")
    out["peak_bytes"] = card.peak()
    log(f"(c) generated in {gen_s:.2f} s, planned in {plan_s:.2f} s; peak "
        f"{gib(out['peak_bytes'])}")
    return out


# ---------------------------------------------------------------------------
# (d) NequIP, MACE and EGNN on the molecule shape
# ---------------------------------------------------------------------------

def random_rotation(gen, dev):
    """A random rotation (det +1), float64."""
    a = torch.randn((3, 3), generator=gen, device=dev, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q * torch.linalg.det(q)


def molecules(card, seed, B, n, e):
    """B molecules of n atoms and e edges (no self-loops) as one disjoint
    union: (species, positions, src, dst, molecule id of each atom)."""
    g = card.gen(seed)
    src = torch.randint(0, n, (B, e), generator=g, device=card.dev)
    dst = (src + torch.randint(1, n, (B, e), generator=g,
                               device=card.dev)) % n
    off = (torch.arange(B, device=card.dev) * n)[:, None]
    spec = torch.randint(0, 8, (B * n,), generator=g, device=card.dev)
    pos = torch.randn((B * n, 3), generator=g, device=card.dev) * 1.5
    mol = torch.arange(B, device=card.dev).repeat_interleave(n)
    return spec, pos, (src + off).reshape(-1), (dst + off).reshape(-1), mol


def per_molecule_err(got, want, scale=None):
    """max over molecules of |got - want| / |scale| (scale: want)."""
    scale = want if scale is None else scale
    d = (got.detach().double() - want.detach().double()).abs()
    return float((d / scale.detach().double().abs().clamp(min=1e-300))
                 .max())


def per_atom_err(got, want, mol, B):
    """max over atoms of |got_a - want_a| over the largest |want_a| of the
    atom's molecule (3-vectors)."""
    d = torch.linalg.vector_norm(got.detach().double() - want.double(),
                                 dim=-1)
    w = torch.linalg.vector_norm(want.double(), dim=-1)
    top = torch.full((B,), 0.0, dtype=w.dtype, device=w.device)
    top = top.scatter_reduce(0, mol, w, "amax")[mol]
    return float((d / top.clamp(min=1e-300)).max())


def leg_d(card, seed):
    """The equivalence checks run in float64 (the fp32 weights cast), per
    molecule: the full-width nets with random weights reach energies of
    1e4-1e16, so a bound in units of a tensor's largest entry would leave
    the smaller molecules unchecked.  The fp32 path is timed, trained one
    step and held to float64 per molecule."""
    from repro_torch.configs import egnn as egnn_cfg
    from repro_torch.configs import mace, nequip
    from repro_torch.configs.gnn_common import SHAPES
    from repro_torch.models.gnn.egnn import EGNN
    from repro_torch.models.gnn.equivariant import EquivariantNet
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.sparse import segment_sum

    sh = SHAPES["molecule"]
    B, n, e = sh["batch"], sh["n"], sh["e"]
    card.reset_peak()
    spec, pos, src, dst, mol = molecules(card, seed + 30, B, n, e)
    feats = torch.randn((B * n, egnn_cfg.CONFIG.d_in),
                        generator=card.gen(seed + 31), device=card.dev)
    target = torch.randn((B,), generator=card.gen(seed + 32),
                         device=card.dev)
    rot = random_rotation(card.gen(seed + 33), card.dev)
    out = {}
    for name, cfg in (("nequip", nequip.CONFIG), ("mace", mace.CONFIG),
                      ("egnn", egnn_cfg.CONFIG)):
        is_egnn = name == "egnn"
        cls = EGNN if is_egnn else EquivariantNet
        model = cls(cfg, card.gen(seed + 34), card.dev)

        def per_mol(m, p, sel=slice(None), es=slice(None), shift=0,
                    count=B):
            dt, dv = p.dtype, p.device
            first = (feats.to(dt) if is_egnn else spec)[sel].to(dv)
            s_, d_ = src[es].to(dv) - shift, dst[es].to(dv) - shift
            ids = mol[sel].to(dv) - shift // n
            if is_egnn:
                h = m(first, p, s_, d_)[1]
                return segment_sum((h @ m.readout)[:, 0], ids, count)
            return segment_sum(m(first, p, s_, d_)[1], ids, count)

        def energy_forces(m, p):
            with torch.enable_grad():
                p = p.detach().requires_grad_(True)
                em = per_mol(m, p)
                (gp,) = torch.autograd.grad(em.sum(), p)
            return em.detach(), -gp

        # float64: `energy_and_forces`, the union against molecules alone,
        # the rotation, the card against the CPU
        m64 = copy.deepcopy(model).double()
        p64 = pos.double()
        em, forces = energy_forces(m64, p64)
        errs = {}
        if not is_egnn:
            e_tot, f_tot = m64.energy_and_forces(spec, p64, src, dst)
            errs["energy_and_forces energy"] = per_molecule_err(
                e_tot.reshape(1), em.sum().reshape(1),
                em.abs().sum().reshape(1))
            errs["energy_and_forces forces"] = per_atom_err(
                f_tot, forces, mol, B)
        alone = torch.cat([per_mol(m64, p64[b * n:(b + 1) * n],
                                   slice(b * n, (b + 1) * n),
                                   slice(b * e, (b + 1) * e), b * n, 1)
                           for b in (0, B - 1)]).detach()
        errs["molecules alone"] = per_molecule_err(alone, em[[0, B - 1]])
        em_r, forces_r = energy_forces(m64, p64 @ rot.T)
        errs["energy under rotation"] = per_molecule_err(em_r, em)
        errs["forces under rotation"] = per_atom_err(
            forces_r, forces @ rot.T, mol, B)
        em_c, forces_c = energy_forces(copy.deepcopy(m64).cpu(), p64.cpu())
        errs["energies card/CPU"] = per_molecule_err(em, em_c.to(card.dev))
        errs["forces card/CPU"] = per_atom_err(forces, forces_c.to(card.dev),
                                               mol, B)
        del m64
        # fp32: timed, held to float64 per molecule, a training step
        (em32, f32), ef_s = card.timed(lambda: energy_forces(model, pos))
        e32 = per_molecule_err(em32, em)
        f32_mol = per_atom_err(f32, forces, mol, B)
        log(f"(d) {name}: float64, per molecule (energies of their own "
            f"magnitude, forces of the molecule's largest): "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; fp32 from float64: energies {e32:.3g}, forces "
            f"{f32_mol:.3g}")
        for k, v in errs.items():
            if not v <= F64_RTOL:
                raise AssertionError(f"(d) {name} {k}: {v} of its own "
                                     f"magnitude, past {F64_RTOL}")
        for k, v in (("energies", e32), ("forces", f32_mol)):
            if not v <= F32_RTOL:
                raise AssertionError(f"(d) {name}: fp32 {k} {v} from "
                                     f"float64, past {F32_RTOL}")
        escale = float(em.abs().max())
        fscale = float(forces.abs().max())
        params = dict(model.named_parameters())
        opt = adamw_init(params)

        def step():
            model.zero_grad(set_to_none=True)
            loss = torch.mean((per_mol(model, pos) - target) ** 2)
            loss.backward()
            adamw_update(AdamWConfig(), params, grads(model), opt)
            return loss
        loss, step_s = card.timed(step)
        if not bool(torch.isfinite(loss)):
            raise AssertionError(f"(d) {name}: fp32 training loss not "
                                 f"finite")
        out[name] = {"energy_forces_s": ef_s, "step_s": step_s,
                     "loss": loss.item(), "f64_rel_err": errs,
                     "energy_scale": escale, "force_scale": fscale,
                     "fp32_energy_rel_err": e32,
                     "fp32_force_rel_err": f32_mol}
        log(f"(d) {name} ({cfg.n_layers} layers, width {cfg.d_hidden}) on "
            f"{B} molecules x {n} atoms x {e} edges: fp32 energy_and_forces "
            f"{ef_s * 1e3:.1f} ms, value-and-grad + AdamW "
            f"{step_s * 1e3:.1f} ms; energies up to {escale:.4g}, forces "
            f"up to {fscale:.4g}; every check passed")
        del model, params, opt
    out["peak_bytes"] = card.peak()
    log(f"(d) peak {gib(out['peak_bytes'])}")
    return out


# ---------------------------------------------------------------------------
# (e) DeepFM at the Criteo vocabularies
# ---------------------------------------------------------------------------

def criteo_ids(card, cfg, batch, seed, fields=None):
    """(batch, len(fields)) within-field ids of the given fields."""
    v = torch.tensor(cfg.vocabs if fields is None else
                     [cfg.vocabs[f] for f in fields], dtype=torch.float64,
                     device=card.dev)
    u = torch.rand((batch, v.numel()), generator=card.gen(seed),
                   device=card.dev, dtype=torch.float64)
    return (u * v).long().clamp_(max=v.long() - 1).to(torch.int32)


def percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def leg_e(card, seed):
    from repro_torch.configs import deepfm as deepfm_cfg
    from repro_torch.configs.recsys_common import N_USER_FIELDS, SHAPES
    from repro_torch.models.recsys.deepfm import DeepFM
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    cfg = deepfm_cfg.CONFIG
    sizes = {k: v["batch"] for k, v in SHAPES.items()}
    n_cand, calls = SHAPES["retrieval_cand"]["n_cand"], 200
    card.reset_peak()
    model, init_s = card.timed(lambda: DeepFM(cfg, card.gen(seed + 40),
                                              card.dev))
    # FM = the pairwise sum on 64 rows (MLP, linear and bias zeroed)
    ids64 = criteo_ids(card, cfg, 64, seed + 41)
    saved = [model.mlp[-1].detach().clone(), model.linear.detach().clone()]
    with torch.no_grad():
        model.mlp[-1].zero_()
        model.linear.zero_()
        fm = model(ids64).double()
        v = model.table[(ids64 + model.field_offsets()).long()].double()
        gram = v @ v.transpose(1, 2)                      # (64, F, F)
        pair = torch.triu(gram, diagonal=1).sum(dim=(1, 2))
        model.mlp[-1].copy_(saved[0])
        model.linear.copy_(saved[1])
    fm_err = float((fm - pair).abs().max())
    if fm_err > 1e-5 * max(1.0, float(pair.abs().max())) + 1e-6:
        raise AssertionError(f"(e) FM differs from the pairwise sum by "
                             f"{fm_err}")
    del saved
    # the card against the CPU path on 512 rows: logits, loss, gradients
    ids = criteo_ids(card, cfg, 512, seed + 42)
    y = (torch.rand(512, generator=card.gen(seed + 43), device=card.dev)
         > 0.5).float()
    cpu = copy.deepcopy(model).cpu()
    errs = [check_close("(e) logits card/CPU", model(ids), cpu(ids.cpu()))]
    for m, i, t in ((model, ids, y), (cpu, ids.cpu(), y.cpu())):
        m.zero_grad(set_to_none=True)
        m.loss(i, t).backward()
    rows = (ids.cpu() + cpu.field_offsets()).long().reshape(-1).unique()
    for k, gc_ in grads(cpu).items():
        gk = grads(model)[k].cpu()
        if k in ("table", "linear"):
            gk, gc_ = gk[rows], gc_[rows]
        errs.append(check_close(f"(e) grad {k} card/CPU", gk, gc_))
    del cpu
    gc.collect()
    # train_batch: forward, loss, backward, AdamW
    B = sizes["train_batch"]
    tids = criteo_ids(card, cfg, B, seed + 44)
    ty = (torch.rand(B, generator=card.gen(seed + 45), device=card.dev)
          > 0.5).float()
    params = dict(model.named_parameters())
    opt = adamw_init(params)

    def train():
        model.zero_grad(set_to_none=True)
        loss = model.loss(tids, ty)
        loss.backward()
        adamw_update(AdamWConfig(), params, grads(model), opt)
        return loss
    train_s = [card.timed(train)[1] for _ in range(5)]
    # serve_p99: 512-row forwards one by one; serve_bulk; retrieval_cand
    sids = criteo_ids(card, cfg, sizes["serve_p99"], seed + 46)
    with torch.no_grad():
        model(sids)
        lat = [card.timed(lambda: model(sids))[1] * 1e3
               for _ in range(calls)]
        bids = criteo_ids(card, cfg, sizes["serve_bulk"], seed + 47)
        model(bids)
        _, bulk_s = card.timed(lambda: model(bids))
        user = criteo_ids(card, cfg, 1, seed + 48,
                          range(N_USER_FIELDS))[0]
        items = criteo_ids(card, cfg, n_cand, seed + 49,
                           range(N_USER_FIELDS, cfg.n_fields))
        model.score_candidates(user, items)
        scores, ret_s = card.timed(lambda: model.score_candidates(user,
                                                                  items))
    if not bool(torch.isfinite(scores).all()) or scores.shape != (n_cand,):
        raise AssertionError("(e) retrieval scores not finite")
    out = {"total_rows": cfg.total_rows, "init_s": init_s,
           "fm_err": fm_err, "max_abs_err": max(errs),
           "train_s": train_s, "serve_p50_ms": percentile(lat, 50),
           "serve_p99_ms": percentile(lat, 99), "bulk_s": bulk_s,
           "retrieval_s": ret_s, "peak_bytes": card.peak()}
    log(f"(e) DeepFM, {cfg.total_rows} table rows x {cfg.embed_dim} "
        f"(initialised in {init_s * 1e3:.1f} ms): FM = pairwise sum on 64 rows "
        f"(max |diff| {fm_err:.3g}); card = CPU on 512 rows (max |diff| "
        f"{max(errs):.3g}); train_batch {B}: first step "
        f"{train_s[0] * 1e3:.1f} ms, then "
        f"{np.mean(train_s[1:]) * 1e3:.1f} ms; serve_p99 "
        f"{sizes['serve_p99']} x {calls} calls: p50 "
        f"{out['serve_p50_ms']:.3f} ms, p99 {out['serve_p99_ms']:.3f} ms; "
        f"serve_bulk {sizes['serve_bulk']}: {bulk_s * 1e3:.2f} ms; "
        f"retrieval_cand 1 x {n_cand}: {ret_s * 1e3:.2f} ms; peak "
        f"{gib(out['peak_bytes'])}")
    return out


LEGS = {"a": leg_a, "b": leg_b, "c": leg_c, "d": leg_d, "e": leg_e}


def run(dev, seed=1) -> dict:
    """Every leg on the card `dev`; raises on the first failed check."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = Card(dev)
    report = {}
    for leg, fn in LEGS.items():
        t0 = time.perf_counter()
        report[leg] = fn(card, seed)
        report[leg]["wall_s"] = time.perf_counter() - t0
        log(f"({leg}) leg done in {report[leg]['wall_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    from repro_torch.core.types import resolve_device
    dev = resolve_device(None)
    t0 = time.perf_counter()
    report = run(dev, a.seed)
    report["wall_s"] = time.perf_counter() - t0
    report["device"] = torch.cuda.get_device_name(0)
    log(f"every leg passed in {report['wall_s']:.1f} s")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
