"""The registry, the dry run and the expert-parallel MoE across a process
group on one card: `chip_smoke.py` phase 21.

    python scripts/torch_dryrun_card.py [--seed 1] [--out FILE.json]

It runs on the card and raises without one.  The three legs overlap: (b)'s processes and (c)'s ranks start
first, (a) runs while they work, and the script waits for both.

Legs (every check raises; the script exits non-zero on the first):
  a  `get_arch(a).smoke()` of every architecture of the registry on the
     card (11): reduced configs, forward / loss / gradients / a decode
     step, shapes and finiteness.  The bfs-rmat smoke searches through
     the kernel path, as every search on the card does.
  b  one dry-run cell per family through `python -m
     repro_torch.launch.dryrun` on the single-pod 16x16 mesh, each cell a
     process of its own with CUDA hidden (the dry run traces on the meta
     device and needs no card): gemma2-2b train_4k, qwen2-moe-a2.7b
     decode_32k, graphsage-reddit ogb_products, deepfm train_batch,
     bfs-rmat rmat_weak.  Beside them, in two more processes with CUDA
     hidden, `scripts/torch_hillclimb.py` on four experiments:
     kimi_train/fsdp+cap1.0+quant+mb4 (four knobs at once) in one,
     gemma_decode/seqshard, sage_products/bf16 and bfs/chunk_256k in the
     other; then `scripts/torch_gen_experiments.py` on the five cells'
     and the four experiments' records.  Check: every record's status is
     "ok"; bfs/chunk_256k's memory term is below the bfs-rmat cell's (the
     traced level scans its engine's own 2^18-edge chunk); the report has
     each experiment's row and no "(failed)" row among them.  Logged:
     each record's trace seconds, roofline terms and per-device argument
     (and temp) GiB.  These are counts of shapes times the H100's
     datasheet rates, not measurements.
  c  one qwen2-moe-a2.7b MoE layer at full width (64 experts allocated, 60
     routed, top-4, d_model 2048, d_ff 1408, bf16; the router fp32) over
     4096 tokens, expert-parallel over ep = 2: two gloo ranks sharing the
     card (NCCL refuses two ranks on one card), a (1, 2) ("data",
     "model") `ProcessMesh`, tokens over both axes, experts over "model".
     Forward and backward of sum(y * gy) + aux.  Check, in each rank: the
     output, aux and the gradients of x, router, w1, w3 and w2 equal the
     stacked (1, 2) mesh's on the same card within TOL of each tensor's
     largest entry: bf16 keeps 8 significant bits (an ulp is 2^-8 to 2^-7
     of a value), `index_add_` on the card adds a token's top-4
     contributions in no fixed order, and the two paths sum the
     gradients in another order.  Logged: each rank's wall seconds of the
     group pass and of the stacked one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, SRC)

import torch  # noqa: E402

TOL = 2e-2                 # (c): |group - stacked| <= TOL * max |stacked|
CELLS = (("gemma2-2b", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k"),
         ("graphsage-reddit", "ogb_products"), ("deepfm", "train_batch"),
         ("bfs-rmat", "rmat_weak"))
# (b) the hillclimb's experiments, one process a group (the first is the
# longest trace: four microbatches of kimi-k2's train step)
HILLCLIMB = (("kimi_train/fsdp+cap1.0+quant+mb4",),
             ("gemma_decode/seqshard", "sage_products/bf16",
              "bfs/chunk_256k"))
TOKENS = 4096
RANK_TIMEOUT_S = 240
DRYRUN_TIMEOUT_S = 240


def log(msg: str) -> None:
    print(f"[21 dryrun] {msg}", flush=True)


# ---------------------------------------------------------------------------
# (b) the dry-run cells
# ---------------------------------------------------------------------------

def start_cells(workdir: str) -> list:
    """Every CELLS entry's dry run, started at once: [(cell, out, Popen)]."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=SRC)
    runs = []
    for k, (arch, shape) in enumerate(CELLS):
        out = os.path.join(workdir, f"cell{k}.json")
        log_f = open(os.path.join(workdir, f"cell{k}.log"), "w")
        p = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", out],
            env=env, stdout=log_f, stderr=subprocess.STDOUT)
        log_f.close()
        runs.append(((arch, shape), out, p))
    return runs


def start_hillclimb(workdir: str) -> list:
    """Every HILLCLIMB group's experiments, a process each in a directory
    of its own (the script writes hillclimb_results.json to its working
    directory), started at once: [(names, directory, Popen)]."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=SRC)
    runs = []
    for k, names in enumerate(HILLCLIMB):
        d = os.path.join(workdir, f"hillclimb{k}")
        os.makedirs(d)
        log_f = open(os.path.join(d, "log"), "w")
        p = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_hillclimb.py"),
             *names], cwd=d, env=env, stdout=log_f, stderr=subprocess.STDOUT)
        log_f.close()
        runs.append((names, d, p))
    return runs


def finish_cells(runs, workdir: str, t0: float) -> dict:
    rep = {}
    for k, ((arch, shape), out, p) in enumerate(runs):
        try:
            p.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                               - (time.perf_counter() - t0)))
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        with open(os.path.join(workdir, f"cell{k}.log")) as f:
            text = f.read()
        if p.returncode != 0:
            raise AssertionError(f"(b) the dry run of {arch} {shape} exited "
                                 f"{p.returncode}:\n{text[-3000:]}")
        with open(out) as f:
            rec = json.load(f)[f"{arch}|{shape}|single"]
        if rec["status"] != "ok":
            raise AssertionError(f"(b) {arch} {shape}: {rec['status']} "
                                 f"{rec.get('error', '')}")
        rl, mem = rec["roofline"], rec["memory"]
        log(f"(b) {arch} {shape} single: trace {rec['lower_s']} s, "
            f"compute {rl['compute_s']:.4g} s, memory {rl['memory_s']:.4g} "
            f"s, collective {rl['collective_s']:.4g} s ({rl['dominant']}), "
            f"argument {mem['argument_bytes'] / 2**30:.3f} GiB / device, "
            f"temp {mem['temp_bytes'] / 2**30:.3f} GiB / device")
        rep[f"{arch}|{shape}"] = {"lower_s": rec["lower_s"],
                                  "roofline": rl, "memory": mem}
    return rep


def finish_hillclimb(runs, cells: dict, workdir: str, t0: float) -> dict:
    """Wait for the hillclimb's processes, check and log their records,
    then render the report over them and the cells' records."""
    recs = {}
    for names, d, p in runs:
        try:
            p.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                               - (time.perf_counter() - t0)))
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        with open(os.path.join(d, "log")) as f:
            text = f.read()
        if p.returncode != 0:
            raise AssertionError(f"(b) the hillclimb of {names} exited "
                                 f"{p.returncode}:\n{text[-3000:]}")
        with open(os.path.join(d, "hillclimb_results.json")) as f:
            got = json.load(f)
        for name in names:
            rec = got.get(name, {"status": "missing"})
            if rec["status"] != "ok":
                raise AssertionError(f"(b) hillclimb {name}: {rec['status']}"
                                     f" {rec.get('error', '')}\n"
                                     f"{rec.get('tb', '')}")
            log(f"(b) hillclimb {name}: trace {rec['lower_s']} s, compute "
                f"{rec['compute_s']:.4g} s, memory {rec['memory_s']:.4g} s, "
                f"collective {rec['collective_s']:.4g} s "
                f"({rec['dominant']}), argument {rec['arg_gib']:.3f} GiB / "
                f"device, temp {rec['temp_gib']:.3f} GiB / device")
            recs[name] = rec
    bfs = cells["bfs-rmat|rmat_weak"]["roofline"]["memory_s"]
    small = recs["bfs/chunk_256k"]["memory_s"]
    if not small < bfs:
        raise AssertionError(f"(b) bfs/chunk_256k's memory term {small} s "
                             f"is not below the bfs-rmat cell's {bfs} s")
    return {"records": recs, "report": render_report(recs, workdir)}


def render_report(recs: dict, workdir: str) -> dict:
    """`scripts/torch_gen_experiments.py` over the cells' and the
    hillclimb's records, in a process with CUDA hidden; checks that each
    experiment's row is there and none of them reads "(failed)"."""
    d = os.path.join(workdir, "report")
    os.makedirs(d)
    dr = {}
    for k in range(len(CELLS)):
        with open(os.path.join(workdir, f"cell{k}.json")) as f:
            dr.update(json.load(f))
    for name, obj in (("dryrun_results.json", dr),
                      ("hillclimb_results.json", recs)):
        with open(os.path.join(d, name), "w") as f:
            json.dump(obj, f)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=SRC)
    res = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_gen_experiments.py")],
        cwd=d, env=env, capture_output=True, text=True,
        timeout=DRYRUN_TIMEOUT_S)
    if res.returncode != 0:
        raise AssertionError(f"(b) the report exited {res.returncode}:\n"
                             f"{res.stderr[-3000:]}")
    with open(os.path.join(d, "EXPERIMENTS_torch.md")) as f:
        text = f.read()
    for name in recs:
        if f"| {name} | (failed)" in text or f"| {name} | " not in text:
            raise AssertionError(f"(b) the report's row of {name} is "
                                 "missing or failed")
    n_lines = text.count("\n") + 1
    log(f"(b) report: {n_lines} lines, a row for each of the "
        f"{len(recs)} experiments, none failed")
    return {"lines": n_lines}


# ---------------------------------------------------------------------------
# (c) the MoE layer over two gloo ranks
# ---------------------------------------------------------------------------

def moe_inputs(seed: int, dev):
    """The layer's weights (JAX's scales: N(0, 1) / sqrt(fan-in)), tokens
    and output gradient, drawn on `dev` from `seed` (every rank draws the
    same)."""
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG
    m = CONFIG.moe
    d, f, E = CONFIG.d_model, m.d_ff_expert, m.e_alloc
    g = torch.Generator(device=dev).manual_seed(seed)

    def nrm(*shape, dtype=torch.bfloat16, fan=None):
        x = torch.randn(shape, generator=g, device=dev)
        return (x / (fan or shape[-2]) ** 0.5).to(dtype)
    p = {"x": nrm(TOKENS, d, fan=1), "router": nrm(d, E,
                                                   dtype=torch.float32),
         "w1": nrm(E, d, f), "w3": nrm(E, d, f), "w2": nrm(E, f, d)}
    return p, nrm(TOKENS, d, fan=1), m


def moe_pass(p, gy, cfg, shard):
    """(y, aux, gradients by name, wall seconds) of one forward and
    backward of sum(y * gy) + aux over `shard`."""
    from repro_torch.models.moe import moe_apply
    args = {k: v.clone().requires_grad_() for k, v in p.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, aux = moe_apply(args["x"], {k: args[k] for k in
                                   ("router", "w1", "w3", "w2")},
                       cfg, mesh=shard)
    obj = torch.sum(y.float() * gy.float()) + aux
    grads = torch.autograd.grad(obj, list(args.values()))
    torch.cuda.synchronize()
    return (y.detach(), aux.detach(), dict(zip(args, grads)),
            time.perf_counter() - t0)


def rank_main(a) -> int:
    """One rank of leg (c) (a child of this script)."""
    from repro_torch.dist import multihost
    from repro_torch.dist.compat import make_mesh
    from repro_torch.models.moe import MoEShard
    dev = multihost.initialize(f"file://{a.store}", 2, a.rank,
                               device="cuda:0", backend="gloo",
                               timeout_s=RANK_TIMEOUT_S)
    try:
        pm = multihost.global_mesh((1, 2), ("data", "model"))
        p, gy, cfg = moe_inputs(a.seed, dev)
        kw = dict(token_axes=("data", "model"), expert_axis="model")
        y, aux, grads, group_s = moe_pass(p, gy, cfg,
                                          MoEShard(mesh=pm, **kw))
        stacked = MoEShard(mesh=make_mesh((1, 2), ("data", "model"),
                                          device=dev), **kw)
        ys, auxs, gs, stacked_s = moe_pass(p, gy, cfg, stacked)
        errs = {}
        for name, got, want in [("y", y, ys), ("aux", aux, auxs)] + [
                (f"g{k}", grads[k], gs[k]) for k in grads]:
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            errs[name] = {"max_abs_err": err, "max_abs": scale}
            if not err <= TOL * scale:
                raise AssertionError(
                    f"(c) rank {a.rank}: {name} differs from the stacked "
                    f"path by {err} (max |stacked| {scale})")
        rep = {"group_s": group_s, "stacked_s": stacked_s, "errs": errs}
        with open(os.path.join(os.path.dirname(a.store),
                               f"rank{a.rank}.json"), "w") as f:
            json.dump(rep, f)
    finally:
        multihost.shutdown()
    return 0


def start_ranks(a, workdir: str) -> list:
    store = os.path.join(workdir, "store")
    procs = []
    for r in range(2):
        log_f = open(os.path.join(workdir, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed",
             str(a.seed), "--rank", str(r), "--store", store], stdout=log_f, stderr=subprocess.STDOUT))
        log_f.close()
    return procs


def finish_ranks(procs, workdir: str, t0: float) -> dict:
    try:
        for p in procs:
            p.wait(timeout=max(1.0, RANK_TIMEOUT_S
                               - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rep = {}
    for r, p in enumerate(procs):
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            text = f.read()
        if p.returncode != 0:
            raise AssertionError(f"(c) rank {r} exited {p.returncode}:\n"
                                 f"{text[-3000:]}")
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            rep[f"rank{r}"] = json.load(f)
        rr = rep[f"rank{r}"]
        log(f"(c) rank {r}: group pass {rr['group_s']:.3f} s, stacked "
            f"{rr['stacked_s']:.3f} s; max |group - stacked| / max "
            f"|stacked|: " + ", ".join(
                f"{k} {v['max_abs_err'] / max(v['max_abs'], 1e-30):.2e}"
                for k, v in rr["errs"].items()))
    return rep


# ---------------------------------------------------------------------------
# (a) the registry's smokes
# ---------------------------------------------------------------------------

def run_smokes(dev) -> dict:
    from repro_torch.configs import ARCHS, get_arch
    rep = {}
    for arch_id in sorted(ARCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        get_arch(arch_id).smoke(device=dev)
        torch.cuda.synchronize()
        rep[arch_id] = time.perf_counter() - t0
        log(f"(a) {arch_id} smoke passed in {rep[arch_id]:.2f} s")
    return rep


def run(a) -> dict:
    from repro_torch.core.types import resolve_device
    dev = resolve_device(None)
    report = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        cells = start_cells(workdir)
        climbs = start_hillclimb(workdir)
        ranks = start_ranks(a, workdir)
        try:
            report["smokes_s"] = run_smokes(dev)
            report["moe_group"] = finish_ranks(ranks, workdir, t0)
            report["moe_group"]["wall_s"] = time.perf_counter() - t0
            report["cells"] = finish_cells(cells, workdir, t0)
            report["hillclimb"] = finish_hillclimb(climbs, report["cells"],
                                                   workdir, t0)
            report["hillclimb"]["wall_s"] = time.perf_counter() - t0
        finally:
            for p in ranks + [c[2] for c in cells + climbs]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.rank is not None:
        return rank_main(a)
    t0 = time.perf_counter()
    report = run(a)
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
