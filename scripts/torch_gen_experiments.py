"""Generate EXPERIMENTS_torch.md from the PyTorch port's dry run and
hillclimb, the twin of scripts/gen_experiments.py.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
    PYTHONPATH=src python scripts/torch_hillclimb.py
    PYTHONPATH=src python scripts/torch_gen_experiments.py

It reads dryrun_results.json and hillclimb_results.json (the port's, both
optional) from the working directory and writes EXPERIMENTS_torch.md
there, with the JAX script's sections.  The hypotheses keep their
wording; every number of a finding is computed from the records: counts
of traced shapes times the H100 datasheet rates of `launch/roofline.py`,
not measurements.  No CSV is read: the port's bench workers, which the
paper-claims sections need, come with ROADMAP A20.  A hillclimb row
that is missing or not ok reads "(failed)".  Needs no card and no JAX.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

OUT = "EXPERIMENTS_torch.md"
KIMI = ["kimi_train/base", "kimi_train/fsdp", "kimi_train/fsdp+cap1.0",
        "kimi_train/fsdp+cap1.0+quant", "kimi_train/fsdp+cap1.0+quant+mb4",
        "kimi_train/fsdp+cap1.0+quant@2pods"]
GEMMA = ["gemma_decode/base", "gemma_decode/seqshard"]
SAGE = ["sage_products/base", "sage_products/bf16"]
BFS = [("bfs/base", "paper-faithful"),
       ("bfs/sort_dedup", "sort-dedup replaces scatter-claim"),
       ("bfs/fold_bitmap", "bitmap fold"),
       ("bfs/sort+bitmap", "both"),
       ("bfs/chunk_256k", "smaller edge chunk")]
CSVS = [("Weak scaling (Fig. 3)", "fig3_weak_scaling"),
        ("Strong scaling (Fig. 4)", "fig4_strong_scaling"),
        ("Compute/transfer split + 4-phase breakdown (Fig. 5/6)",
         "fig5_6_breakdown"),
        ("1D vs 2D (Fig. 7)", "fig7_1d_vs_2d"),
        ("Atomic vs scatter/compact expansion (Table 2/Fig. 8)",
         "table2_fig8_expansion_variants"),
        ("Real-world graphs (Table 3)", "table3_realworld"),
        ("Kernel parity (sec. 3.4.1)", "kernel_bench")]


def gib(b):
    return b / 2**30


def ratio(a, b):
    """a / b as "N.NN×" (or "n/a" when b is 0)."""
    return f"{a / b:.3g}×" if b else "n/a"


def times(a, b):
    """b against a as "N× less" or "N× more"."""
    if not (a and b):
        return "n/a"
    return f"{a / b:.3g}× less" if b <= a else f"{b / a:.3g}× more"


def change(a, b):
    """b against a as a signed percentage."""
    return f"{(b - a) / a * 100:+.1f}%" if a else "n/a"


def holds(cond):
    return "holds" if cond else "does not hold"


def fmt_cell(v):
    rl = v["roofline"]
    m = v["memory"]
    frac = ""
    if rl.get("useful_ratio"):
        frac = f"{rl['useful_ratio']:.2f}"
    return (f"{rl['compute_s']:.2e} | {rl['memory_s']:.2e} | "
            f"{rl['collective_s']:.2e} | {rl['dominant'][:4]} | "
            f"{gib(m['argument_bytes']):.1f} | "
            f"{gib(m['temp_bytes']):.1f} | {frac}")


def render(DR, HC):
    """The document's lines from the dry run's and the hillclimb's
    records."""
    from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as KIMI_CFG
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import (HBM_BW, HBM_BYTES, ICI_BW,
                                             PEAK_FLOPS)
    pod = make_production_mesh()
    width = dict(zip(pod.axis_names, pod.shape))

    def ok(name):
        v = HC.get(name)
        return v if v and v.get("status") == "ok" else None

    def cell(key):
        v = DR.get(key)
        return v if v and v.get("status") == "ok" else None

    lines = []
    A = lines.append
    A("# EXPERIMENTS — Distributed 2D BFS (Bisson et al. 2014), the PyTorch "
      "port on NVIDIA H100 (dry-run counts)\n")
    A(f"Hardware model: NVIDIA H100 SXM 80GB — {PEAK_FLOPS / 1e12:g} TFLOP/s "
      f"dense bf16 a card, {HBM_BW / 1e12:g} TB/s HBM, {ICI_BW / 1e9:g} "
      f"GB/s a link each way (NVLink 4), {HBM_BYTES / 1e9:g} GB of HBM "
      "(`repro_torch/launch/roofline.py`).  Every roofline term below is a "
      "count of the shapes of a step traced on the meta device times these "
      "datasheet rates (see §Method); none is a measurement, and no card "
      "ran these steps.\n")

    # ------------------------------------------------------------ dry-run
    A("## §Dry-run\n")
    okc = sum(1 for v in DR.values() if v["status"] == "ok")
    skc = sum(1 for v in DR.values() if v["status"] == "skipped")
    errc = sum(1 for v in DR.values() if v["status"] == "error")
    A("Every (architecture × shape) cell of `repro_torch.configs.ARCHS` "
      "traces once on the meta device over a `StackedMesh` of each "
      "production mesh — single-pod `(16,16) ('data','model')` and "
      "multi-pod `(2,16,16) ('pod','data','model')`, nothing allocated: "
      f"**{okc} traced ok, {skc} documented skips, {errc} failures** "
      f"({len(DR)} records).\n")
    reasons = {}
    for k, v in sorted(DR.items()):
        if v["status"] == "skipped":
            reasons.setdefault(v.get("reason", ""), []).append(
                k.replace("|", " × "))
    for why, keys in reasons.items():
        A(f"Skipped ({why}): {', '.join(keys)}.\n")
    trace_s = [v["lower_s"] for v in DR.values() if v["status"] == "ok"]
    if trace_s:
        A("Multi-pod cells shard over the `pod` axis: batch / data-parallel "
          "splits span pods while the fold and expert all-to-alls stay "
          "inside a pod (the BFS fold stays within a grid row; DESIGN.md "
          f"§5).  Per-cell build and trace time {min(trace_s):g}–"
          f"{max(trace_s):g} s on the host's CPU; the BFS cell traces one "
          "top-down level (§Method).\n")

    # ----------------------------------------------------------- roofline
    A("## §Roofline — single-pod 16×16, per device\n")
    A("### Method")
    A("`launch/roofline.count_step` runs the step once on meta tensors "
      "over the stacked mesh and counts every dispatched op: FLOPs by "
      "`torch.utils.flop_counter`'s formulas (2 × the multiply-adds of "
      "every matmul, bmm, einsum and convolution), HBM bytes as the "
      "operand and result bytes of every op (views excluded), and wire "
      "bytes of the collectives the stacked mesh runs, with ring factors "
      "— all-gather / reduce-scatter / all-to-all (n−1)/n·S, all-reduce "
      "2(n−1)/n·S, permute 1·S.  Loops run as traced, so every trip "
      "counts.  Per-device figures are the stacked totals / devices.  "
      "Where it differs from the JAX package's compiled-HLO count "
      "(ROADMAP C):")
    A("* the bytes are those of unfused ops (XLA counts its fused "
      "program's top-level instructions), so the memory term is an upper "
      "reading;")
    A("* the BFS rows trace ONE top-down level with a full frontier and "
      "one chunk of the engine's own `edge_chunk` a processor, then "
      "`finalize` — per-level costs, as JAX's analyzer weights the level "
      "and chunk loops once;")
    A("* the wire holds no GSPMD tensor-parallel collectives: the port "
      "runs the dense layers whole on every device of the stacked mesh, "
      "so reshards and activation all-reduces the compiler would insert "
      "are not counted;")
    A("* with remat on, `torch.utils.checkpoint` recomputes each layer's "
      "whole forward (XLA recomputes only the attention dots).\n")
    A("`MODEL_FLOPS` = 6·N·D (dense) / 6·N_active·D (MoE) for training, "
      "2·N·D for inference; `useful` = MODEL_FLOPS / (traced FLOPs × "
      "devices).\n")
    A("| arch × shape | compute s | memory s | collective s | dom | "
      "arg GiB/device | temp GiB/device | useful |")
    A("|---|---|---|---|---|---|---|---|")
    for k in sorted(DR):
        v = DR[k]
        if not k.endswith("|single"):
            continue
        name = k[:-7].replace("|", " × ")
        if v["status"] == "skipped":
            A(f"| {name} | — | — | — | skip | — | — | — |")
        elif v["status"] == "ok":
            A(f"| {name} | {fmt_cell(v)} |")
        else:
            A(f"| {name} | (failed) |||||||")
    A("")
    A("### Reading the table (dominant term + what would move it)\n")
    kimi = cell("kimi-k2-1t-a32b|train_4k|single")
    if kimi:
        rl, mem = kimi["roofline"], kimi["memory"]
        arg = gib(mem["argument_bytes"])
        useful = rl.get("useful_ratio")
        A(f"* **kimi-k2 train_4k** — {rl['dominant']}-dominant: "
          f"{rl['memory_s']:.3g} s/step of HBM traffic against "
          f"{rl['compute_s']:.3g} s of compute, and {arg:.1f} GiB/device "
          f"of arguments, which {'fits' if mem['argument_bytes'] <= HBM_BYTES else 'does not fit'} "
          f"a card's {HBM_BYTES / 1e9:g} GB.  Hypothesis: FSDP of the "
          "experts over `data` fits them (→ §Perf cell A)."
          + (f"  Useful-FLOP ratio {useful:.2f}." if useful else ""))
    else:
        A("* **kimi-k2 train_4k** — (not in dryrun_results.json)")
    dec = {k: v for k, v in DR.items() if "|decode" in k
           and k.endswith("|single") and v["status"] == "ok"}
    if dec:
        doms = ", ".join(
            f"{k.split('|')[0]} {v['roofline']['dominant']} "
            f"(w {v['roofline']['collective_s']:.3g} s)"
            for k, v in sorted(dec.items()))
        A(f"* **LM decode cells** — dominant terms: {doms}.  The JAX "
          "package's compiled step reshards a batch-sharded cache against "
          "tensor-parallel weights every layer; the port's trace has no "
          "such wire (§Method), so its decode wire is only the MoE "
          "all-to-alls.  Hypothesis: a sequence-sharded KV cache keeps "
          "the cache local (→ §Perf cell B), read here from the "
          "per-device argument bytes.")
    trn = {k: v for k, v in DR.items() if "|train_4k|single" in k
           and v["status"] == "ok" and not k.startswith("kimi")}
    if trn:
        doms = ", ".join(f"{k.split('|')[0]} {v['roofline']['dominant']}"
                         for k, v in sorted(trn.items()))
        A(f"* **LM train cells** — dominant terms: {doms}.  The JAX "
          "reading (Megatron-TP activation all-reduces as the "
          "sequence-parallel target) cannot be read from these counts: "
          "the port's trace holds no tensor-parallel collectives.")
    gnn = {k: v for k, v in DR.items() if "|ogb_products|single" in k
           and v["status"] == "ok"}
    for k, v in sorted(gnn.items()):
        det = v["roofline"]["collective_detail"]
        expand = det.get("all-gather", 0) + det.get("reduce-scatter", 0)
        fold = det.get("all-to-all", 0)
        if not (expand and fold):
            continue                 # not the 2D SpMM: no expand / fold
        A(f"* **{k.split('|')[0]} ogb_products (full-graph 2D SpMM)** — "
          "hypothesis: expand (all-gather along grid rows, and its "
          "reduce-scatter transpose in the backward pass) and fold "
          "(all-to-all along grid columns) are within 2× of each other, "
          f"the paper's expand/fold balance.  Counted: expand "
          f"{gib(expand):.3g} GiB/device, fold {gib(fold):.3g} GiB/device "
          f"({ratio(max(expand, fold), min(expand, fold) or 1)}): "
          f"{holds(max(expand, fold) <= 2 * min(expand, fold))}; "
          f"{v['roofline']['dominant']}-dominant.")
    bfs = cell("bfs-rmat|rmat_weak|single")
    if bfs:
        rl = bfs["roofline"]
        det = rl["collective_detail"]
        ag, a2a = det.get("all-gather", 0), det.get("all-to-all", 0)
        A(f"* **BFS** — hypothesis: memory-dominant per level (bitmap + "
          "CSC scan traffic ≫ collective bytes), the paper's 'memory "
          f"bandwidth bound with irregular access' (§3.4).  Counted: "
          f"memory {rl['memory_s']:.3g} s, collective "
          f"{rl['collective_s']:.3g} s a level "
          f"({ratio(rl['memory_s'], rl['collective_s'])}): "
          f"{holds(rl['dominant'] == 'memory')}.  Of the wire, expand "
          f"(all-gather) {gib(ag):.3g} GiB/device against fold "
          f"(all-to-all) {gib(a2a):.3g}: the "
          f"{'expand' if ag > a2a else 'fold'} is the larger.\n")
    else:
        A("* **BFS** — (not in dryrun_results.json)\n")

    # --------------------------------------------------------------- perf
    A("## §Perf — hypothesis → change → count log\n")
    A("Paper-faithful BASELINE first, then beyond-paper variants, "
      "counted by `scripts/torch_hillclimb.py` (one trace each, per "
      "device, at the datasheet rates above).  Three arch-cells "
      "(memory-dominant / decode / the paper's SpMM) + the paper's own "
      "workload.\n")

    def hrow(name):
        v = ok(name)
        if not v:
            return f"| {name} | (failed) |||||"
        return (f"| {name} | {v['compute_s']:.2e} | {v['memory_s']:.2e} | "
                f"{v['collective_s']:.2e} | {v['dominant'][:4]} | "
                f"{v['arg_gib']:.1f} | {v['temp_gib']:.1f} |")

    def table(names):
        A("| experiment | compute s | memory s | collective s | dom | "
          "arg GiB | temp GiB |")
        A("|---|---|---|---|---|---|---|")
        for n in names:
            A(hrow(n))

    def needs(*names):
        missing = [n for n in names if not ok(n)]
        if missing:
            A(f"(not counted: {', '.join(missing)} missing or failed)\n")
        return not missing

    cap = KIMI_CFG.moe.capacity_factor
    A("### Cell A: kimi-k2-1t-a32b × train_4k (1T MoE)\n")
    table(KIMI)
    base = ok("kimi_train/base")
    arg_txt = f"{base['arg_gib']:.1f} GiB/device" if base else \
        "the arguments"
    A(f"""
1. **H1 (fit)**: expert weights sharded only over the {width['model']}-wide
   model axis → {arg_txt} of arguments; FSDP over `data` (weights
   gathered just-in-time inside the MoE, freed per layer) should cut the
   expert tensors' arguments ~{width['data']}× at the price of per-layer
   all-gathers. → see `fsdp` row.
2. **H2 (wire)**: dispatch all-to-alls carry bf16 activations ∝
   capacity_factor; capacity {cap:g}→1.0 should cut dispatch wire
   {(1 - 1.0 / cap) * 100:.0f}%; int8-quantised dispatch (per-copy scales)
   another 2×.
3. **H3 (temp)**: 4-way microbatching divides activation temps ~4× at
   equal total FLOPs (a loop over microbatches).
""")
    A("Counted (per device, datasheet rates):\n")
    if needs(*KIMI[:4]):
        b, f, c, q = (ok(n) for n in KIMI[:4])
        A(f"* **FSDP** (H1): arguments {b['arg_gib']:.1f} → "
          f"{f['arg_gib']:.1f} GiB ({times(b['arg_gib'], f['arg_gib'])}), "
          f"memory {b['memory_s']:.3g} → {f['memory_s']:.3g} s, "
          f"collective {change(b['collective_s'], f['collective_s'])} "
          f"(the weight gathers): H1 "
          f"{holds(f['arg_gib'] < b['arg_gib'])}.")
        a2a_f = f["detail"].get("all-to-all", 0)
        a2a_c = c["detail"].get("all-to-all", 0)
        a2a_q = q["detail"].get("all-to-all", 0)
        A(f"* **capacity {cap:g}→1.0** (H2): dispatch all-to-all "
          f"{change(a2a_f, a2a_c)}, compute "
          f"{change(f['compute_s'], c['compute_s'])}, memory "
          f"{change(f['memory_s'], c['memory_s'])}.")
        A(f"* **int8 dispatch** (H2): dispatch all-to-all "
          f"{change(a2a_c, a2a_q)}, whole wire "
          f"{change(c['collective_s'], q['collective_s'])}, memory "
          f"{change(c['memory_s'], q['memory_s'])}.")
    if needs(KIMI[3], KIMI[4]):
        q, m = ok(KIMI[3]), ok(KIMI[4])
        A(f"* **microbatching ×4** (H3): temp {q['temp_gib']:.1f} → "
          f"{m['temp_gib']:.1f} GiB ({times(q['temp_gib'], m['temp_gib'])}), "
          f"memory {q['memory_s']:.3g} → {m['memory_s']:.3g} s, wire "
          f"{times(q['collective_s'], m['collective_s'])}: H3 "
          f"{holds(m['temp_gib'] * 2 <= q['temp_gib'])}.")
    if needs(KIMI[3], KIMI[5]):
        q, p2 = ok(KIMI[3]), ok(KIMI[5])
        moments = KIMI_CFG.param_count() * 8 / (width["data"]
                                                * width["model"])
        A(f"* **2 pods**: per-device compute {q['compute_s']:.3g} → "
          f"{p2['compute_s']:.3g} s, memory {q['memory_s']:.3g} → "
          f"{p2['memory_s']:.3g} s, temp {q['temp_gib']:.1f} → "
          f"{p2['temp_gib']:.1f} GiB.  fp32 Adam moments of "
          f"{KIMI_CFG.param_count():.3g} params over one pod's "
          f"{width['data'] * width['model']} devices: {gib(moments):.1f} "
          f"GiB/device of the card's {gib(HBM_BYTES):.1f} GiB.")
    kimi_ok = [ok(n) for n in KIMI[:5] if ok(n)]
    if base and kimi_ok:
        best = min(kimi_ok, key=lambda v: v[v["dominant"] + "_s"])
        dom = base["dominant"] + "_s"
        A(f"* **Net on the dominant term** ({base['dominant']}): "
          f"{base[dom]:.3g} s → {best[dom]:.3g} s "
          f"({ratio(base[dom], best[dom])}) on one pod"
          + (f", {ok(KIMI[5])[dom]:.3g} s on 2 pods." if ok(KIMI[5])
             else "."))
    A("")
    A("### Cell B: gemma2-2b × decode_32k (decode)\n")
    table(GEMMA)
    A("""
**H**: the baseline shards the KV cache on batch over `data` while the
weights are tensor-parallel over `model`, so every layer reshards the
cache; sequence-sharding the cache (flash-decoding's split-KV expressed
as a sharding) should keep it local and shrink the per-device cache.
""")
    if needs(*GEMMA):
        b, s = ok(GEMMA[0]), ok(GEMMA[1])
        A(f"Counted: arguments {b['arg_gib']:.1f} → {s['arg_gib']:.1f} "
          f"GiB/device ({times(b['arg_gib'], s['arg_gib'])}), temp "
          f"{b['temp_gib']:.2f} → {s['temp_gib']:.2f} GiB, memory "
          f"{b['memory_s']:.3g} → {s['memory_s']:.3g} s/token, wire "
          f"{b['collective_s']:.3g} → {s['collective_s']:.3g} s.  The "
          "per-device cache shrinks as the hypothesis says; the reshard "
          "it removes is GSPMD wire the port's trace does not hold, and "
          "the memory term is the stacked step's bytes / devices, which "
          "no sharding moves (§Method).\n")
    A("### Cell C: graphsage-reddit × ogb_products (the paper's "
      "expand/fold as SpMM)\n")
    table(SAGE)
    A("""
**H**: bf16 features and parameters should halve the expand/fold wire
(the whole layer pipeline in bf16, so no layer output promotes back to
f32).
""")
    if needs(*SAGE):
        b, h = ok(SAGE[0]), ok(SAGE[1])
        r = h["wire_bytes"] / b["wire_bytes"] if b["wire_bytes"] else 1.0
        A(f"Counted: wire {b['collective_s']:.3g} → {h['collective_s']:.3g}"
          f" s ({times(b['wire_bytes'], h['wire_bytes'])}), memory "
          f"{b['memory_s']:.3g} → {h['memory_s']:.3g} s "
          f"({times(b['memory_s'], h['memory_s'])}): H "
          f"{holds(abs(r - 0.5) <= 0.025)}.\n")
    A("### The paper's workload: BFS (2D, 16×16 grid, Table 1's scale "
      "for 256 devices)\n")
    A("| experiment | compute s/level | memory s/level | collective "
      "s/level | dom | note |")
    A("|---|---|---|---|---|---|")
    for n, note in BFS:
        v = ok(n)
        if v:
            A(f"| {n} | {v['compute_s']:.2e} | {v['memory_s']:.2e} | "
              f"{v['collective_s']:.2e} | {v['dominant'][:4]} | {note} |")
        else:
            A(f"| {n} | (failed) ||||| ")
    A("")
    A("Measured wall-clock: the port's bench workers come with ROADMAP "
      "A20; no CSV of the port's exists yet.\n")
    A("Hypothesis log:")
    b = ok("bfs/base")
    if b:
        def term(v, t):
            return f"{b[t]:.3g} → {v[t]:.3g}"
        v = ok("bfs/sort_dedup")
        A("1. **sort-dedup** (replace the O(n_rows) scatter-claim temp "
          "with an O(chunk log chunk) sort): "
          + (f"memory term {term(v, 'memory_s')} s a level "
             f"({change(b['memory_s'], v['memory_s'])})."
             if v else "(failed)"))
        v = ok("bfs/fold_bitmap")
        if v:
            fa, fb = (b["detail"].get("all-to-all", 0),
                      v["detail"].get("all-to-all", 0))
            A("2. **bitmap fold** (beyond-paper, 1 bit a row in place of "
              f"a 32-bit id): fold wire {times(fa, fb)}, collective "
              f"term {change(b['collective_s'], v['collective_s'])}, "
              f"memory term {change(b['memory_s'], v['memory_s'])} (the "
              "pack / unpack is local work).")
        else:
            A("2. **bitmap fold**: (failed)")
        A("3. **direction-optimising switch** (beyond-paper): a "
          "wall-clock claim, no dry-run experiment; it waits for the "
          "port's bench workers (ROADMAP A20).")
        v = ok("bfs/chunk_256k")
        A("4. **edge_chunk 1M→256k**: "
          + (f"memory term {term(v, 'memory_s')} s a level "
             f"({change(b['memory_s'], v['memory_s'])}; the chunk's "
             "temps shrink)." if v else "(failed)"))
        dom = b["dominant"] + "_s"
        small = [n for n, _ in BFS[1:] if ok(n)
                 and abs(ok(n)[dom] - b[dom]) < 0.05 * b[dom]]
        A(f"\nStopping rule: {len(small)} of {len(BFS) - 1} variants move "
          f"the dominant ({b['dominant']}) term by less than 5%"
          + (f" ({', '.join(small)})." if small else "."))
    else:
        A("(not counted: bfs/base missing or failed)")
    A("")

    # ---------------------------------------------------- paper claims
    A("## §Paper-claims validation\n")
    for title, name in CSVS:
        A(f"* **{title}** (`{name}`): the port's bench workers come with "
          "ROADMAP A20; no CSV of the port's exists yet.")
    A("* **Graph500 validation**: the port's BFS outputs pass the 5-rule "
      "validator (`repro_torch.core.validate_bfs`: tree structure, level "
      "consistency, edge levels ≤1, full component coverage) in its tests "
      "and in `chip_smoke.py`.")
    A("* **Kernels**: each of the port's 11 CUDA kernels is held against "
      "its plain version on the card by `chip_smoke.py`, whose times are "
      "in PERF.md §6.")
    A("")
    return lines


def main():
    with open("dryrun_results.json") as f:
        dr = json.load(f)
    hc = {}
    if os.path.exists("hillclimb_results.json"):
        with open("hillclimb_results.json") as f:
            hc = json.load(f)
    lines = render(dr, hc)
    with open(OUT, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {OUT} ({len(lines)} lines)")


if __name__ == "__main__":
    main()
