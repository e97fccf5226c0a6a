"""Multi-pod dry run, the port of `repro/launch/dryrun.py`.

For every (architecture x input shape) cell and each production mesh
(single-pod 16x16, multi-pod 2x16x16) it builds the cell's `DryrunSpec`
and traces the step once on the meta device over the mesh's `StackedMesh`
(`launch/roofline.count_step`): the meta device is to the port what the
JAX package's placeholder host devices are to its dry run.  Nothing is
allocated on a card, no card is needed, and nothing runs: the tensors
carry shapes and dtypes only.  It records, per device:

  memory    argument_bytes / output_bytes: the arguments' and outputs'
            shards under the spec's splits; temp_bytes: the trace's peak
            of live intermediates / chips; alias_bytes and code_bytes are
            null -- the port compiles no program, so it has neither XLA's
            donated-buffer aliasing nor generated code to measure.
  roofline  FLOPs, HBM bytes and wire bytes of the traced step with the
            H100 rates (`launch/roofline.py`).

Results go to a JSON file (resumable: done cells are skipped), one record
per `arch|shape|mesh`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
import traceback


def model_flops_global(arch, shape: str) -> float | None:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for training;
    2 N D for inference passes (prefill/decode); None where ill-defined."""
    if arch.family == "lm":
        mod = importlib.import_module(
            "repro_torch.configs."
            + arch.arch_id.replace("-", "_").replace(".", "_"))
        cfg = mod.CONFIG
        n = cfg.active_param_count() if cfg.moe else cfg.param_count()
        from repro_torch.configs.lm_common import SHAPES
        sh = SHAPES[shape]
        if sh["kind"] == "train":
            return 6.0 * n * sh["batch"] * sh["seq"]
        if sh["kind"] == "prefill":
            return 2.0 * n * sh["batch"] * sh["seq"]
        return 2.0 * n * sh["batch"]          # decode: one token per seq
    return None


def trace_spec(spec, mesh, model_flops: float | None = None):
    """Trace `spec`'s step once on the meta device over `mesh` and account
    for it per device: (memory, `roofline.Roofline`).  memory holds the
    arguments' and outputs' shards under the spec's splits, the trace's
    peak of live intermediates / chips as temp_bytes, and null alias and
    code bytes.  model_flops is GLOBAL (`model_flops_global`)."""
    from repro_torch.configs.common import shard_bytes
    from repro_torch.launch import roofline
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    count = roofline.count_step(spec.fn, *spec.args)
    rl = roofline.analyze(count, model_flops=model_flops, n_chips=mesh.size)
    memory = dict(
        argument_bytes=shard_bytes(spec.args, spec.in_splits, sizes),
        output_bytes=shard_bytes(count.out, spec.out_splits, sizes),
        temp_bytes=int(count.peak_bytes // mesh.size),
        alias_bytes=None, code_bytes=None)
    return memory, rl


def run_cell(arch_id: str, shape: str, mesh_kind: str, results: dict,
             out_path: str):
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_production_mesh, mesh_axes

    key = f"{arch_id}|{shape}|{mesh_kind}"
    if key in results and results[key].get("status") == "ok":
        print(f"[skip] {key} (done)")
        return
    arch = get_arch(arch_id)
    rec = {"arch": arch_id, "shape": shape, "mesh": mesh_kind,
           "status": "running"}
    if shape in arch.skip_shapes:
        rec.update(status="skipped", reason=arch.skip_shapes[shape])
        results[key] = rec
        write_results(results, out_path)
        print(f"[skip] {key}: {rec['reason']}")
        return

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    axes = mesh_axes(mesh)
    t0 = time.time()
    try:
        spec = arch.build_dryrun(shape, mesh, axes)
        memory, rl = trace_spec(spec, mesh, model_flops_global(arch, shape))
        t_lower = time.time() - t0
        rec.update(status="ok", note=spec.note, lower_s=round(t_lower, 1),
                   memory=memory, roofline=rl.as_dict())
        print(f"[ok]   {key}: trace={t_lower:.1f}s "
              f"dom={rl.dominant} c={rl.compute_s:.3e} m={rl.memory_s:.3e} "
              f"w={rl.collective_s:.3e}")
    except Exception as e:  # noqa: BLE001 -- record and continue
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[FAIL] {key}: {type(e).__name__}: {e}")
    results[key] = rec
    write_results(results, out_path)


def write_results(results, path):
    """The records as JSON at `path`, replaced whole (a reader never sees
    half a file)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for arch_id in archs:
        arch = ARCHS[arch_id]
        shapes = arch.shapes if args.shape == "all" else [args.shape]
        for shape in shapes:
            for mk in meshes:
                run_cell(arch_id, shape, mk, results, args.out)
    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"-> {args.out}")
    return n_err


if __name__ == "__main__":
    sys.exit(main())
