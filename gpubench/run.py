#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the CUDA card(s) of this
machine, from the root of a checkout:

    python3 gpubench/run.py --workload g500-toy-2x2.bfs --seed 7 \
        --seconds 30 --trace 0

Prints progress and the compared numbers beside their limits on standard
error, and as the last line of standard output one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and `checks` last.  Exits non-zero, printing no result, without a CUDA
card (or with fewer than the cell asks for), and if the run loaded `jax`,
`jaxlib`, `flax` or the JAX package `repro`.

`--control` puts the reference's control in the program's place (a search
that breaks one guarantee): its runs must come out `correct: false`.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "gpubench-cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    # every kernel cache of the run at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from gpubench import harness
    harness.log(f"imports done at {time.perf_counter() - T_START:.2f} s")

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(manifest, args.workload, ROOT)
    if not torch.cuda.is_available():
        print("gpubench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {cell.name} needs {cell.chips} cards, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program; absent: no run)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START,
                         "control" if args.control else "port")
    found = harness.forbidden_modules()     # the window has closed
    if found:
        print(f"gpubench: the run loaded {', '.join(found)}: the benchmark "
              f"measures the port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
