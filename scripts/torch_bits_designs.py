#!/usr/bin/env python3
"""Designs of B3 `pack_bits` and B4 `unpack_bits` timed at the bitmap
fold's real shape, on an NVIDIA GPU.

    python3 scripts/torch_bits_designs.py [--rows 8] [--log2-s 24]
        [--p 0.1725] [--seed 1] [--out FILE.json]

Makes an (N, S) mask on the card at density p (by default the fold of the
SCALE 26 direction-optimised search on a 2x2 grid: N = 8, S = 2^24, 17.25 %
of the bits set) and its words, then builds variants of
`src/repro_torch/csrc/bits.cu` into build/designs_bits/, each made by
replacing lines of the source (the package has no such option):

  committed      the source as it is: pack a word a thread (two 16-byte
                 streaming loads, __ldcs), unpack 16 output bytes a thread
                 (one 16-byte store)
  pack_ballot    pack in the general form: a warp a word, a byte a lane,
                 __ballot_sync (the first CUDA version)
  pack_half      16 mask bytes a thread (one 16-byte load), two threads
                 joining their halves with a shuffle
  pack_words_K   K = 2, 4 words a thread
  pack_ldg       loads through the read-only cache (__ldg) for __ldcs
  unpack_byte    unpack in the general form: a byte a thread (the first
                 CUDA version)
  unpack_halves_K  K = 2, 4 16-byte stores a thread
  unpack_stcs    streaming stores (__stcs)
  unpack_word_K  K = 1, 2, 4 words a thread, two 16-byte stores a word
  unpack_quad    4 consecutive words a thread read as one 16-byte load
                 (needs W % 4 == 0, as at S = 2^24), 8 16-byte stores

With K items a thread, item j of a thread lies j * 256 items (a block's
width) past item 0, so each warp access stays contiguous.

Each variant must equal the plain version on the mask.  Its kernel is then
timed with chip_smoke.py's `cuda_ms` (ten calls queued behind a device
sleep), the variants in turns, forward then backward; printed beside the
bytes bound (each byte in once and out once at 3.35 TB/s) and the share of
it reached.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ANCHOR = "}  // namespace"
PACK_FORM = ("*vector = S % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % "
             "16 == 0;")
UNPACK_FORM = ("*vector = S % 16 == 0 && reinterpret_cast<uintptr_t>(bits) "
               "% 16 == 0;")
PACK_LAUNCH = """\
    const dim3 grid((unsigned)((W + kThreads - 1) / kThreads), (unsigned)N);
    pack_bits_vector_kernel<<<grid, kThreads, 0, st>>>("""
UNPACK_LAUNCH = """\
    const dim3 grid((unsigned)((S / 16 + kThreads - 1) / kThreads),
                    (unsigned)N);
    unpack_bits_vector_kernel<<<grid, kThreads, 0, st>>>(
        reinterpret_cast<const unsigned*>(words),"""
PACK_LOADS = ("const uint4 lo = __ldcs(m);", "? __ldcs(m + 1) :")
UNPACK_STORE = "bits[row * (S / 16) + h] = unpack16(x >> (16 * (h & 1)));"
UNPACK_STCS = ("__stcs(bits + row * (S / 16) + h, "
               "unpack16(x >> (16 * (h & 1))));")
HALF_PACK = r"""
__global__ void pack_bits_half_kernel(const uint4* __restrict__ mask,
                                      unsigned* __restrict__ words,
                                      long long S, long long W) {
  const long long row = blockIdx.y;
  const long long h = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = h < S / 16;
  const unsigned half = live ? pack16(__ldcs(mask + row * (S / 16) + h)) : 0u;
  const unsigned other = __shfl_xor_sync(0xffffffffu, half, 1);
  if (live && (h & 1) == 0) words[row * W + h / 2] = half | other << 16;
}
"""
HALF_PACK_LAUNCH = """\
    const dim3 grid((unsigned)((S / 16 + kThreads - 1) / kThreads),
                    (unsigned)N);
    pack_bits_half_kernel<<<grid, kThreads, 0, st>>>("""
WORDS_PACK = r"""
template <int kWords>
__global__ void pack_bits_words_kernel(const uint4* __restrict__ mask,
                                       unsigned* __restrict__ words,
                                       long long S, long long W) {
  const long long row = blockIdx.y;
  const long long w0 = (long long)blockIdx.x * kWords * kThreads +
                       threadIdx.x;
  const uint4* m = mask + row * (S / 16);
  uint4 lo[kWords], hi[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {   // every load issued before a store
    const long long w = w0 + (long long)j * kThreads;
    lo[j] = hi[j] = make_uint4(0u, 0u, 0u, 0u);
    if (w < W) lo[j] = __ldcs(m + 2 * w);
    if (32 * w + 16 < S) hi[j] = __ldcs(m + 2 * w + 1);
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const long long w = w0 + (long long)j * kThreads;
    if (w < W) words[row * W + w] = pack16(lo[j]) | pack16(hi[j]) << 16;
  }
}
"""
HALVES_UNPACK = r"""
template <int kHalves>
__global__ void unpack_bits_halves_kernel(const unsigned* __restrict__ words,
                                          uint4* __restrict__ bits,
                                          long long S, long long W) {
  const long long row = blockIdx.y;
  const long long halves = S / 16;
  const long long h0 = (long long)blockIdx.x * kHalves * kThreads +
                       threadIdx.x;
  uint4* out = bits + row * halves;
  unsigned x[kHalves];
#pragma unroll
  for (int j = 0; j < kHalves; ++j) {
    const long long h = h0 + (long long)j * kThreads;
    x[j] = h < halves ? __ldg(words + row * W + h / 2) : 0u;
  }
#pragma unroll
  for (int j = 0; j < kHalves; ++j) {
    const long long h = h0 + (long long)j * kThreads;
    if (h < halves) out[h] = unpack16(x[j] >> (16 * (h & 1)));
  }
}
"""
WORD_UNPACK = r"""
template <int kWords>
__global__ void unpack_bits_word_kernel(const unsigned* __restrict__ words,
                                        uint4* __restrict__ bits,
                                        long long S, long long W) {
  const long long row = blockIdx.y;
  const long long used = (S + 31) / 32;
  const long long w0 = (long long)blockIdx.x * kWords * kThreads +
                       threadIdx.x;
  uint4* out = bits + row * (S / 16);
  unsigned x[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const long long w = w0 + (long long)j * kThreads;
    x[j] = w < used ? __ldg(words + row * W + w) : 0u;
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const long long w = w0 + (long long)j * kThreads;
    if (w < used) out[2 * w] = unpack16(x[j]);
    if (32 * w + 16 < S) out[2 * w + 1] = unpack16(x[j] >> 16);
  }
}
"""
QUAD_UNPACK = r"""
__global__ void unpack_bits_quad_kernel(const uint4* __restrict__ words,
                                        uint4* __restrict__ bits,
                                        long long S, long long W) {
  const long long row = blockIdx.y;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (128 * q >= S) return;
  const uint4 x = __ldg(words + row * (W / 4) + q);
  const unsigned xs[4] = {x.x, x.y, x.z, x.w};
  uint4* out = bits + row * (S / 16) + 8 * q;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long s = 128 * q + 32 * k;
    if (s < S) out[2 * k] = unpack16(xs[k]);
    if (s + 16 < S) out[2 * k + 1] = unpack16(xs[k] >> 16);
  }
}
"""
QUAD_UNPACK_LAUNCH = """\
    const dim3 grid((unsigned)(((S + 127) / 128 + kThreads - 1) / kThreads),
                    (unsigned)N);
    unpack_bits_quad_kernel<<<grid, kThreads, 0, st>>>(
        reinterpret_cast<const uint4*>(words),"""


def _launch(kernel: str, items, k: int, cast: str) -> str:
    """A launch of `kernel` over `items` (a C expression, per row), k a
    thread."""
    return f"""\
    const long long per_block = {k}LL * kThreads;
    const dim3 grid((unsigned)(({items} + per_block - 1) / per_block),
                    (unsigned)N);
    {kernel}<<<grid, kThreads, 0, st>>>({cast}"""


def _insert(kernel: str):
    return (ANCHOR, kernel + ANCHOR)


UNPACK_WORDS = "\n        reinterpret_cast<const unsigned*>(words),"

# name -> (the kernel it changes, or None for both; its edits)
DESIGNS = {
    "committed": (None, ()),
    "pack_ballot": ("pack_bits", ((PACK_FORM, "*vector = 0;"),)),
    "pack_half": ("pack_bits", (_insert(HALF_PACK),
                                (PACK_LAUNCH, HALF_PACK_LAUNCH))),
    **{f"pack_words_{k}": ("pack_bits", (_insert(WORDS_PACK), (
        PACK_LAUNCH, _launch(f"pack_bits_words_kernel<{k}>", "W", k, ""))))
       for k in (2, 4)},
    "pack_ldg": ("pack_bits", tuple(
        (load, load.replace("__ldcs", "__ldg")) for load in PACK_LOADS)),
    "unpack_byte": ("unpack_bits", ((UNPACK_FORM, "*vector = 0;"),)),
    **{f"unpack_halves_{k}": ("unpack_bits", (_insert(HALVES_UNPACK), (
        UNPACK_LAUNCH, _launch(f"unpack_bits_halves_kernel<{k}>", "S / 16",
                               k, UNPACK_WORDS))))
       for k in (2, 4)},
    "unpack_stcs": ("unpack_bits", ((UNPACK_STORE, UNPACK_STCS),)),
    **{f"unpack_word_{k}": ("unpack_bits", (_insert(WORD_UNPACK), (
        UNPACK_LAUNCH, _launch(f"unpack_bits_word_kernel<{k}>",
                               "(S + 31) / 32", k, UNPACK_WORDS))))
       for k in (1, 2, 4)},
    "unpack_quad": ("unpack_bits", (_insert(QUAD_UNPACK),
                                    (UNPACK_LAUNCH, QUAD_UNPACK_LAUNCH))),
}


def design_source(name: str) -> str:
    """The text of bits.cu with design `name`'s edits applied."""
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                           "bits.cu")) as f:
        text = f.read()
    for old, new in DESIGNS[name][1]:
        n = text.count(old)
        if n != 1:
            raise RuntimeError(f"design {name}: bits.cu holds {n} copies of "
                               f"{old!r}, not 1")
        text = text.replace(old, new)
    return text


def build_designs() -> dict:
    """{name: path of its built library}, all nvcc runs in parallel."""
    from repro_torch.kernels import build
    out = os.path.join(ROOT, "build", "designs_bits")
    os.makedirs(out, exist_ok=True)
    running = []
    for name in DESIGNS:
        src = os.path.join(out, f"{name}.cu")
        with open(src, "w") as f:
            f.write(design_source(name))
        lib = os.path.join(out, f"lib{name}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src]
        running.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, lib, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for design {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {' | '.join(regs)}", flush=True)
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--log2-s", type=int, default=24)
    ap.add_argument("--p", type=float, default=0.1725)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import fold as KF

    smi = chip_smoke.nvidia_smi_line()
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    libs = build_designs()
    print(f"built {len(libs)} designs in {time.perf_counter() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda")
    N, S = args.rows, 1 << args.log2_s
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    mask = torch.rand((N, S), generator=gen, device=dev) < args.p
    words = KF.plain_pack_bits(mask)
    W = words.shape[1]
    bound_ms = (N * S + 4 * N * W) / chip_smoke.HBM_BYTES_PER_S * 1e3
    calls = {"pack_bits": lambda: KF.pack_bits(mask),
             "unpack_bits": lambda: KF.unpack_bits(words, S)}
    wants = {"pack_bits": words, "unpack_bits": mask}
    print(f"N={N} S={S} set {int(mask.sum())}: bound {bound_ms:.5f} ms "
          f"({N * S + 4 * N * W} B at 3.35 TB/s)", flush=True)
    report = {"device": smi, "N": N, "S": S, "p": args.p,
              "bound_ms": bound_ms, "designs": {}}
    for kname, fn in calls.items():
        names = [n for n, (k, _) in DESIGNS.items() if k in (None, kname)]
        forms = {}
        for name in names:
            build._libs["bits"] = ctypes.CDLL(libs[name])
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, wants[kname]):
                raise AssertionError(f"{kname} design {name} differs from "
                                     f"the plain version")
            forms[name] = getattr(KF, kname).last_form
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            build._libs["bits"] = ctypes.CDLL(libs[name])
            times[name].append(chip_smoke.cuda_ms(torch, fn))
        print(f"{kname}: ms a call (two turns), share of the bound",
              flush=True)
        for name, ms in times.items():
            mean = sum(ms) / len(ms)
            print(f"  {name:14s} {forms[name]:8s} {ms[0]:.4f} / {ms[1]:.4f}"
                  f" ms, {bound_ms / mean:.3f} of the bound; equal to the "
                  f"plain version", flush=True)
            report["designs"][f"{kname}:{name}"] = {"form": forms[name],
                                                    "ms": ms}
    build._libs.pop("bits", None)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
