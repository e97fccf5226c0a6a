"""Hand-written CUDA kernels (sources in `repro_torch/csrc/`) with their
plain torch versions, and path selection.

The fused op and its stages, as `repro.kernels` exports them:

  expand.local_expand  -- the fused local expansion over a whole frontier:
                          workload map, neighbour gather, visited filter
                          and canonical compaction, on the kernel path (B1)
                          or the plain reference formulas, equal on both;
  make_expand_fn, make_value_expand_fn, make_bottomup_fn,
  make_value_bottomup_fn -- the chunk hooks the engines call (and
                          `BFSConfig(expand_fn=...)` takes);
  fold                 -- the fold kernels (compaction, bitmap and delta
                          codecs), the engines' `ops` bundle;
  binsearch_map        -- the workload-map stage as a standalone op (B10);
  visited_filter       -- the visited-filter stage as a standalone op (B11);
  ref                  -- plain oracles of the stages for the tests.

Every name imports eagerly: nothing here needs a card or a compiler until a
kernel launches.
"""
from repro_torch.kernels.bottomup import (bottomup_chunk,
                                          bottomup_chunk_values,
                                          make_bottomup_fn,
                                          make_value_bottomup_fn)
from repro_torch.kernels.expand import (LocalExpandOut, expand_chunk,
                                        expand_chunk_values, local_expand,
                                        make_expand_fn, make_value_expand_fn)
from repro_torch.kernels.fold import (compact_rows, delta_gaps,
                                      delta_positions, pack_bits,
                                      unpack_bits)
from repro_torch.kernels.select import PATHS, resolve_path
from repro_torch.kernels.stages import (binsearch_map, clip_cumul,
                                        filter_tile, map_workload,
                                        visited_filter)

__all__ = sorted([
    "LocalExpandOut", "PATHS", "binsearch_map", "bottomup_chunk",
    "bottomup_chunk_values", "clip_cumul", "compact_rows", "delta_gaps",
    "delta_positions", "expand_chunk", "expand_chunk_values", "filter_tile",
    "local_expand", "make_bottomup_fn", "make_expand_fn",
    "make_value_bottomup_fn", "make_value_expand_fn", "map_workload",
    "pack_bits", "resolve_path", "unpack_bits", "visited_filter"])
