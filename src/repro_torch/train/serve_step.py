"""Serving-side step factories, the port of `repro/train/serve_step.py`:
batched decode with a persistent KV cache.  The cache is an input and an
output (the JAX step donates it; the port's `decode_step` writes it in
place); one token is produced per call."""
from __future__ import annotations

from typing import Callable


def make_serve_step(decode_fn: Callable):
    """decode_fn(params, cache, tokens, pos) -> (next_tokens, cache)."""

    def serve_step(params, cache, tokens, pos):
        nxt, cache = decode_fn(params, cache, tokens, pos)
        return nxt, cache

    return serve_step
