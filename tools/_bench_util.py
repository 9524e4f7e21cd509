"""Shared timing helpers for the device tools.

Dispatch is asynchronous, so every timed window ends in
``jax.block_until_ready`` on the outputs of every call it timed.
"""

from __future__ import annotations

import time


def timed(fn, *args, iters=6):
    """Mean seconds per call of fn(*args) (first call = warmup/compile)."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / iters


def timed_batches(fn, args_list, iters=4):
    """Mean seconds per call of fn over a list of argument tuples."""
    import jax

    jax.block_until_ready(fn(*args_list[0]))
    t0 = time.perf_counter()
    outs = [fn(*a) for _ in range(iters) for a in args_list]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / (iters * len(args_list))
