"""Forward-backward entry points and device batch budgets.

Every DP runs the same plain-JAX code on every platform: the XLA scan
engine of ops/fb.py for posteriors (realign, caller) and for EM expected
counts.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .fb import DeviceBatch, FbTables, forward_backward


# Padded DP cells per device batch on the CPU backend (EM: per trial).
CPU_BATCH_CELLS = {"guide": 128_000_000, "realign": 128_000_000,
                   "caller": 96_000_000, "em": 88_000_000}
# Peak device bytes per padded cell (quantized D1 x quantized lanes x band
# width, as ops/band.bucket_by_cells counts it) while a stage's bucket is
# in flight.  The FB engine alone takes ~54: for 3,072 lanes x 7,168
# diagonals at band 21 (462M cells), memory_analysis() on an H100 gives
# 1.8 GB of inputs, 2.1 GB of outputs and 21.2 GB of temporaries (the five
# forward states of ops/fb.py).  The realign MEA pass and the caller's
# lane expectations take less.  EM's figure is per lockstep trial: the
# vmap over trials holds every trial's forward states.  The guide NW
# stores int8 bands and a uint8 pointer band and keeps its three f32
# states only in the scan carry.  chip_smoke.py phase 2 compiles realign's
# FB and the three-trial E-step at these budgets and checks each figure
# against memory_analysis().
BYTES_PER_CELL = {"guide": 16, "realign": 64, "caller": 64, "em": 64}
# Share of the device's allocator limit one bucket may take (realign keeps
# two buckets per device in flight).
BATCH_MEMORY_SHARE = 0.25


def max_batch_cells_for(stage: str, device=None, trials: int = 1) -> int:
    """Padded DP cells per device batch for stage 'guide', 'realign',
    'caller' or 'em': BATCH_MEMORY_SHARE of the device's
    memory_stats()["bytes_limit"] over the stage's BYTES_PER_CELL (an
    80 GB H100 at JAX's default 75% limit: ~234M cells for realign), or
    CPU_BATCH_CELLS on the CPU backend; either divided by the number of
    EM trials that share each batch."""
    if device is None:
        from ..parallel.runtime import local_dispatch_devices

        device = local_dispatch_devices()[0]
    if device.platform == "cpu":
        return CPU_BATCH_CELLS[stage] // trials
    limit = device.memory_stats()["bytes_limit"]
    return int(limit * BATCH_MEMORY_SHARE) // (BYTES_PER_CELL[stage] * trials)


def fb_posteriors(
    tables: FbTables, batch: DeviceBatch
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(logZ [B], posterior match band [D1, Wp, B]) for realign and the
    caller: the one place a posterior engine is chosen, the XLA scan
    engine of ops/fb.py on every platform.  A CUDA kernel for Hopper was
    measured here and removed: its forward-backward alone was 17x faster,
    but over ten alternating pairs on an H100 the realign stage gained
    2.7% at the median and the caller stage lost 8% (docs/KERNELS.md)."""
    res = forward_backward(
        tables, batch, want_posteriors=True, want_counts=False
    )
    return res.logZ, res.posteriors


def fb_counts(tables: FbTables, batch: DeviceBatch):
    """(logZ [B], trans_counts [5,5], emit_match [5,5], emit_gap [5,5])
    (EM E-step)."""
    res = forward_backward(
        tables, batch, want_posteriors=False, want_counts=True
    )
    return res.logZ, res.trans_counts, res.emit_match, res.emit_gap


def fb_counts_trials(tables_stacked: FbTables, batch: DeviceBatch):
    """Lockstep EM trials: expected counts for Ntr models over one batch in
    ONE device call (a vmap of the XLA engine).  tables_stacked leaves are
    [Ntr, ...]; returns (logZ [Ntr, B], trans [Ntr,5,5],
    emit_match [Ntr,5,5], emit_gap [Ntr,5,5])."""
    res = jax.vmap(
        lambda t: forward_backward(
            t, batch, want_posteriors=False, want_counts=True
        ),
        in_axes=(FbTables(T=0, Ematch=0, Egap=0, pi=0),),
    )(tables_stacked)
    return res.logZ, res.trans_counts, res.emit_match, res.emit_gap
