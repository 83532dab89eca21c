"""Device-side accumulation of marginCaller base expectations.

The reference accumulates {(refName, refPos) -> {base -> sum of posterior
probs}} dicts per chunk and merges pickles (marginCallerLib.py:60-74,
179-187).  Our equivalent output is a dense [total_ref_len, 4] tensor, but
scattering ~1e8 posterior band cells into it with host np.add.at costs tens
of seconds per batch.

Device formulation: a banded monotone segment-sum.  For band row k of
lane b, cell (d, k) targets reference position

    g(d, k) = gu(d) - k - 1,     gu(d) = ref_offset + d - lo(d),

and gu is non-decreasing in d with steps of 0/1 (lo steps 0/1 per
diagonal).  Hence for fixed (k, b) every target position g collects a
*contiguous run* of diagonals, and the whole scatter becomes, per base
code:

    prefix sums along d  ->  gathers per band row at host-precomputed run
    boundaries E1[v] = #{d : gu(d) <= v}  ->  differences, summed over k
    (two-level prefixes, so only small numbers are ever differenced).

Each lane sums over its own window (ref_offset 0), so the device result is
[4, max n, lanes]; the host adds the lane windows into the reference with
one bincount per base.  There is no scatter on device and nothing
sequential per diagonal.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .band import BandedBatch


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


PREFIX_BLOCK = 64  # diagonals per block of the two-level prefix sums


def prefix_tables(w):
    """Two-level exclusive prefix sums of w [D1, Wp, B] along d, for
    run_sums: L [nblk * PREFIX_BLOCK, Wp, B] within-block prefixes, T
    [nblk, Wp, B] block totals, Bp [nblk + 1, Wp, B] block prefixes, with
    nblk * PREFIX_BLOCK > D1 so every boundary 0..D1 has an entry.

    A plain cumsum reaches ~1e3 along a band row at 3.5 kb, where one f32
    ulp is ~1e-4, and differencing two such prefixes loses the short
    runs' sums to that rounding (and to the backend's summation order).
    Here a run inside one block differences within-block prefixes, and a
    run crossing one block edge adds that block's total: small numbers
    only, whatever the read length."""
    D1, Wp, B = w.shape
    nblk = D1 // PREFIX_BLOCK + 1
    w = jnp.pad(w, [(0, nblk * PREFIX_BLOCK - D1), (0, 0), (0, 0)])
    inc = jnp.cumsum(w.reshape(nblk, PREFIX_BLOCK, Wp, B), axis=1)
    L = jnp.concatenate(
        [jnp.zeros((nblk, 1, Wp, B), w.dtype), inc[:, :-1]], axis=1
    ).reshape(nblk * PREFIX_BLOCK, Wp, B)
    T = inc[:, -1]
    Bp = jnp.concatenate(
        [jnp.zeros((1, Wp, B), w.dtype), jnp.cumsum(T, axis=0)], axis=0
    )
    return L, T, Bp


def run_sums(tables, kk: int, bounds):
    """[V-1, B] sums of w[:, kk, :] over the runs [bounds[v], bounds[v+1])
    (bounds [V, B] non-decreasing in v, values in [0, D1])."""
    L, T, Bp = (t[:, kk, :] for t in tables)
    blk = bounds // PREFIX_BLOCK
    lx = jnp.take_along_axis(L, bounds, axis=0)
    bp = jnp.take_along_axis(Bp, blk, axis=0)
    bp1 = jnp.take_along_axis(Bp, blk + 1, axis=0)
    tot = jnp.take_along_axis(T, blk, axis=0)
    cross = jnp.where(blk[1:] == blk[:-1], 0.0,
                      tot[:-1] + (bp[1:] - bp1[:-1]))
    return cross + (lx[1:] - lx[:-1])


@partial(jax.jit, static_argnames=("width", "rg"))
def _expectations_device(post, valid, yb, lo, e1, width: int, rg: int):
    """[4, rg, B] per-lane expected base counts over positions
    v in [0, rg) of each lane's window (see run_boundaries).

    post  [D1, Wp, B] f32   match posteriors
    valid [D1, Wp, B] bool
    yb    [D1, Wp, B] int8  read code at each cell
    lo    [D1, B]     int32 band offsets
    e1    [VE, B]     int32 run boundaries, VE = rg + width + 1
    """
    D1, Wp, B = post.shape
    d = jax.lax.broadcasted_iota(jnp.int32, (D1, 1, 1), 0)
    k = jax.lax.broadcasted_iota(jnp.int32, (1, Wp, 1), 1)
    i = lo[:, None, :].astype(jnp.int32) + k
    j = d - i
    # Cells at i == 0 or j == 0 are grid-boundary prefix cells that emit
    # nothing (reference: AlignedPair iterates real pairs only,
    # src/margin/utils.py:256-287).
    ok = valid & (i >= 1) & (j >= 1)

    def per_code(c):
        tables = prefix_tables(jnp.where(ok & (yb == c), post, 0.0))
        acc = jnp.zeros((rg, B), post.dtype)
        for kk in range(width):
            acc = acc + run_sums(tables, kk, e1[kk : kk + rg + 1, :])
        return acc

    return jax.lax.map(per_code, jnp.arange(4, dtype=jnp.int8))


def run_boundaries(
    batch: BandedBatch, ref_offsets: np.ndarray, rg: int, n_real: int
) -> np.ndarray:
    """E1[v, b] = #{d : gu(d, b) <= v} for v in [0, rg + width], int32.

    ref_offsets[b] is the start of lane b's reference window in the
    position space (0: positions are the lane's own ref indices); lanes
    >= n_real are padding and get all-zero boundaries (no contribution).
    """
    D1 = batch.num_steps
    B = batch.batch
    VE = rg + batch.width + 1
    e1 = np.zeros((VE, B), dtype=np.int32)
    vs = np.arange(VE, dtype=np.int64)
    base = np.arange(D1, dtype=np.int64)
    for b in range(n_real):
        gu = ref_offsets[b] + base - batch.lo[:, b]
        e1[:, b] = np.searchsorted(gu, vs, side="right")
    return e1


def lane_expectations(post, batch: BandedBatch, n_real: Optional[int] = None,
                      dev=None):
    """Device array [4, rg, B]: each lane's expected base counts at its
    own reference positions 0..n-1 (rg = max n rounded up to 128), computed
    where post lives.  Memory is O(max n x lanes), independent of the
    reference length.  dev: the batch's DeviceBatch when it is already on
    the device (its valid/yb bands are reused)."""
    n_real = batch.batch if n_real is None else n_real
    rg = _round_up(max(int(batch.n.max()), 1), 128)  # quantized for reuse
    e1 = run_boundaries(batch, np.zeros(batch.batch, np.int64), rg, n_real)
    return _expectations_device(
        post,
        batch.valid if dev is None else dev.valid,
        batch.yb if dev is None else dev.yb,
        batch.lo,
        e1,
        width=batch.width,
        rg=rg,
    )


def add_lane_expectations(
    exp: np.ndarray, local, batch: BandedBatch, ref_offsets: np.ndarray,
    n_real: Optional[int] = None,
) -> np.ndarray:
    """Add lane_expectations output into exp [total_ref_len, 4] (in place)
    at each lane's reference offset.  A host bincount in lane order: the
    sum is deterministic, whatever device or device count made `local`."""
    n_real = batch.batch if n_real is None else n_real
    local = np.asarray(local)[:, :, :n_real]
    rg = local.shape[1]
    v = np.arange(rg, dtype=np.int64)[:, None]
    inside = v < batch.n[None, :n_real]
    idx = (np.asarray(ref_offsets[:n_real], np.int64)[None, :] + v)[inside]
    for c in range(4):
        exp[:, c] += np.bincount(
            idx, weights=local[c][inside], minlength=exp.shape[0]
        )[: exp.shape[0]]
    return exp


def band_expectations(
    post,
    batch: BandedBatch,
    ref_offsets: np.ndarray,
    total_ref_len: int,
    n_real: Optional[int] = None,
) -> np.ndarray:
    """[total_ref_len, 4] expected base counts for one posterior batch
    (lane b's reference window starts at ref_offsets[b])."""
    exp = np.zeros((total_ref_len, 4))
    return add_lane_expectations(
        exp, lane_expectations(post, batch, n_real), batch, ref_offsets,
        n_real,
    )


def read_position_boundaries(
    batch: BandedBatch, rgm: int, n_real: int
) -> np.ndarray:
    """E1r[t, b] = #{d : lo(d, b) <= t - width} for t in [0, rgm + width],
    int32.  Band row k cells target read position i-1 = lo(d)+k-1, which is
    non-decreasing in d with 0/1 steps, so per-row runs are delimited by
    these prefix counts (sliced per k; see mea_weights_device)."""
    D1 = batch.num_steps
    B = batch.batch
    W = batch.width
    e1 = np.zeros((rgm + W + 1, B), dtype=np.int32)
    ws = np.arange(-W, rgm + 1, dtype=np.int64)
    for b in range(n_real):
        e1[:, b] = np.searchsorted(batch.lo[:, b], ws, side="right")
    return e1


def band_expectations_host(
    post: np.ndarray,
    batch: BandedBatch,
    ref_offsets: np.ndarray,
    total_ref_len: int,
    n_real: Optional[int] = None,
) -> np.ndarray:
    """Host-loop oracle for band_expectations (the original np.add.at
    implementation, kept for tests)."""
    n_real = batch.batch if n_real is None else n_real
    exp = np.zeros((total_ref_len, 4))
    post = np.asarray(post)
    ks = np.arange(batch.wp)
    for b in range(n_real):
        m, n = int(batch.m[b]), int(batch.n[b])
        D = m + n
        lo = batch.lo[: D + 1, b]
        i_idx = lo[:, None] + ks[None, :]
        j_idx = np.arange(D + 1)[:, None] - i_idx
        ok = batch.valid[: D + 1, :, b] & (i_idx >= 1) & (j_idx >= 1)
        p = post[: D + 1, :, b][ok]
        codes = batch.yb[: D + 1, :, b][ok].astype(np.int64)
        keep = codes < 4
        ref_pos = ref_offsets[b] + j_idx[ok][keep] - 1
        np.add.at(exp, (ref_pos, codes[keep]), p[keep])
    return exp
