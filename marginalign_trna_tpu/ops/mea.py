"""Maximum-expected-accuracy (AMAP) realignment decode.

Device equivalent of cPecanRealign's posterior-decoding realignment
(reference: the realigned cigar emitted per read at
src/margin/marginAlignLib.py:315-318, AMAP objective weighted by
--gapGamma/--matchGamma, src/margin/marginAlign.py:30-33).

Objective over a monotone alignment path:
    sum_{matched (i,j)} p(i,j) + gapGamma * sum_{skipped read i} (1 - r_i)
                              + gapGamma * sum_{skipped ref j} (1 - c_j)
where p = posterior match probability (from ops/fb.py), r_i / c_j its row and
column sums.  Pairs with p < matchGamma are disallowed.  The DP runs banded
on device (same wavefront machinery as ops/fb.py) emitting 2-bit move
pointers; the traceback walks them on device (ops/traceback_device.py).
"""
from __future__ import annotations

from functools import partial
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.obs import stage_sync, stage_timer
from .band import BandedBatch
from .fb import _shift, device_batch
from .traceback_device import mea_moves_device, pack_moves, pull_ops

NEG = -1e30
# Canonical MEA weights.  Alternative paths that add the same weights in
# another order (an indel's place in a homopolymer, the order of an I and a
# D) tie in exact arithmetic, and f32 rounding breaks those ties by
# summation order: a 1e-7 relative perturbation of the posteriors (another
# backend's rounding) changed ~10% of 3 kb cigars.  So the weights snap to
# multiples of 2^-20, where the max-plus sums are exact, and each move of
# each cell gets a deterministic jitter of 0..15 grid steps (<= 1.4e-5)
# hashed from the cell's (i, j): ties break the same pseudo-random way on
# every backend, whichever lane or batch the read is in.
WEIGHT_GRID = float(2 ** 20)


def snap(w):
    """w rounded to the MEA weight grid (NEG, the banned-move mark, kept)."""
    return jnp.where(w <= NEG / 2, w, jnp.round(w * WEIGHT_GRID) / WEIGHT_GRID)


def _tie_jitter(lo, wp: int):
    """[3, D1, Wp, B] jitter for the diag, up and left moves of each cell."""
    d = jax.lax.broadcasted_iota(jnp.uint32, (lo.shape[0], 1, 1), 0)
    rows = jax.lax.broadcasted_iota(jnp.uint32, (1, wp, 1), 1)
    i = lo[:, None, :].astype(jnp.uint32) + rows
    out = []
    for salt in (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35):
        h = ((i * jnp.uint32(73856093)) ^ ((d - i) * jnp.uint32(19349663))
             ^ jnp.uint32(salt))
        h = h ^ (h >> 15)
        h = h * jnp.uint32(2654435761)
        h = h ^ (h >> 13)
        out.append((h >> 28).astype(jnp.float32) / WEIGHT_GRID)
    return jnp.stack(out)


@jax.jit
def canonical_weights(wdiag, wup, wleft, lo):
    """(wdiag, wup, wleft) snapped to the grid plus the tie jitter; lo is
    the batch's [D1, B] band offsets."""
    jit = _tie_jitter(lo, wdiag.shape[1])
    return snap(wdiag) + jit[0], snap(wup) + jit[1], snap(wleft) + jit[2]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class MeaResult(NamedTuple):
    pointers: jnp.ndarray  # [D1, Wp, B] uint8 (0=diag, 1=left/ref, 2=up/read)
    score: jnp.ndarray     # [B]


def mea_weights(
    post: np.ndarray, batch: BandedBatch, gap_gamma: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side per-cell gap weights [D1, Wp, B] for read-skip and ref-skip
    moves, from banded posteriors.  wup[d,k,b] applies to the move that skips
    read symbol i-1; wleft to the move skipping ref symbol j-1."""
    D1, Wp, B = post.shape
    ks = np.arange(Wp)
    wup = np.zeros_like(post)
    wleft = np.zeros_like(post)
    for b in range(B):
        m, n = int(batch.m[b]), int(batch.n[b])
        if m == 0 and n == 0:
            continue
        r = np.zeros(max(m, 1))
        c = np.zeros(max(n, 1))
        D = m + n
        lo = batch.lo[: D + 1, b]
        i_idx = lo[:, None] + ks[None, :]
        j_idx = np.arange(D + 1)[:, None] - i_idx
        ok = batch.valid[: D + 1, :, b] & (i_idx >= 1) & (j_idx >= 1)
        pi = post[: D + 1, :, b]
        np.add.at(r, np.clip(i_idx - 1, 0, m - 1)[ok], pi[ok])
        np.add.at(c, np.clip(j_idx - 1, 0, n - 1)[ok], pi[ok])
        g_read = gap_gamma * np.clip(1.0 - r, 0.0, 1.0)
        g_ref = gap_gamma * np.clip(1.0 - c, 0.0, 1.0)
        oku = batch.valid[: D + 1, :, b] & (i_idx >= 1)
        okl = batch.valid[: D + 1, :, b] & (j_idx >= 1)
        wup[: D + 1, :, b][oku] = g_read[np.clip(i_idx - 1, 0, m - 1)[oku]]
        wleft[: D + 1, :, b][okl] = g_ref[np.clip(j_idx - 1, 0, n - 1)[okl]]
    return wup, wleft


@partial(jax.jit, static_argnames=("width", "rgm", "rgn"))
def _mea_weights_jit(
    post, valid, lo, e1r, e1c, gap_gamma, width: int, rgm: int, rgn: int
):
    """Device mea_weights: per-position posterior sums via the banded
    monotone segment-sum (see ops/expectations.py — read positions move
    0/1 per diagonal exactly like reference positions), then the clipped
    gap weights are gathered back into band layout."""
    from .expectations import prefix_tables, run_sums

    D1, Wp, B = post.shape
    d = jax.lax.broadcasted_iota(jnp.int32, (D1, 1, 1), 0)
    k = jax.lax.broadcasted_iota(jnp.int32, (1, Wp, 1), 1)
    i = lo[:, None, :].astype(jnp.int32) + k
    j = d - i
    ok = valid & (i >= 1) & (j >= 1)
    tables = prefix_tables(jnp.where(ok, post, 0.0))

    accr = jnp.zeros((rgm, B), post.dtype)  # row sums r_{i-1}
    accc = jnp.zeros((rgn, B), post.dtype)  # col sums c_{j-1}
    for kk in range(width):
        accr = accr + run_sums(
            tables, kk, e1r[width - kk : width - kk + rgm + 1, :])
        accc = accc + run_sums(tables, kk, e1c[kk : kk + rgn + 1, :])

    g_read = gap_gamma * jnp.clip(1.0 - accr, 0.0, 1.0)  # [rgm, B]
    g_ref = gap_gamma * jnp.clip(1.0 - accc, 0.0, 1.0)   # [rgn, B]
    iu = jnp.clip(i - 1, 0, rgm - 1)
    ju = jnp.clip(j - 1, 0, rgn - 1)
    wup = jnp.where(
        valid & (i >= 1),
        jnp.take_along_axis(
            jnp.broadcast_to(g_read[:, None, :], (rgm, Wp, B)), iu, axis=0
        ),
        0.0,
    )
    wleft = jnp.where(
        valid & (j >= 1),
        jnp.take_along_axis(
            jnp.broadcast_to(g_ref[:, None, :], (rgn, Wp, B)), ju, axis=0
        ),
        0.0,
    )
    return wup, wleft


def mea_weights_device(post, batch: BandedBatch, gap_gamma: float,
                       valid=None):
    """Device arrays (wup, wleft) [D1, Wp, B], computed where post lives
    (host inputs follow it there); valid defaults to batch.valid."""
    from .expectations import read_position_boundaries, run_boundaries

    n_real = batch.batch
    rgm = _round_up(max(int(batch.m.max()), 1), 256)
    rgn = _round_up(max(int(batch.n.max()), 1), 256)
    e1r = read_position_boundaries(batch, rgm, n_real)
    e1c = run_boundaries(batch, np.zeros(n_real, np.int64), rgn, n_real)
    return _mea_weights_jit(
        post,
        batch.valid if valid is None else valid,
        batch.lo,
        e1r,
        e1c,
        np.float32(gap_gamma),
        width=batch.width,
        rgm=rgm,
        rgn=rgn,
    )


@jax.jit
def banded_mea(
    wdiag: jnp.ndarray,   # [D1, Wp, B] posterior match weights (NEG = banned)
    wup: jnp.ndarray,     # [D1, Wp, B]
    wleft: jnp.ndarray,   # [D1, Wp, B]
    valid: jnp.ndarray,   # [D1, Wp, B]
    s1: jnp.ndarray,      # [D1, B]
    s2: jnp.ndarray,      # [D1, B]
    final_d: jnp.ndarray,  # [B]
    final_k: jnp.ndarray,  # [B]
) -> MeaResult:
    D1, Wp, B = wdiag.shape
    dtype = jnp.float32

    a0 = jnp.full((Wp, B), NEG, dtype).at[0, :].set(0.0)
    term_sel = (
        jnp.arange(Wp, dtype=jnp.int32)[:, None]
        == final_k.astype(jnp.int32)[None, :]
    )

    def step(carry, xs):
        a1, a2, delta_prev, cum = carry
        wd, wu, wl, valid_d, s1_d, s2_d = xs

        diag = _shift(a2, s2_d - 1) - delta_prev[None, :] + wd
        up = _shift(a1, s1_d - 1) + wu
        left = _shift(a1, s1_d) + wl

        stackv = jnp.stack([diag, left, up])  # ptr order 0,1,2
        a_new = jnp.max(stackv, axis=0)
        ptr = jnp.argmax(stackv, axis=0).astype(jnp.uint8)
        a_new = jnp.where(valid_d, a_new, NEG)

        delta = jnp.maximum(jnp.max(a_new, axis=0), 0.0)
        a_new = jnp.where(a_new <= NEG / 2, NEG, a_new - delta)
        # Absolute score needs the *cumulative* normalisation added back.
        cum = cum + delta
        term = jnp.max(jnp.where(term_sel, a_new, NEG), axis=0) + cum
        return (a_new, a1, delta, cum), (ptr, term)

    xs = (wdiag[1:], wup[1:], wleft[1:], valid[1:], s1[1:], s2[1:])
    zb = jnp.zeros((B,), dtype)
    carry0 = (a0, jnp.full_like(a0, NEG), zb, zb)
    _, (ptrs, terms) = jax.lax.scan(step, carry0, xs)
    ptrs = jnp.concatenate([jnp.zeros((1, Wp, B), jnp.uint8), ptrs], axis=0)
    t_idx = jnp.maximum(final_d.astype(jnp.int32) - 1, 0)
    score = terms[t_idx, jnp.arange(B)]
    return MeaResult(pointers=ptrs, score=score)


def mea_decode(
    post,
    batch: BandedBatch,
    gap_gamma: float = 0.5,
    match_gamma: float = 0.0,
    dev=None,
) -> List[List[Tuple[int, int]]]:
    """Decode realigned cigars for every read in the batch.

    post: [D1, Wp, B] banded posterior match probabilities (a device array
    stays on its device through the weights, the DP and the traceback;
    only the 2-bit move stream comes back).  dev: the batch's DeviceBatch when
    it is already on the device.
    Returns per-read aligned ops [(op, len)] with 0=M, 1=I, 2=D spanning the
    full (m, n) region.
    """
    if dev is None:
        dev = device_batch(batch)
    post = jnp.asarray(post)
    with stage_timer("mea.weights"):
        wup, wleft = stage_sync(
            mea_weights_device(post, batch, gap_gamma, dev.valid))
    with stage_timer("mea.dp"):
        # Diagonal moves only exist for cells with i >= 1 and j >= 1;
        # other cells keep NEG.  (Cells outside the band are masked by
        # `valid`.)
        wdiag = jnp.where(
            (post >= match_gamma) & (post > 0), post, NEG
        ).astype(jnp.float32)
        wdiag, wup, wleft = canonical_weights(wdiag, wup, wleft, batch.lo)
        res = stage_sync(banded_mea(wdiag, wup, wleft, dev.valid, dev.s1,
                                    dev.s2, dev.final_d, dev.final_k))
    with stage_timer("mea.traceback"):
        moves = stage_sync(pack_moves(mea_moves_device(
            res.pointers, batch.lo, batch.m, batch.n)))
    with stage_timer("mea.pull"):
        return pull_ops(moves, batch.num_steps, batch.batch)
