"""Band geometry and host-side packing for banded pair-DP on device.

The DP grid is in *prefix coordinates*: cell (i, j) means "i read symbols and
j ref symbols emitted", i in [0, m], j in [0, n].  Anti-diagonal d = i + j runs
from 0 to m+n.  For each d the band is a fixed-width window of W consecutive
i-values [lo(d), lo(d)+W); lo is monotone non-decreasing with increments in
{0, 1}, which lets the device engines express band motion as a one-row
shift per lane (a select between rolled arrays, or a warp shuffle).

This replaces the reference's cPecanRealign banding
(--diagonalExpansion / anchor corridors; see SURVEY.md §5 "long-context") with
a fixed-width wavefront: the band follows the guide alignment path, covering
~W/2 cells either side of it on every anti-diagonal.

Packing: a batch of reads becomes dense [D+1, Wp, B] arrays with the band
window (Wp >= W + 2 guard rows) in the middle dimension and reads in the
last.  All packing is vectorised numpy on the host; the device only ever
sees static shapes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.seq import encode

GUARD = 2  # minimum guard rows so rolls wrap into masked cells


def padded_band_width(width: int) -> int:
    """Band + guard rows, rounded up to a multiple of 8 (width 21 -> 24
    rows, 40 -> 48); the extra rows are permanently invalid.  The engines
    need only the two guard rows; the rounding is kept because it changes
    no result and keeps every compiled shape of the existing bands."""
    return -(-(width + GUARD) // 8) * 8


def path_from_cigar(
    ops: Sequence[Tuple[int, int]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Prefix-coordinate path (d_t, i_t) of an alignment cigar.

    ops are (op, length) with 0=M, 1=I (read-only), 2=D (ref-only), relative
    to the aligned region (no clips).  Returns strictly-increasing d values
    and the corresponding i values, starting at (0, 0).
    """
    if not len(ops):
        return np.zeros(1, np.int64), np.zeros(1, np.int64)
    # Fully vectorised over runs AND bases (a per-run Python loop still
    # cost ~1.4ms/record at realign corpus sizes, e2e profile round 5):
    # each M run emits one (d, i) entry per base, I/D runs one entry at
    # the run end; within-run offsets come from one arange minus the
    # repeated exclusive run starts.
    arr = np.asarray(ops, dtype=np.int64).reshape(-1, 2)
    opv, ln = arr[:, 0], arr[:, 1]
    if opv.size and (opv.min() < 0 or opv.max() > 2):
        raise ValueError(
            "Unexpected op %d in aligned cigar" % int(
                opv[(opv < 0) | (opv > 2)][0])
        )
    i_end = np.cumsum(np.where(opv != 2, ln, 0))
    j_end = np.cumsum(np.where(opv != 1, ln, 0))
    i0 = i_end - np.where(opv != 2, ln, 0)
    j0 = j_end - np.where(opv != 1, ln, 0)
    counts = np.where(opv == 0, ln, 1)
    starts = np.cumsum(counts) - counts
    rep = np.repeat(np.arange(len(opv)), counts)
    t = np.arange(int(counts.sum()), dtype=np.int64) - starts[rep] + 1
    is_m = opv[rep] == 0
    d = np.where(is_m, i0[rep] + j0[rep] + 2 * t, i_end[rep] + j_end[rep])
    iv = np.where(is_m, i0[rep] + t, i_end[rep])
    z = np.zeros(1, np.int64)
    return np.concatenate([z, d]), np.concatenate([z, iv])


def band_offsets(
    m: int,
    n: int,
    width: int,
    path_d: Optional[np.ndarray] = None,
    path_i: Optional[np.ndarray] = None,
) -> np.ndarray:
    """lo(d) for d in [0, m+n]: the band's first i-index per anti-diagonal.

    If no guide path is given, the band follows the main diagonal (global
    alignment of similar-length sequences).  Guarantees lo(0)=0, monotone
    increments in {0, 1}, and that the band contains (0,0) and (m,n).
    """
    D = m + n
    dr = np.arange(D + 1, dtype=np.float64)
    if path_d is None:
        center = dr * (m / max(1, D))
    else:
        center = np.interp(dr, path_d.astype(np.float64), path_i.astype(np.float64))
    lo = np.floor(center).astype(np.int64) - width // 2
    hi_cap = max(0, m + 1 - width)
    lo = np.clip(lo, 0, hi_cap)
    # floor() of a <=1-slope monotone function keeps increments in {0,1}.
    steps = np.diff(lo)
    assert np.all((steps >= 0) & (steps <= 1)), "band offsets must step by 0/1"
    return lo


@dataclass
class BandedBatch:
    """A device-ready batch of banded read/ref pairs.

    Shapes: D1 = max(m+n)+1 over the batch, Wp = width + GUARD, B = batch.
      xb      [D1, Wp, B] int8   ref code at cell (d, k)   (x index j-1)
      yb      [D1, Wp, B] int8   read code at cell (d, k)  (y index i-1)
      valid   [D1, Wp, B] bool   cell inside grid and band
      s1      [D1, B]     int32  lo(d) - lo(d-1)   (0 for padded steps)
      s2      [D1, B]     int32  lo(d) - lo(d-2)
      lo      [D1, B]     int32  band offsets (for unpacking results)
      final_d [B]         int32  d of terminal cell (m, n)
      final_k [B]         int32  band index of terminal cell
      m, n    [B]         int32  sequence lengths
    """

    xb: np.ndarray
    yb: np.ndarray
    valid: np.ndarray
    s1: np.ndarray
    s2: np.ndarray
    lo: np.ndarray
    final_d: np.ndarray
    final_k: np.ndarray
    m: np.ndarray
    n: np.ndarray
    width: int

    @property
    def num_steps(self) -> int:
        return self.xb.shape[0]

    @property
    def batch(self) -> int:
        return self.xb.shape[2]

    @property
    def wp(self) -> int:
        return self.xb.shape[1]

    def dp_cells(self) -> int:
        """Number of in-band DP cells (for throughput accounting)."""
        return int(self.valid.sum())


def quantized_steps(d1: int) -> int:
    """Step count on the ladder pack_banded_batch(quantize=True) pads to:
    powers of two from 128 to 1024, multiples of 1024 beyond."""
    if d1 <= 1024:
        return max(128, 1 << (d1 - 1).bit_length())
    return -(-d1 // 1024) * 1024


def quantized_lanes(b: int) -> int:
    """Lane count pack_banded_batch(quantize=True) pads to: a power of two,
    at least 8."""
    return 1 << max(3, (b - 1).bit_length())


def pack_banded_batch(
    reads: Sequence[np.ndarray],
    refs: Sequence[np.ndarray],
    width: int,
    paths: Optional[Sequence[Optional[Tuple[np.ndarray, np.ndarray]]]] = None,
    pad_batch_to: Optional[int] = None,
    pad_steps_to: Optional[int] = None,
    quantize: bool = False,
) -> BandedBatch:
    """Pack encoded read/ref code arrays into a BandedBatch.

    reads[b], refs[b]: int8 code arrays (A=0..T=3, N=4).  paths[b] is an
    optional (path_d, path_i) guide path in prefix coordinates.  With
    quantize=True, the step count rounds up a geometric ladder (powers of
    two from 128 to 1024, multiples of 1024 beyond) and the lane count to
    a power of two, so repeated calls reuse compiled kernels while
    short-read (tRNA-scale) batches stop paying ~5x step padding.
    """
    B0 = len(reads)
    assert len(refs) == B0
    ms = np.array([len(r) for r in reads], dtype=np.int64)
    ns = np.array([len(r) for r in refs], dtype=np.int64)
    D1 = int((ms + ns).max()) + 1
    if pad_steps_to is not None:
        assert pad_steps_to >= D1
        D1 = pad_steps_to
    elif quantize:
        D1 = quantized_steps(D1)
    B = pad_batch_to if pad_batch_to is not None else B0
    if pad_batch_to is None and quantize:
        B = quantized_lanes(B0)
    assert B >= B0
    Wp = padded_band_width(width)

    xb = np.zeros((D1, Wp, B), dtype=np.int8)
    yb = np.zeros((D1, Wp, B), dtype=np.int8)
    valid = np.zeros((D1, Wp, B), dtype=bool)
    s1 = np.zeros((D1, B), dtype=np.int32)
    s2 = np.zeros((D1, B), dtype=np.int32)
    lo_all = np.zeros((D1, B), dtype=np.int32)
    final_d = np.zeros(B, dtype=np.int32)
    final_k = np.zeros(B, dtype=np.int32)
    m_arr = np.zeros(B, dtype=np.int32)
    n_arr = np.zeros(B, dtype=np.int32)

    ks = np.arange(Wp, dtype=np.int64)[None, :]  # [1, Wp]
    los = []
    for b in range(B0):
        m, n = int(ms[b]), int(ns[b])
        D = m + n
        if paths is not None and paths[b] is not None:
            pd, pi = paths[b]
            lo = band_offsets(m, n, width, pd, pi)
        else:
            lo = band_offsets(m, n, width)
        los.append(lo)
        lo_all[: D + 1, b] = lo
        lo_all[D + 1 :, b] = lo[-1]
        s1[1 : D + 1, b] = np.diff(lo)
        s2[2 : D + 1, b] = lo[2:] - lo[:-2]
        final_d[b] = D
        final_k[b] = m - lo[-1]
        m_arr[b] = m
        n_arr[b] = n

    from .. import native as _native

    if not _native.pack_band_batch(reads, refs, lo_all, width, xb, yb, valid):
        for b, lo in enumerate(los):
            m, n = int(ms[b]), int(ns[b])
            D = m + n
            dcol = np.arange(D + 1, dtype=np.int64)[:, None]  # [D+1, 1]
            i_idx = lo[:, None] + ks  # [D+1, Wp]
            j_idx = dcol - i_idx
            ok = (
                (ks < width)
                & (i_idx >= 0)
                & (i_idx <= m)
                & (i_idx <= dcol)
                & (j_idx >= 0)
                & (j_idx <= n)
            )
            # Emission symbol indices (invalid cells are masked anyway).
            y_sym = np.clip(i_idx - 1, 0, max(0, m - 1))
            x_sym = np.clip(j_idx - 1, 0, max(0, n - 1))
            yb[: D + 1, :, b] = reads[b][y_sym] if m > 0 else 4
            xb[: D + 1, :, b] = refs[b][x_sym] if n > 0 else 4
            valid[: D + 1, :, b] = ok

    return BandedBatch(
        xb=xb, yb=yb, valid=valid, s1=s1, s2=s2, lo=lo_all,
        final_d=final_d, final_k=final_k, m=m_arr, n=n_arr, width=width,
    )


def encode_reads(seqs: Sequence[str]) -> List[np.ndarray]:
    return [encode(s) for s in seqs]


def bucket_by_cells(
    sizes: Sequence[int], width: int, max_batch_cells: int
) -> List[List[int]]:
    """Group problem indices into batches bounded by padded DP volume, after
    sorting by size so padding waste stays low.  sizes[i] = m + n + 1 (the
    problem's diagonal count).  A batch's volume is counted as
    pack_banded_batch(quantize=True) pads it: quantized steps x quantized
    lanes x width, so no packed batch of two or more problems exceeds
    max_batch_cells."""
    order = sorted(range(len(sizes)), key=lambda idx: sizes[idx])
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_max_d = 0
    for idx in order:
        new_max = max(cur_max_d, sizes[idx])
        if cur and (quantized_steps(new_max) * quantized_lanes(len(cur) + 1)
                    * width > max_batch_cells):
            buckets.append(cur)
            cur = []
            new_max = sizes[idx]
        cur.append(idx)
        cur_max_d = new_max
    if cur:
        buckets.append(cur)
    return buckets


def unpack_band(
    values: np.ndarray, batch: BandedBatch, b: int, fill: float = 0.0
) -> np.ndarray:
    """Scatter per-cell band values [D1, Wp] for read b into a dense
    pair-coordinate matrix [m, n] (cell (d,k) = prefix (i,j) -> pair
    (i-1, j-1)).  Host-side; used for decoding and tests."""
    m, n = int(batch.m[b]), int(batch.n[b])
    out = np.full((m, n), fill, dtype=values.dtype)
    D = m + n
    ks = np.arange(batch.wp)
    for d in range(1, D + 1):
        lo = int(batch.lo[d, b])
        i = lo + ks
        j = d - i
        ok = batch.valid[d, :, b] & (i >= 1) & (j >= 1) & (i <= m) & (j <= n)
        out[i[ok] - 1, j[ok] - 1] = values[d, ok]
    return out
