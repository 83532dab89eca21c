"""Device-side banded tracebacks (NW + MEA) as diagonal-lockstep scans.

Every lane walks in lockstep over diagonals d = D1-1 .. 1, its band row
selected by a one-hot over Wp, and emits one 2-bit MOVE per (diagonal,
lane).  Only that [ceil(D1/4), B] packed move stream crosses to the host.
On an H100 (400 W limit) at 1024 reads x 3.5 kb this measured faster than
pulling the uint8 pointer band into a native host traceback, for both the
guide (width 40) and MEA (width 21) pointers; CHANGES.md has the times.

Move codes: 0 = M (diag, i-1 j-1), 1 = I (read consumed, i-1),
2 = D (ref consumed, j-1), 3 = no move at this diagonal.  The walk makes
at most one move per diagonal (an M move skips d-1 entirely), so reading
a lane's column in ASCENDING d is exactly the host traceback's reversed
op list; `ops_from_moves` run-length encodes it in vectorised numpy.

Semantics are those of a plain sequential traceback from (m, n) to (0, 0)
(the parity contract for cPecanRealign's cigar recovery, reference
marginAlignLib.py:299-318); tests/test_traceback_device.py pins exact
equality per lane against such a reference.
"""
from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NO_MOVE = 3


@jax.jit
def nw_moves_device(ptrs, lo, m, n, final_state):
    """Banded affine-gap NW traceback on device.

    ptrs [D1, Wp, B] uint8 (ops/nw.py packed bits: ptrM | ptrIx<<2 |
    ptrIy<<3), lo [D1, B] int32 band offsets, m/n/final_state [B].
    Returns moves [D1-1, B] int8; moves[d-1, b] = move made at diagonal d.
    """
    D1, Wp, B = ptrs.shape
    iota_w = jax.lax.broadcasted_iota(jnp.int32, (Wp, B), 0)

    def step(carry, xs):
        i, j, state = carry
        ptr_row, lo_d, d = xs
        active = (i + j == d) & ((i > 0) | (j > 0))
        k = i - lo_d.astype(jnp.int32)
        oh = (iota_w == k[None, :]) & active[None, :]
        p = jnp.sum(
            jnp.where(oh, ptr_row.astype(jnp.int32), 0), axis=0
        )
        # Degenerate edge (host traceback's `continue` branch): state M
        # on the i==0 / j==0 edge re-reads the SAME cell as a gap state.
        st = jnp.where(
            (state == 0) & (i == 0), 1,
            jnp.where((state == 0) & (j == 0), 2, state),
        )
        is_m = st == 0
        is_ix = st == 1  # ref consumed (op 2 = D)
        op = jnp.where(is_m, 0, jnp.where(is_ix, 2, 1))
        di = jnp.where(is_ix, 0, 1)
        dj = jnp.where(is_m | is_ix, 1, 0)
        ns = jnp.where(
            is_m, p & 3,
            jnp.where(
                is_ix,
                jnp.where(((p >> 2) & 1) == 0, 0, 1),
                jnp.where(((p >> 3) & 1) == 0, 0, 2),
            ),
        )
        i2 = jnp.where(active, i - di, i)
        j2 = jnp.where(active, j - dj, j)
        state2 = jnp.where(active, ns, state)
        mv = jnp.where(active, op, NO_MOVE).astype(jnp.int8)
        return (i2, j2, state2), mv

    xs = (ptrs[1:], lo[1:], jnp.arange(1, D1, dtype=jnp.int32))
    carry0 = (
        m.astype(jnp.int32), n.astype(jnp.int32),
        final_state.astype(jnp.int32),
    )
    _, mvs = jax.lax.scan(step, carry0, xs, reverse=True)
    return mvs


@jax.jit
def mea_moves_device(ptrs, lo, m, n):
    """Banded MEA traceback on device: ptr 0 = diag, 1 = left/D, anything
    else = up/I (consumes the read only); i==0 forces D, j==0 forces I
    without reading the band."""
    D1, Wp, B = ptrs.shape
    iota_w = jax.lax.broadcasted_iota(jnp.int32, (Wp, B), 0)

    def step(carry, xs):
        i, j = carry
        ptr_row, lo_d, d = xs
        active = (i + j == d) & ((i > 0) | (j > 0))
        k = i - lo_d.astype(jnp.int32)
        oh = (iota_w == k[None, :]) & active[None, :]
        p = jnp.sum(
            jnp.where(oh, ptr_row.astype(jnp.int32), 0), axis=0
        )
        pe = jnp.where(i == 0, 1, jnp.where(j == 0, 2, p))
        op = jnp.where(pe == 0, 0, jnp.where(pe == 1, 2, 1))
        di = jnp.where(pe == 1, 0, 1)
        dj = jnp.where(pe <= 1, 1, 0)
        i2 = jnp.where(active, i - di, i)
        j2 = jnp.where(active, j - dj, j)
        mv = jnp.where(active, op, NO_MOVE).astype(jnp.int8)
        return (i2, j2), mv

    xs = (ptrs[1:], lo[1:], jnp.arange(1, D1, dtype=jnp.int32))
    carry0 = (m.astype(jnp.int32), n.astype(jnp.int32))
    _, mvs = jax.lax.scan(step, carry0, xs, reverse=True)
    return mvs


@jax.jit
def pack_moves(mvs):
    """[T, B] 2-bit moves -> [ceil(T/4), B] uint8 (4 moves/byte, move t
    in bits 2*(t%4); padding packs NO_MOVE)."""
    T, B = mvs.shape
    Tp = -(-T // 4) * 4
    if Tp != T:
        mvs = jnp.pad(
            mvs, ((0, Tp - T), (0, 0)), constant_values=NO_MOVE
        )
    m4 = mvs.reshape(Tp // 4, 4, B).astype(jnp.uint8)
    return m4[:, 0] | (m4[:, 1] << 2) | (m4[:, 2] << 4) | (m4[:, 3] << 6)


def unpack_moves(packed: np.ndarray, T: int) -> np.ndarray:
    """Inverse of pack_moves on host numpy: [P, B] uint8 -> [T, B] uint8."""
    P, B = packed.shape
    out = np.empty((P, 4, B), np.uint8)
    for s in range(4):
        out[:, s, :] = (packed >> (2 * s)) & 3
    return out.reshape(P * 4, B)[:T]


def ops_from_moves(moves: np.ndarray, b: int) -> List[Tuple[int, int]]:
    """Run-length encode lane b's move column (ascending d == the
    traceback's final op order) into aligned ops [(op, len)]."""
    col = moves[:, b]
    sel = col[col != NO_MOVE]
    if sel.size == 0:
        return []
    cuts = np.nonzero(np.diff(sel))[0]
    starts = np.concatenate([[0], cuts + 1])
    ends = np.concatenate([cuts + 1, [sel.size]])
    return [
        (int(sel[s]), int(e - s)) for s, e in zip(starts, ends)
    ]


def pull_ops(moves_dev, num_steps: int, lanes: int) -> List[List[Tuple[int, int]]]:
    """Pull a packed move stream (pack_moves output) to the host and
    decode the first `lanes` lanes into aligned ops."""
    moves = unpack_moves(np.asarray(moves_dev), num_steps - 1)
    return [ops_from_moves(moves, b) for b in range(lanes)]
