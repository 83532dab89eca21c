"""Banded affine-gap Viterbi alignment (guide alignment kernel).

Device replacement for the seed-and-extend guide mappers the reference
shells out to (LAST/BWA/minimap2; src/margin/mappers/*.py): after host-side
k-mer seeding and chaining picks a corridor, this kernel produces a
base-level alignment of the read against a reference window with a banded
3-state (match / ref-gap / read-gap) max-plus wavefront, batched over reads.

Pointers are emitted per cell ([D1, Wp, B] uint8); the traceback walks them
on device (ops/traceback_device.py) and only a 2-bit move stream comes back
to the host.  Same band machinery as ops/fb.py.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .fb import DeviceBatch, _shift

NEG = -1e30

# State indices.
S_M, S_IX, S_IY = 0, 1, 2  # match, gap-in-read (ref advances), gap-in-ref


class NwParams(NamedTuple):
    match: float = 1.0
    mismatch: float = -2.0
    gap_open: float = -3.0
    gap_extend: float = -1.0


class NwResult(NamedTuple):
    pointers: jnp.ndarray  # [D1, Wp, B] uint8 packed (ptrM | ptrIx<<2 | ptrIy<<3)
    score: jnp.ndarray     # [B] best score at (m, n)
    final_state: jnp.ndarray  # [B] argmax state at (m, n)


@partial(jax.jit, static_argnames=())
def banded_nw(params_arr: jnp.ndarray, batch: DeviceBatch) -> NwResult:
    """params_arr = [match, mismatch, gap_open, gap_extend] as f32."""
    D1, Wp, B = batch.xb.shape
    dtype = jnp.float32
    match, mismatch, gap_open, gap_extend = (
        params_arr[0], params_arr[1], params_arr[2], params_arr[3]
    )

    neg = jnp.full((Wp, B), NEG, dtype)
    m0 = neg.at[0, :].set(0.0)  # cell (0,0)
    f0 = jnp.stack([m0, neg, neg])  # [3, Wp, B]

    # Terminal-cell selector: a masked reduction against this constant
    # mask picks each lane's terminal band row every step.
    term_sel = (
        jnp.arange(Wp, dtype=jnp.int32)[:, None]
        == batch.final_k.astype(jnp.int32)[None, :]
    ).astype(dtype)  # [Wp, B]

    def step(carry, xs):
        f1, f2, delta_prev, cum = carry
        xb_d, yb_d, valid_d, s1_d, s2_d = xs

        sub = jnp.where(
            (xb_d == yb_d) & (xb_d < 4), match,
            jnp.where((xb_d >= 4) | (yb_d >= 4), 0.0, mismatch),
        ).astype(dtype)

        # Match: best of all states at (i-1, j-1).  f2 has not had the
        # previous step's normalisation applied; subtract it to put the
        # d-2 values on f1's scale.
        diag = _shift(f2, s2_d - 1) - delta_prev[None, None, :]  # [3, Wp, B]
        m_val = jnp.max(diag, axis=0) + sub
        m_ptr = jnp.argmax(diag, axis=0).astype(jnp.uint8)

        # Ix (ref advances, read gap): from (i, j-1), states M or Ix.
        horiz = _shift(f1, s1_d)
        ix_open = horiz[S_M] + gap_open
        ix_ext = horiz[S_IX] + gap_extend
        ix_val = jnp.maximum(ix_open, ix_ext)
        ix_ptr = (ix_ext > ix_open).astype(jnp.uint8)  # 0 = from M, 1 = stay

        # Iy (read advances, ref gap): from (i-1, j), states M or Iy.
        vert = _shift(f1, s1_d - 1)
        iy_open = vert[S_M] + gap_open
        iy_ext = vert[S_IY] + gap_extend
        iy_val = jnp.maximum(iy_open, iy_ext)
        iy_ptr = (iy_ext > iy_open).astype(jnp.uint8)

        vm = valid_d
        f_new = jnp.stack([m_val, ix_val, iy_val])
        f_new = jnp.where(vm[None], f_new, NEG)
        # Keep magnitudes bounded (scores are relative; subtract running max).
        delta = jnp.maximum(jnp.max(f_new, axis=(0, 1)), 0.0)  # [B]
        f_new = jnp.where(f_new <= NEG / 2, NEG, f_new - delta)

        ptr = (m_ptr | (ix_ptr << 2) | (iy_ptr << 3))
        # Snapshot this step's value at each lane's terminal band index, so
        # lanes that finish before the last step keep their terminal state.
        # The cumulative normalisation is added back for an absolute score.
        cum = cum + delta
        masked = jnp.where(term_sel[None] > 0, f_new, NEG)
        term = jnp.max(masked, axis=1) + cum[None, :]  # [3, B]
        return (f_new, f1, delta, cum), (ptr, term)

    xs = (
        batch.xb[1:], batch.yb[1:], batch.valid[1:],
        batch.s1[1:], batch.s2[1:],
    )
    zb = jnp.zeros((B,), dtype)
    carry0 = (f0, jnp.full_like(f0, NEG), zb, zb)
    _, (ptrs, terms) = jax.lax.scan(step, carry0, xs)

    ptrs = jnp.concatenate(
        [jnp.zeros((1, Wp, B), jnp.uint8), ptrs], axis=0
    )
    # terms[t] holds values at step d = t + 1; pick each lane's final_d.
    b_idx = jnp.arange(B)
    t_idx = jnp.maximum(batch.final_d.astype(jnp.int32) - 1, 0)
    term_final = terms[t_idx, :, b_idx]  # [B, 3]
    return NwResult(
        pointers=ptrs,
        score=jnp.max(term_final, axis=-1),
        final_state=jnp.argmax(term_final, axis=-1),
    )
