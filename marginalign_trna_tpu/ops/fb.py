"""Banded pair-HMM forward-backward in plain JAX (the XLA scan engine).

This replaces the compute core of cPecanRealign (reference: invoked per read
via subprocess at src/margin/marginAlignLib.py:315 and
src/margin/marginCallerLib.py:49-57).  Instead of one C process per read, a
whole batch of banded read/reference DP matrices advances together, one
anti-diagonal per scan step:

  - arrays are [Wp, B] (band window rows, reads last);
  - band motion (0/1 per step, per read) is expressed as selects between
    rolled arrays, so there are no gathers on the hot path;
  - arithmetic is scaled linear-space float32 with one rescale per step
    (the classic pair-HMM scaling trick; no transcendentals per cell);
  - the backward scan fuses posterior-match emission and Baum-Welch
    expected-count accumulation, so EM needs no extra passes.

It is the forward-backward engine on every platform (ops/dispatch.py).

State layout and model semantics are in models/hmm.py.  Grid is in prefix
coordinates (see ops/band.py).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.hmm import PairHmm
from .band import BandedBatch

_TINY = 1e-30


class FbTables(NamedTuple):
    """Device-resident model tables."""

    T: jnp.ndarray       # [5, 5] transitions (from, to)
    Ematch: jnp.ndarray  # [5, 5] match emissions over codes (ref, read)
    Egap: jnp.ndarray    # [5, 5] per-state single-base gap emissions
    pi: jnp.ndarray      # [5] start distribution


def make_tables(hmm: PairHmm, dtype=jnp.float32) -> FbTables:
    return FbTables(
        T=jnp.asarray(hmm.transitions, dtype),
        Ematch=jnp.asarray(hmm.match_emissions_5x5(), dtype),
        Egap=jnp.asarray(hmm.gap_emissions_5(), dtype),
        pi=jnp.full((5,), 0.2, dtype),
    )


class DeviceBatch(NamedTuple):
    """BandedBatch fields as device arrays (see ops/band.py for shapes)."""

    xb: jnp.ndarray
    yb: jnp.ndarray
    valid: jnp.ndarray
    s1: jnp.ndarray
    s2: jnp.ndarray
    final_d: jnp.ndarray
    final_k: jnp.ndarray


def device_batch(batch: BandedBatch, device=None) -> DeviceBatch:
    """The batch's band arrays on `device` (committed to it), or on the
    default device when None."""
    return jax.device_put(DeviceBatch(
        xb=batch.xb, yb=batch.yb, valid=batch.valid, s1=batch.s1,
        s2=batch.s2, final_d=batch.final_d, final_k=batch.final_k,
    ), device)


# --------------------------------------------------------------------- helpers


def _shift(a: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """out[k] = a[k + t] per lane, t in {-1, 0, 1}; t is [B], a is [..., Wp, B].

    Wrapped rows land in the guard band and are masked by `valid`.
    """
    t = jnp.expand_dims(t, axis=-2)  # broadcast over the band dimension
    up = jnp.roll(a, -1, axis=-2)    # out[k] = a[k+1]
    down = jnp.roll(a, 1, axis=-2)   # out[k] = a[k-1]
    return jnp.where(t == 1, up, jnp.where(t == 0, a, down))


def _onehot(codes: jnp.ndarray, dtype) -> jnp.ndarray:
    """[Wp, B] int8 -> [5, Wp, B] one-hot."""
    return (codes[None, :, :] == jnp.arange(5, dtype=codes.dtype)[:, None, None]).astype(dtype)


def _emissions(tables: FbTables, xb_d, yb_d):
    """Per-cell emission factors for one anti-diagonal.

    Returns e_match [Wp, B] and e_gap [5, Wp, B] (rows 1..4 meaningful).
    """
    ex = _onehot(xb_d, tables.Ematch.dtype)  # [5, Wp, B] over ref codes
    ey = _onehot(yb_d, tables.Ematch.dtype)  # [5, Wp, B] over read codes
    # e_match[k,b] = sum_{a,c} ex[a] * Ematch[a,c] * ey[c]
    e_match = jnp.einsum("awb,ac,cwb->wb", ex, tables.Ematch, ey, precision="highest")
    # Gap states: X states (1,3) emit the ref base, Y states (2,4) the read.
    e_gx = jnp.einsum("sa,awb->swb", tables.Egap, ex, precision="highest")  # [5, Wp, B]
    e_gy = jnp.einsum("sa,awb->swb", tables.Egap, ey, precision="highest")
    is_y = jnp.array([0.0, 0.0, 1.0, 0.0, 1.0], tables.Egap.dtype)[:, None, None]
    e_gap = e_gx * (1.0 - is_y) + e_gy * is_y
    return e_match, e_gap


# --------------------------------------------------------------------- forward


def _forward(tables: FbTables, batch: DeviceBatch, save_all_states: bool):
    """Scaled forward pass: (F_all [D1, S, Wp, B], lsf [D1, B] cumulative
    log scale, lc [D1, B] per-step log scale, logZ [B], log_term [B] =
    logZ - lsf[final_d] kept apart so the backward never subtracts two
    ~|logZ|-sized numbers)."""
    D1, Wp, B = batch.xb.shape
    dtype = tables.T.dtype

    f0 = jnp.zeros((5, Wp, B), dtype)
    f0 = f0.at[:, 0, :].set(tables.pi[:, None])

    def step(carry, xs):
        f1, f2, c_prev, ls = carry
        xb_d, yb_d, valid_d, s1_d, s2_d = xs
        e_match, e_gap = _emissions(tables, xb_d, yb_d)

        # Mix states into each target before shifting.  f1 and f2 carry
        # different cumulative scales (lsf[d-1] vs lsf[d-2]); dividing the
        # d-2 term by the previous step's scale factor c_prev brings both
        # onto the lsf[d-1] scale.
        mix_m = jnp.einsum("s,swb->wb", tables.T[:, 0], f2, precision="highest") / c_prev[None, :]
        mix_g = jnp.einsum("st,swb->twb", tables.T, f1, precision="highest")  # rows 1..4 used

        vm = valid_d.astype(dtype)
        new_m = e_match * _shift(mix_m, s2_d - 1)
        gx = e_gap * _shift(mix_g, s1_d)
        gy = e_gap * _shift(mix_g, s1_d - 1)
        sel_y = jnp.array([0, 0, 1, 0, 1], jnp.int32)[:, None, None]
        new_g = jnp.where(sel_y == 1, gy, gx)
        f_new = jnp.concatenate([new_m[None], new_g[1:]], axis=0) * vm[None]

        # Scale by the step max; steps with no mass (before the first cell
        # or after a lane's terminal diagonal) use 1 so they leave the
        # cumulative log-scale untouched.
        fmax = jnp.max(f_new, axis=(0, 1))  # [B]
        c = jnp.where(fmax > 0, fmax, 1.0)
        f_new = f_new / c
        lc = jnp.log(c)
        ls = ls + lc
        out = f_new if save_all_states else f_new[:1]
        return (f_new, f1, c, ls), (out, ls, lc)

    xs = (
        batch.xb[1:], batch.yb[1:], batch.valid[1:],
        batch.s1[1:], batch.s2[1:],
    )
    ls0 = jnp.zeros((B,), dtype)
    c0 = jnp.ones((B,), dtype)
    (_, _, _, _), (fs, lss, lcs) = jax.lax.scan(
        step, (f0, jnp.zeros_like(f0), c0, ls0), xs
    )

    F_all = jnp.concatenate(
        [(f0 if save_all_states else f0[:1])[None], fs], axis=0
    )
    lsf = jnp.concatenate([ls0[None], lss], axis=0)
    lc = jnp.concatenate([ls0[None], lcs], axis=0)

    # logZ: sum of states at the terminal cell (m, n), plus its scale.
    d_idx = batch.final_d.astype(jnp.int32)
    k_idx = batch.final_k.astype(jnp.int32)
    b_idx = jnp.arange(B)
    f_term = F_all[d_idx, :, k_idx, b_idx]  # [B, S]
    log_term = jnp.log(jnp.maximum(jnp.sum(f_term, axis=-1), _TINY))
    logZ = log_term + lsf[d_idx, b_idx]
    return F_all, lsf, lc, logZ, log_term


@partial(jax.jit, static_argnames=("save_all_states",))
def forward(
    tables: FbTables, batch: DeviceBatch, save_all_states: bool = True
):
    """Scaled forward pass.

    Returns (F_all, lsf, logZ):
      F_all [D1, S, Wp, B]  scaled forward values (S=5, or 1 = match only)
      lsf   [D1, B]         cumulative log scale factor per step
      logZ  [B]             log likelihood of each pair
    """
    F_all, lsf, _, logZ, _ = _forward(tables, batch, save_all_states)
    return F_all, lsf, logZ


# ------------------------------------------------------------------- backward


class FbResult(NamedTuple):
    logZ: jnp.ndarray                     # [B]
    posteriors: Optional[jnp.ndarray]     # [D1, Wp, B] match posteriors or None
    trans_counts: Optional[jnp.ndarray]   # [5, 5] expected transition counts
    emit_match: Optional[jnp.ndarray]     # [5, 5] (ref code, read code)
    emit_gap: Optional[jnp.ndarray]       # [5, 5] (state, code)


def _padded(a: jnp.ndarray, offset: int) -> jnp.ndarray:
    """a[d + offset] along axis 0, zero-padded past the end."""
    pad = [(0, offset)] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a, pad)[offset : offset + a.shape[0]]


@partial(jax.jit, static_argnames=("want_posteriors", "want_counts"))
def forward_backward(
    tables: FbTables,
    batch: DeviceBatch,
    want_posteriors: bool = True,
    want_counts: bool = False,
) -> FbResult:
    """Full forward-backward.  Posterior match probabilities are what the
    realigner (AMAP/MEA) and the caller consume; expected counts are the
    Baum-Welch E-step (reference behaviours: cPecanRealign posteriors and
    cPecanEm expectations, SURVEY.md §2.2)."""
    D1, Wp, B = batch.xb.shape
    dtype = tables.T.dtype
    F_all, _, lc, logZ, log_term = _forward(tables, batch, True)

    kr = jnp.arange(Wp, dtype=jnp.int32)[:, None]  # [Wp, 1]

    # Posterior scale without cumulative sums: gamma at d is
    # F[d] * B[d] * exp(lsf[d] + bls[d] - logZ), and that exponent equals
    # R[d+1] + log cb[d] - log_term with R[d] = sum_{t >= d} (log cb[t] -
    # log cf[t]) (forward steps past a lane's terminal diagonal have
    # scale 1).  R stays O(1) where lsf and bls grow to |logZ|, so f32
    # keeps the posteriors' relative precision at any read length.
    def step(carry, xs):
        b1, b2, c_prev, r1, tc, em, eg = carry
        (f_d, lc_d, valid_d, xb_d, yb_d, xb1, yb1, xb2, yb2,
         s1n, s2n, d_val) = xs

        e_match2, _ = _emissions(tables, xb2, yb2)
        _, e_gap1 = _emissions(tables, xb1, yb1)

        # Successor terms aligned back onto this diagonal's band window.
        # b2 carries scale bls[d+2]; dividing by c_prev (the scale factor
        # applied at step d+1) brings it onto b1's bls[d+1] scale.
        q_m = _shift(e_match2 * b2[0], 1 - s2n) / c_prev[None, :]     # [Wp,B]
        qg = e_gap1 * b1                                              # [5,Wp,B]
        sel_y = jnp.array([0, 0, 1, 0, 1], jnp.int32)[:, None, None]
        q_g = jnp.where(
            sel_y == 1, _shift(qg, 1 - s1n), _shift(qg, -s1n)
        )
        q = jnp.concatenate([q_m[None], q_g[1:]], axis=0)             # [5,Wp,B]

        b_new = jnp.einsum("st,twb->swb", tables.T, q, precision="highest")
        inj = ((kr == batch.final_k[None, :]) & (d_val == batch.final_d)[None, :])
        b_new = (b_new + inj.astype(dtype)[None]) * valid_d.astype(dtype)[None]

        bmax = jnp.max(b_new, axis=(0, 1))
        c = jnp.where(bmax > 0, bmax, 1.0)
        b_new = b_new / c
        lcb = jnp.log(c)
        r0 = r1 + (lcb - lc_d)

        if want_posteriors or want_counts:
            alpha0 = jnp.exp(r1 + lcb - log_term)  # [B] scale for gamma at d
            gamma = f_d * b_new * alpha0[None, None, :]  # [5, Wp, B]
            post_out = gamma[0] if want_posteriors else jnp.zeros((0,), dtype)
        else:
            post_out = jnp.zeros((0,), dtype)

        if want_counts:
            # Transition counts: F[s][d] * T[s,s'] * (e * B)[s'][succ].
            # All rows of q are on the bls[d+1] scale after the c_prev fix.
            alpha1 = jnp.exp(r1 - log_term)
            g = jnp.einsum("swb,twb->st", f_d, q * alpha1[None, None, :], precision="highest")
            tc = tc + tables.T * g
            # Emission counts from state occupancies gamma: the match state
            # emits (x_{j-1}, y_{i-1}) = this diagonal's (xb, yb) codes.
            # The boundary cell (0,0) at d=0 holds the start distribution and
            # emits nothing, so it is excluded.
            ex = _onehot(xb_d, dtype)
            ey = _onehot(yb_d, dtype)
            g_emit = gamma * jnp.where(d_val == 0, 0.0, 1.0).astype(dtype)
            em = em + jnp.einsum("wb,awb,cwb->ac", g_emit[0], ex, ey, precision="highest")
            gx_occ = jnp.einsum("swb,awb->sa", g_emit, ex, precision="highest")
            gy_occ = jnp.einsum("swb,awb->sa", g_emit, ey, precision="highest")
            is_y = jnp.array([0.0, 0, 1, 0, 1], dtype)[:, None]
            is_gap = jnp.array([0.0, 1, 1, 1, 1], dtype)[:, None]
            eg = eg + (gx_occ * (1 - is_y) + gy_occ * is_y) * is_gap

        return (b_new, b1, c, r0, tc, em, eg), post_out

    # Per-step inputs, indexed at d, d+1 and d+2 (zero-padded past the end).
    xs = (
        F_all,
        lc,
        batch.valid,
        batch.xb, batch.yb,
        _padded(batch.xb, 1), _padded(batch.yb, 1),
        _padded(batch.xb, 2), _padded(batch.yb, 2),
        _padded(batch.s1, 1),
        _padded(batch.s2, 2),
        jnp.arange(D1, dtype=jnp.int32),
    )
    zero_b = jnp.zeros((5, Wp, B), dtype)
    zeros5 = jnp.zeros((5, 5), dtype)
    carry0 = (zero_b, zero_b, jnp.ones((B,), dtype), jnp.zeros((B,), dtype),
              zeros5, zeros5, zeros5)
    (_, _, _, _, tc, em, eg), posts = jax.lax.scan(
        step, carry0, xs, reverse=True
    )
    return FbResult(
        logZ=logZ,
        posteriors=posts if want_posteriors else None,
        trans_counts=tc if want_counts else None,
        emit_match=em if want_counts else None,
        emit_gap=eg if want_counts else None,
    )
