"""Unbanded log-space forward-backward in numpy: the correctness oracle.

Same model semantics as ops/fb.py (prefix coordinates, start distribution pi
at cell (0,0), unit end weights at (m,n)) computed over the full DP matrix in
log space.  Used only by tests to validate the banded device engines;
never on a hot path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..models.hmm import GAP_Y_STATES, PairHmm

NEG = -1e30


def _lse(a, axis=None):
    m = np.max(a, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    out = np.log(np.sum(np.exp(a - m), axis=axis, keepdims=True)) + m
    if axis is not None:
        out = np.squeeze(out, axis=axis)
    else:
        out = out.reshape(()).item()
    return out


class OracleResult(NamedTuple):
    logZ: float
    post_match: np.ndarray    # [m, n] posterior over aligned pairs (i0, j0)
    trans_counts: np.ndarray  # [5, 5]
    emit_match: np.ndarray    # [5, 5] over codes
    emit_gap: np.ndarray      # [5, 5] state x code


def forward_backward_full(hmm: PairHmm, x: np.ndarray, y: np.ndarray) -> OracleResult:
    """x = encoded reference codes [n], y = encoded read codes [m]."""
    m, n = len(y), len(x)
    logT = np.log(np.maximum(hmm.transitions, 1e-300))
    logEm = np.log(np.maximum(hmm.match_emissions_5x5(), 1e-300))
    logEg = np.log(np.maximum(hmm.gap_emissions_5(), 1e-300))
    logpi = np.log(np.full(5, 0.2))

    F = np.full((m + 1, n + 1, 5), NEG)
    F[0, 0] = logpi
    for i in range(m + 1):
        for j in range(n + 1):
            if i == 0 and j == 0:
                continue
            v = np.full(5, NEG)
            if i >= 1 and j >= 1:
                v[0] = _lse(F[i - 1, j - 1] + logT[:, 0]) + logEm[x[j - 1], y[i - 1]]
            for s in (1, 3):  # gap X: ref advances
                if j >= 1:
                    v[s] = _lse(F[i, j - 1] + logT[:, s]) + logEg[s, x[j - 1]]
            for s in GAP_Y_STATES:  # gap Y: read advances
                if i >= 1:
                    v[s] = _lse(F[i - 1, j] + logT[:, s]) + logEg[s, y[i - 1]]
            F[i, j] = v
    logZ = _lse(F[m, n])

    Bk = np.full((m + 1, n + 1, 5), NEG)
    Bk[m, n] = 0.0
    for i in range(m, -1, -1):
        for j in range(n, -1, -1):
            if i == m and j == n:
                continue
            terms = np.full((5, 5), NEG)  # [from s, to s']
            if i + 1 <= m and j + 1 <= n:
                terms[:, 0] = logT[:, 0] + logEm[x[j], y[i]] + Bk[i + 1, j + 1, 0]
            for s in (1, 3):
                if j + 1 <= n:
                    terms[:, s] = logT[:, s] + logEg[s, x[j]] + Bk[i, j + 1, s]
            for s in GAP_Y_STATES:
                if i + 1 <= m:
                    terms[:, s] = logT[:, s] + logEg[s, y[i]] + Bk[i + 1, j, s]
            Bk[i, j] = _lse(terms, axis=1)

    # Posterior match probabilities over pairs (read i0, ref j0).
    post = np.zeros((m, n))
    for i0 in range(m):
        for j0 in range(n):
            post[i0, j0] = np.exp(
                F[i0 + 1, j0 + 1, 0] + Bk[i0 + 1, j0 + 1, 0] - logZ
            )

    # Expected counts.
    tc = np.zeros((5, 5))
    em = np.zeros((5, 5))
    eg = np.zeros((5, 5))
    for i in range(m + 1):
        for j in range(n + 1):
            gamma = np.exp(F[i, j] + Bk[i, j] - logZ)
            if i >= 1 and j >= 1:
                em[x[j - 1], y[i - 1]] += gamma[0]
            for s in (1, 3):
                if j >= 1:
                    eg[s, x[j - 1]] += gamma[s]
            for s in GAP_Y_STATES:
                if i >= 1:
                    eg[s, y[i - 1]] += gamma[s]
            for s in range(5):
                if i + 1 <= m and j + 1 <= n:
                    tc[s, 0] += np.exp(
                        F[i, j, s] + logT[s, 0] + logEm[x[j], y[i]]
                        + Bk[i + 1, j + 1, 0] - logZ
                    )
                for s2 in (1, 3):
                    if j + 1 <= n:
                        tc[s, s2] += np.exp(
                            F[i, j, s] + logT[s, s2] + logEg[s2, x[j]]
                            + Bk[i, j + 1, s2] - logZ
                        )
                for s2 in GAP_Y_STATES:
                    if i + 1 <= m:
                        tc[s, s2] += np.exp(
                            F[i, j, s] + logT[s, s2] + logEg[s2, y[i]]
                            + Bk[i + 1, j, s2] - logZ
                        )
    return OracleResult(logZ, post, tc, em, eg)
