"""MEA decode on device vs the host gap-weight oracle and a sequential
traceback."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from marginalign_trna_tpu.ops.band import pack_banded_batch, path_from_cigar
from marginalign_trna_tpu.ops.mea import (
    NEG, banded_mea, canonical_weights, mea_decode, mea_weights,
    mea_weights_device, snap,
)
from tb_reference import mea_traceback


def _batch(rng, with_path=True):
    reads = [rng.integers(0, 4, size=m).astype(np.int8) for m in (9, 17, 30)]
    refs = [rng.integers(0, 4, size=n).astype(np.int8) for n in (12, 15, 28)]
    # One read is a mutated copy of its ref so real alignments exist.
    refs[2] = reads[2][:28].copy()
    refs[2][5] = (refs[2][5] + 1) % 4
    paths = None
    if with_path:
        paths = [None, None, path_from_cigar([(0, 10), (1, 2), (0, 18)])]
    return pack_banded_batch(reads, refs, width=9, paths=paths,
                             pad_batch_to=4)


def test_mea_weights_device_matches_host(rng):
    batch = _batch(rng)
    D1, Wp, B = batch.xb.shape
    post = (rng.random((D1, Wp, B)).astype(np.float32) * batch.valid)
    wup_h, wleft_h = mea_weights(post, batch, gap_gamma=0.5)
    wup_d, wleft_d = mea_weights_device(post, batch, gap_gamma=0.5)
    assert np.allclose(np.asarray(wup_d), wup_h, rtol=1e-5, atol=1e-5)
    assert np.allclose(np.asarray(wleft_d), wleft_h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gap_gamma,match_gamma", [(0.5, 0.0), (0.2, 0.1)])
def test_mea_decode_device_path_matches_host_path(rng, gap_gamma,
                                                  match_gamma):
    """mea_decode (device weights, DP and traceback) gives the cigars of
    the host weights + the same DP + a sequential traceback."""
    batch = _batch(rng)
    D1, Wp, B = batch.xb.shape
    post = (rng.random((D1, Wp, B)).astype(np.float32) * batch.valid)
    wup, wleft = mea_weights(post, batch, gap_gamma)
    wdiag = np.where((post >= match_gamma) & (post > 0), post,
                     NEG).astype(np.float32)
    res = banded_mea(
        *canonical_weights(jnp.asarray(wdiag), jnp.asarray(wup),
                           jnp.asarray(wleft), batch.lo),
        jnp.asarray(batch.valid), jnp.asarray(batch.s1),
        jnp.asarray(batch.s2), jnp.asarray(batch.final_d),
        jnp.asarray(batch.final_k),
    )
    ptrs = np.asarray(res.pointers)
    host_ops = [mea_traceback(ptrs, batch.lo[:, b], b, int(batch.m[b]),
                              int(batch.n[b])) for b in range(3)]
    dev_ops = mea_decode(post, batch, gap_gamma, match_gamma)
    assert host_ops == dev_ops[:3]


def test_snapped_weights_make_the_decode_stable(rng):
    """A 1e-7 relative perturbation of the posteriors (backend rounding)
    leaves every cigar unchanged: the snapped DP is exact arithmetic."""
    reads = [rng.integers(0, 4, size=400).astype(np.int8) for _ in range(8)]
    refs = [r.copy() for r in reads]
    for r in reads:
        r[rng.integers(0, 400, size=40)] = rng.integers(0, 4, size=40)
    from marginalign_trna_tpu.models.hmm import PairHmm
    from marginalign_trna_tpu.ops.fb import (
        device_batch, forward_backward, make_tables,
    )

    batch = pack_banded_batch(reads, refs, width=21)
    hmm = PairHmm.load(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "marginalign_trna_tpu", "models", "last_hmm_20.txt"))
    post = np.asarray(forward_backward(make_tables(hmm),
                                       device_batch(batch)).posteriors)
    noisy = (post * (1 + 1e-7 * rng.standard_normal(post.shape))).astype(
        np.float32)
    assert mea_decode(post, batch) == mea_decode(noisy, batch)
    w = np.asarray(snap(jnp.asarray([0.3, NEG, 1e-9], jnp.float32)))
    assert w[0] * 2**20 == round(w[0] * 2**20) and w[1] == NEG and w[2] == 0


def _objective(ops, wdiag, wup, wleft, lo, b):
    """AMAP objective of one read's path, summed in float64, and the
    path's move count."""
    i = j = 0
    total = 0.0
    for op, ln in ops:
        for _ in range(ln):
            if op == 0:
                i, j, w = i + 1, j + 1, wdiag
            elif op == 1:
                i, w = i + 1, wup
            else:
                j, w = j + 1, wleft
            total += float(w[i + j, i - int(lo[i + j, b]), b])
    return total, sum(ln for _, ln in ops)


def test_tie_jitter_only_breaks_ties(rng):
    """The canonical decode's path, scored with the unsnapped, unjittered
    weights, is within path length x 16 grid steps (jitter <= 15, snapping
    <= 1/2 on each side) of the optimum those weights give."""
    from marginalign_trna_tpu.models.hmm import PairHmm
    from marginalign_trna_tpu.ops.fb import (
        device_batch, forward_backward, make_tables,
    )

    reads, refs = [], []
    for _ in range(6):
        ref = rng.integers(0, 4, size=300).astype(np.int8)
        ref[100:110] = 2  # a homopolymer, where indels tie
        read = np.delete(ref, rng.integers(0, 300, size=6))
        read = np.insert(read, rng.integers(0, len(read), size=4),
                         rng.integers(0, 4, size=4)).astype(np.int8)
        read[rng.integers(0, len(read), size=20)] = rng.integers(0, 4, 20)
        reads.append(read)
        refs.append(ref)
    batch = pack_banded_batch(reads, refs, width=21)
    hmm = PairHmm.load(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "marginalign_trna_tpu", "models", "last_hmm_20.txt"))
    dev = device_batch(batch)
    post = forward_backward(make_tables(hmm), dev).posteriors
    wup, wleft = mea_weights_device(post, batch, 0.5)
    wdiag = jnp.where(post > 0, post, NEG).astype(jnp.float32)
    raw = banded_mea(wdiag, wup, wleft, dev.valid, dev.s1, dev.s2,
                     dev.final_d, dev.final_k)
    ptrs = np.asarray(raw.pointers)
    w64 = [np.asarray(w, np.float64) for w in (wdiag, wup, wleft)]
    canon = mea_decode(post, batch)
    for b in range(len(reads)):
        m, n = int(batch.m[b]), int(batch.n[b])
        best, best_len = _objective(
            mea_traceback(ptrs, batch.lo[:, b], b, m, n), *w64, batch.lo, b)
        got, got_len = _objective(canon[b], *w64, batch.lo, b)
        assert got <= best + 1e-9 * abs(best) + 1e-6
        assert got >= best - 16 * max(got_len, best_len) / 2**20, (b, got,
                                                                   best)
    # The per-move bound the path bound rests on: every canonical weight
    # is its raw weight plus 0..15 grid steps, give or take half a step.
    canon_w = canonical_weights(wdiag, wup, wleft, batch.lo)
    for raw_w, c in zip(w64, canon_w):
        ok = raw_w > NEG / 2
        diff = (np.asarray(c, np.float64) - raw_w)[ok] * 2**20
        assert diff.min() >= -0.5 and diff.max() <= 15.5
