"""Banded JAX forward-backward vs the unbanded numpy log-space oracle."""
import os

import numpy as np
import pytest

from marginalign_trna_tpu.models.hmm import PairHmm
from marginalign_trna_tpu.ops.band import (
    BandedBatch, band_offsets, pack_banded_batch, path_from_cigar, unpack_band,
)
from marginalign_trna_tpu.ops.fb import (
    device_batch, forward, forward_backward, make_tables,
)
from marginalign_trna_tpu.ops.oracle import forward_backward_full

MODELS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "marginalign_trna_tpu", "models",
)


def _random_pair(rng, m, n):
    y = rng.integers(0, 4, size=m).astype(np.int8)  # read
    x = rng.integers(0, 4, size=n).astype(np.int8)  # ref
    return x, y


def _full_width_batch(x, y, extra_b=0):
    m, n = len(y), len(x)
    width = m + 1  # full column coverage => unbanded
    reads, refs = [y] * (1 + extra_b), [x] * (1 + extra_b)
    return pack_banded_batch(reads, refs, width=width)


@pytest.mark.parametrize("m,n", [(5, 7), (12, 9), (16, 16), (1, 4), (4, 1)])
def test_logz_matches_oracle(rng, m, n):
    hmm = PairHmm.random(seed=m * 100 + n)
    x, y = _random_pair(rng, m, n)
    oracle = forward_backward_full(hmm, x, y)
    batch = _full_width_batch(x, y)
    tables = make_tables(hmm)
    _, _, logZ = forward(tables, device_batch(batch))
    assert np.allclose(float(logZ[0]), oracle.logZ, rtol=1e-4, atol=1e-4)


def test_posteriors_match_oracle(rng):
    hmm = PairHmm.load(os.path.join(MODELS, "last_hmm_20.txt"))
    m, n = 14, 15
    x, y = _random_pair(rng, m, n)
    oracle = forward_backward_full(hmm, x, y)
    batch = _full_width_batch(x, y)
    res = forward_backward(make_tables(hmm), device_batch(batch),
                           want_posteriors=True, want_counts=False)
    post = unpack_band(np.asarray(res.posteriors[:, :, 0]), batch, 0)
    assert np.allclose(post, oracle.post_match, atol=1e-4)


def test_counts_match_oracle(rng):
    hmm = PairHmm.random(seed=3)
    m, n = 10, 12
    x, y = _random_pair(rng, m, n)
    oracle = forward_backward_full(hmm, x, y)
    batch = _full_width_batch(x, y)
    res = forward_backward(make_tables(hmm), device_batch(batch),
                           want_posteriors=False, want_counts=True)
    assert np.allclose(np.asarray(res.trans_counts), oracle.trans_counts,
                       rtol=1e-3, atol=1e-4)
    assert np.allclose(np.asarray(res.emit_match), oracle.emit_match,
                       rtol=1e-3, atol=1e-4)
    assert np.allclose(np.asarray(res.emit_gap), oracle.emit_gap,
                       rtol=1e-3, atol=1e-4)


def test_batch_consistency(rng):
    """Mixed-length reads in one padded batch match their solo results."""
    hmm = PairHmm.random(seed=9)
    pairs = [_random_pair(rng, 8, 11), _random_pair(rng, 15, 9),
             _random_pair(rng, 5, 5)]
    width = 16 + 1
    reads = [y for _, y in pairs]
    refs = [x for x, _ in pairs]
    batch = pack_banded_batch(reads, refs, width=width, pad_batch_to=4)
    tables = make_tables(hmm)
    _, _, logZ = forward(tables, device_batch(batch))
    for b, (x, y) in enumerate(pairs):
        oracle = forward_backward_full(hmm, x, y)
        assert np.allclose(float(logZ[b]), oracle.logZ, rtol=1e-4, atol=1e-4), b


def test_banded_close_to_unbanded(rng):
    """A band following the true alignment path captures ~all probability."""
    hmm = PairHmm.load(os.path.join(MODELS, "last_hmm_20.txt"))
    n = 60
    x = rng.integers(0, 4, size=n).astype(np.int8)
    # Read = ref with a few substitutions -> path ~ main diagonal.
    y = x.copy()
    y[rng.integers(0, n, size=6)] = rng.integers(0, 4, size=6)
    oracle = forward_backward_full(hmm, x, y)
    path_d, path_i = path_from_cigar([(0, n)])
    batch = pack_banded_batch([y], [x], width=15, paths=[(path_d, path_i)])
    res = forward_backward(make_tables(hmm), device_batch(batch))
    assert np.allclose(float(res.logZ[0]), oracle.logZ, rtol=1e-3, atol=0.5)
    post = unpack_band(np.asarray(res.posteriors[:, :, 0]), batch, 0)
    diag_post = np.diag(post)
    assert np.allclose(diag_post, np.diag(oracle.post_match), atol=2e-2)


def test_band_offsets_invariants():
    for m, n, w in [(10, 10, 5), (3, 20, 7), (20, 3, 7), (50, 50, 11)]:
        lo = band_offsets(m, n, w)
        assert lo[0] == 0
        steps = np.diff(lo)
        assert np.all((steps >= 0) & (steps <= 1))
        # Terminal cell (m, n) inside the band.
        assert lo[-1] <= m <= lo[-1] + w - 1 or m < w


def test_path_from_cigar():
    ds, is_ = path_from_cigar([(0, 3), (1, 2), (2, 1), (0, 1)])
    assert ds[0] == 0 and is_[0] == 0
    # Ends at (m, n) = (3+2+1, 3+1+1) -> d = m+n.
    assert is_[-1] == 6 and ds[-1] == 6 + 5


def test_dp_cells_accounting(rng):
    x, y = _random_pair(rng, 20, 20)
    batch = pack_banded_batch([y], [x], width=9)
    cells = batch.dp_cells()
    assert 0 < cells <= (20 + 20 + 1) * 9


def test_long_read_posteriors_keep_f32_precision(tmp_path):
    """At 3.5 kb, cumulative log scales reach ~|logZ| ~ 8e3, where one f32
    ulp is ~5e-4; the posterior scale must not be formed from them.  The
    f32 engine is compared with the same engine in float64 (x64 mode, so
    in a subprocess)."""
    import subprocess
    import sys

    script = r'''
import os, sys
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from __graft_entry__ import _example_sequences
from marginalign_trna_tpu.models.hmm import PairHmm
from marginalign_trna_tpu.ops.band import pack_banded_batch
from marginalign_trna_tpu.ops.fb import device_batch, forward_backward, make_tables
hmm = PairHmm.load(os.path.join(sys.argv[1], "marginalign_trna_tpu",
                                "models", "last_hmm_20.txt"))
reads, refs, _ = _example_sequences(2, 3500, 3500, seed=1)
dev = device_batch(pack_banded_batch(reads, refs, width=21))
r32 = forward_backward(make_tables(hmm, jnp.float32), dev)
r64 = forward_backward(make_tables(hmm, jnp.float64), dev)
print(float(np.abs(np.asarray(r32.posteriors, np.float64)
                   - np.asarray(r64.posteriors)).max()))
print(float(np.max(np.abs(np.asarray(r32.logZ, np.float64)
                          - np.asarray(r64.logZ)) / np.abs(np.asarray(r64.logZ)))))
'''
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="")
    r = subprocess.run([sys.executable, "-c", script, repo],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    post_err, logz_err = (float(v) for v in r.stdout.split())
    assert post_err < 1e-4, post_err   # 1.6e-5 measured; 3.5e-2 before
    assert logz_err < 1e-5, logz_err
