"""Device segment-sum expectations vs the host np.add.at oracle."""
import numpy as np

from marginalign_trna_tpu.ops.band import pack_banded_batch, path_from_cigar
from marginalign_trna_tpu.ops.expectations import (
    band_expectations, band_expectations_host,
)


def _random_batch(rng, with_paths=False, pad_batch_to=None):
    reads = [rng.integers(0, 5, size=m).astype(np.int8)
             for m in (9, 17, 30, 24)]
    refs = [rng.integers(0, 4, size=n).astype(np.int8)
            for n in (12, 15, 28, 24)]
    paths = None
    if with_paths:
        # A guide with an indel so the band (and lo) actually moves.
        paths = [None, None,
                 path_from_cigar([(0, 10), (2, 5), (0, 13)]), None]
    return pack_banded_batch(
        reads, refs, width=9, paths=paths, pad_batch_to=pad_batch_to
    )


def test_device_matches_host_oracle(rng):
    batch = _random_batch(rng)
    D1, Wp, B = batch.xb.shape
    post = rng.random((D1, Wp, B)).astype(np.float32) * batch.valid
    # Lanes target two "references" at distinct global offsets.
    offsets = np.array([0, 40, 7, 61], dtype=np.int64)
    total = 100
    want = band_expectations_host(post, batch, offsets, total)
    got = band_expectations(post, batch, offsets, total)
    assert got.shape == (total, 4)
    assert np.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_device_matches_host_with_moving_band_and_padding(rng):
    batch = _random_batch(rng, with_paths=True, pad_batch_to=8)
    D1, Wp, B = batch.xb.shape
    post = rng.random((D1, Wp, B)).astype(np.float32) * batch.valid
    offsets = np.zeros(B, dtype=np.int64)
    offsets[:4] = [3, 3, 50, 20]  # overlapping windows accumulate
    total = 90
    want = band_expectations_host(post, batch, offsets, total, n_real=4)
    got = band_expectations(post, batch, offsets, total, n_real=4)
    assert np.allclose(got, want, rtol=1e-5, atol=1e-5)
    # Padded lanes contribute nothing: zeroing them changes nothing.
    assert float(np.abs(got - want).max()) < 1e-5


def test_n_bases_excluded(rng):
    """Read code 4 (N) must not be counted in any base column."""
    reads = [np.full(10, 4, dtype=np.int8)]
    refs = [rng.integers(0, 4, size=10).astype(np.int8)]
    batch = pack_banded_batch(reads, refs, width=9)
    D1, Wp, B = batch.xb.shape
    post = np.ones((D1, Wp, B), np.float32) * batch.valid
    got = band_expectations(post, batch, np.zeros(1, np.int64), 20)
    assert np.allclose(got, 0.0)
