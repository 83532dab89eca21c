"""Native library vs pure-Python fallbacks."""
import os

import numpy as np
import pytest

from marginalign_trna_tpu import native


def test_native_builds_and_loads():
    assert native.available(), (
        "native library failed to build; check native/Makefile with g++"
    )


def test_chain_seeds_matches_python(rng):
    from marginalign_trna_tpu.align.guide import GuideConfig, chain_seeds

    cfg = GuideConfig()
    # Random colinear-ish hits with noise.
    base = np.sort(rng.integers(0, 3000, size=200))
    hits = [(int(v + rng.integers(-5, 5)), int(v)) for v in base]
    hits += [(int(rng.integers(0, 3000)), int(rng.integers(0, 3000)))
             for _ in range(50)]

    chain_nat, score_nat = chain_seeds(list(hits), cfg)
    os.environ["MARGINALIGN_NO_NATIVE"] = "1"
    native._lib = None
    native._tried = False
    try:
        chain_py, score_py = chain_seeds(list(hits), cfg)
    finally:
        del os.environ["MARGINALIGN_NO_NATIVE"]
        native._tried = False

    assert score_nat == score_py
    # Both must be valid chains of the same length (tie-breaks may differ).
    for chain in (chain_nat, chain_py):
        for (q1, r1), (q2, r2) in zip(chain, chain[1:]):
            assert q2 > q1 and r2 > r1


def test_pack_band_lane_matches_numpy(rng):
    from marginalign_trna_tpu.ops.band import pack_banded_batch

    reads = [rng.integers(0, 5, size=m).astype(np.int8) for m in (30, 55)]
    refs = [rng.integers(0, 5, size=n).astype(np.int8) for n in (40, 50)]
    nat = pack_banded_batch(reads, refs, width=17)
    os.environ["MARGINALIGN_NO_NATIVE"] = "1"
    native._lib = None
    native._tried = False
    try:
        py = pack_banded_batch(reads, refs, width=17)
    finally:
        del os.environ["MARGINALIGN_NO_NATIVE"]
        native._tried = False
    assert np.array_equal(nat.xb, py.xb)
    assert np.array_equal(nat.yb, py.yb)
    assert np.array_equal(nat.valid, py.valid)
    assert np.array_equal(nat.lo, py.lo)
