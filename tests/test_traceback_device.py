"""Device-side traceback scans vs plain sequential tracebacks (exact)."""
import jax.numpy as jnp
import numpy as np

from marginalign_trna_tpu.ops.band import pack_banded_batch
from marginalign_trna_tpu.ops.fb import device_batch
from marginalign_trna_tpu.ops.mea import NEG, banded_mea, mea_weights
from marginalign_trna_tpu.ops.nw import banded_nw
from marginalign_trna_tpu.ops.traceback_device import (
    mea_moves_device, nw_moves_device, ops_from_moves, pack_moves,
    pull_ops, unpack_moves,
)
from tb_reference import mea_traceback, nw_traceback


def _mutate(rng, x, sub=0.12, ind=0.06):
    out = []
    for c in x:
        r = rng.random()
        if r < ind / 2:
            continue  # deletion
        if r < ind:
            out.append(int(rng.integers(0, 4)))  # insertion
        out.append(int(c) if rng.random() > sub else int(rng.integers(0, 4)))
    return np.asarray(out, np.int8)


def _random_batch(rng, sizes=(9, 40, 85, 1, 130), width=21):
    refs = [rng.integers(0, 4, size=n).astype(np.int8) for n in sizes]
    reads = [_mutate(rng, x) for x in refs]
    return pack_banded_batch(reads, refs, width=width, pad_batch_to=8)


def test_nw_moves_device_matches_host(rng):
    batch = _random_batch(rng)
    params = jnp.asarray([1.0, -2.0, -3.0, -1.0], jnp.float32)
    res = banded_nw(params, device_batch(batch))
    ptrs = np.ascontiguousarray(np.asarray(res.pointers))
    fs = np.asarray(res.final_state)
    mvs = np.asarray(
        nw_moves_device(
            res.pointers, jnp.asarray(batch.lo), jnp.asarray(batch.m),
            jnp.asarray(batch.n), res.final_state,
        )
    )
    for b in range(5):
        expect = nw_traceback(ptrs, batch.lo[:, b], b, int(batch.m[b]),
                              int(batch.n[b]), int(fs[b]))
        got = ops_from_moves(mvs, b)
        assert got == expect, f"lane {b}"


def test_nw_moves_pack_roundtrip(rng):
    batch = _random_batch(rng, sizes=(33, 7))
    params = jnp.asarray([1.0, -2.0, -3.0, -1.0], jnp.float32)
    res = banded_nw(params, device_batch(batch))
    mv_dev = nw_moves_device(
        res.pointers, jnp.asarray(batch.lo), jnp.asarray(batch.m),
        jnp.asarray(batch.n), res.final_state,
    )
    packed = np.asarray(pack_moves(mv_dev))
    T = mv_dev.shape[0]
    unpacked = unpack_moves(packed, T)
    assert np.array_equal(unpacked, np.asarray(mv_dev).astype(np.uint8))


def test_mea_moves_device_matches_host(rng):
    batch = _random_batch(rng, sizes=(60, 11, 2, 95))
    D1, Wp, B = batch.valid.shape
    post = rng.random((D1, Wp, B)).astype(np.float32) * batch.valid
    wup, wleft = mea_weights(post, batch, 0.5)
    wdiag = np.where(post > 0, post, NEG).astype(np.float32)
    res = banded_mea(
        jnp.asarray(wdiag), jnp.asarray(wup), jnp.asarray(wleft),
        jnp.asarray(batch.valid), jnp.asarray(batch.s1),
        jnp.asarray(batch.s2), jnp.asarray(batch.final_d),
        jnp.asarray(batch.final_k),
    )
    ptrs = np.ascontiguousarray(np.asarray(res.pointers))
    mvs = np.asarray(
        mea_moves_device(
            res.pointers, jnp.asarray(batch.lo), jnp.asarray(batch.m),
            jnp.asarray(batch.n),
        )
    )
    for b in range(4):
        expect = mea_traceback(ptrs, batch.lo[:, b], b, int(batch.m[b]),
                               int(batch.n[b]))
        got = ops_from_moves(mvs, b)
        assert got == expect, f"lane {b}"


def test_mea_moves_out_of_range_pointer():
    """A pointer value outside {0, 1, 2} moves up (consumes the read
    only), exactly like the sequential traceback's fall-through branch."""
    batch = pack_banded_batch([np.zeros(3, np.int8)], [np.zeros(3, np.int8)],
                              width=7)
    D1, Wp, B = batch.valid.shape
    ptrs = np.full((D1, Wp, B), 3, np.uint8)
    got = pull_ops(pack_moves(mea_moves_device(
        ptrs, batch.lo, batch.m, batch.n)), D1, 1)[0]
    expect = mea_traceback(ptrs, batch.lo[:, 0], 0, 3, 3)
    assert got == expect == [(2, 3), (1, 3)]
