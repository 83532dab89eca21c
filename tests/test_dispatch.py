"""Posterior engine entry point, device batch budgets, bucketing, stage
timers and default-device dispatch."""
import logging

import jax
import numpy as np
import pytest

from marginalign_trna_tpu.models.hmm import PairHmm
from marginalign_trna_tpu.ops import dispatch
from marginalign_trna_tpu.ops.band import (
    bucket_by_cells, pack_banded_batch, quantized_lanes, quantized_steps,
)
from marginalign_trna_tpu.ops.fb import device_batch, forward_backward, make_tables


def _batch(rng):
    reads = [rng.integers(0, 4, size=m).astype(np.int8) for m in (20, 33)]
    refs = [rng.integers(0, 4, size=n).astype(np.int8) for n in (25, 30)]
    return pack_banded_batch(reads, refs, width=9)


def test_fb_posteriors_cpu_is_the_xla_engine(rng):
    hmm = PairHmm.random(seed=4)
    dev = device_batch(_batch(rng))
    logz, post = dispatch.fb_posteriors(make_tables(hmm), dev)
    res = forward_backward(make_tables(hmm), dev)
    assert np.array_equal(np.asarray(logz), np.asarray(res.logZ))
    assert np.array_equal(np.asarray(post), np.asarray(res.posteriors))


@pytest.mark.gpu
def test_posteriors_on_gpu_match_cpu_backend(gpu, rng):
    """The engine on the card against the same engine on the CPU backend
    (the tolerances of chip_smoke.py phase 3)."""
    hmm = PairHmm.random(seed=4)
    batch = _batch(rng)
    logz, post = dispatch.fb_posteriors(make_tables(hmm), device_batch(batch))
    with jax.default_device(jax.devices("cpu")[0]):
        res = forward_backward(make_tables(hmm), device_batch(batch))
    assert np.allclose(np.asarray(post), np.asarray(res.posteriors),
                       atol=2e-4)
    assert np.allclose(np.asarray(logz), np.asarray(res.logZ), rtol=1e-5)


@pytest.mark.parametrize("stage", sorted(dispatch.CPU_BATCH_CELLS))
def test_max_batch_cells_cpu(stage):
    assert (dispatch.max_batch_cells_for(stage)
            == dispatch.CPU_BATCH_CELLS[stage])


class _FakeGpu:
    platform = "gpu"

    def memory_stats(self):
        return {"bytes_limit": 60 * 2**30}


@pytest.mark.parametrize("stage", sorted(dispatch.BYTES_PER_CELL))
def test_max_batch_cells_from_device_memory(stage):
    got = dispatch.max_batch_cells_for(stage, _FakeGpu())
    want = int(60 * 2**30 * dispatch.BATCH_MEMORY_SHARE) // (
        dispatch.BYTES_PER_CELL[stage])
    assert got == want
    # A 3.5 kb read's full band (7,168 diagonals x 21) fits many times.
    assert got >= 64 * 7168 * 21


@pytest.mark.parametrize("device", [None, _FakeGpu()], ids=["cpu", "gpu"])
def test_max_batch_cells_divides_by_trials(device):
    one = dispatch.max_batch_cells_for("em", device)
    assert dispatch.max_batch_cells_for("em", device, trials=3) == one // 3


def test_bucket_by_cells_counts_packed_cells(rng):
    """No bucket of two or more problems packs to more cells than the
    budget, counted as pack_banded_batch(quantize=True) pads it."""
    sizes = [int(s) for s in rng.integers(50, 3000, size=300)]
    budget = 4_000_000
    buckets = bucket_by_cells(sizes, 21, budget)
    assert sorted(i for b in buckets for i in b) == list(range(len(sizes)))
    for b in buckets:
        cells = (quantized_steps(max(sizes[i] for i in b))
                 * quantized_lanes(len(b)) * 21)
        assert len(b) == 1 or cells <= budget
    reads = [rng.integers(0, 4, size=m).astype(np.int8) for m in (40, 90)]
    batch = pack_banded_batch(reads, reads, width=9, quantize=True)
    assert batch.xb.shape[0] == quantized_steps(181) == 256
    assert batch.xb.shape[2] == quantized_lanes(2) == 8
    assert quantized_steps(1025) == 2048 and quantized_lanes(9) == 16


def test_stage_timer_pieces_sync_only_at_debug(monkeypatch):
    """Stage timers report `stage` and `seconds` at debug level, where
    stage_sync blocks on the device result; otherwise nothing blocks."""
    from marginalign_trna_tpu.utils import obs

    blocked, records = [], []
    monkeypatch.setattr(jax, "block_until_ready",
                        lambda x: blocked.append(x) or x)

    class Collect(logging.Handler):
        def emit(self, record):
            records.append((record.stage, record.seconds))

    handler = Collect(logging.DEBUG)
    obs.logger.addHandler(handler)
    try:
        obs.logger.setLevel(logging.INFO)
        with obs.stage_timer("quiet"):
            assert obs.stage_sync(1) == 1
        obs.logger.setLevel(logging.DEBUG)
        with obs.stage_timer("piece", dp_cells=10):
            assert obs.stage_sync(2) == 2
    finally:
        obs.logger.setLevel(logging.NOTSET)
        obs.logger.removeHandler(handler)
    assert blocked == [2]
    assert [name for name, _ in records] == ["piece"]
    assert records[0][1] >= 0


def test_default_device_pins_dispatch():
    from marginalign_trna_tpu.parallel.runtime import local_dispatch_devices

    assert len(local_dispatch_devices()) == len(jax.local_devices())
    target = jax.devices("cpu")[2]
    with jax.default_device(target):
        assert local_dispatch_devices() == [target]
    with jax.default_device("cpu"):
        assert len(local_dispatch_devices()) == 1
