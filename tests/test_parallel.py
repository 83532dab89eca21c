"""Multi-device sharding tests on the virtual 8-device CPU mesh, plus a
real multi-process jax.distributed run (subprocess workers)."""
import os
import sys

import jax
import numpy as np
import pytest

from marginalign_trna_tpu.models.hmm import PairHmm
from marginalign_trna_tpu.ops.band import pack_banded_batch
from marginalign_trna_tpu.ops.fb import device_batch, forward_backward, make_tables
from marginalign_trna_tpu.parallel.mesh import (
    make_data_mesh, make_em_train_step, make_sharded_fb, pad_batch_lanes,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return make_data_mesh()


def _random_jobs(rng, count, m_range=(10, 30), n_range=(10, 30)):
    reads = [
        rng.integers(0, 4, size=rng.integers(*m_range)).astype(np.int8)
        for _ in range(count)
    ]
    refs = [
        rng.integers(0, 4, size=rng.integers(*n_range)).astype(np.int8)
        for _ in range(count)
    ]
    return reads, refs


def test_sharded_counts_match_single_device(mesh, rng):
    hmm = PairHmm.random(seed=5)
    reads, refs = _random_jobs(rng, 13)
    batch = pad_batch_lanes(
        pack_banded_batch(reads, refs, width=32), len(jax.devices())
    )
    tables = make_tables(hmm)
    dev = device_batch(batch)

    # Single-device reference result.
    res1 = forward_backward(tables, dev, want_posteriors=False,
                            want_counts=True)

    step = make_em_train_step(mesh)
    res8 = step(
        tables,
        jax.numpy.asarray(hmm.transitions, jax.numpy.float32),
        jax.numpy.asarray(hmm.emissions, jax.numpy.float32),
        dev,
    )
    assert np.allclose(np.asarray(res8.trans_counts),
                       np.asarray(res1.trans_counts), rtol=1e-3, atol=1e-3)
    assert np.allclose(np.asarray(res8.emit_match),
                       np.asarray(res1.emit_match), rtol=1e-3, atol=1e-3)
    ll1 = float(np.sum(np.asarray(res1.logZ)))
    assert np.isclose(float(res8.log_likelihood), ll1, rtol=1e-4)
    # M-step outputs are stochastic.
    assert np.allclose(np.asarray(res8.new_transitions).sum(axis=1), 1.0,
                       atol=1e-4)
    assert np.allclose(np.asarray(res8.new_emissions).sum(axis=1), 1.0,
                       atol=1e-4)


def test_sharded_posteriors_match(mesh, rng):
    hmm = PairHmm.random(seed=6)
    reads, refs = _random_jobs(rng, 8)
    batch = pad_batch_lanes(
        pack_banded_batch(reads, refs, width=32), len(jax.devices())
    )
    tables = make_tables(hmm)
    dev = device_batch(batch)
    res1 = forward_backward(tables, dev, want_posteriors=True)
    fb = make_sharded_fb(mesh)
    logZ8, post8 = fb(tables, dev)
    assert np.allclose(np.asarray(logZ8), np.asarray(res1.logZ),
                       rtol=1e-4, atol=1e-4)
    assert np.allclose(np.asarray(post8), np.asarray(res1.posteriors),
                       atol=1e-4)


def test_em_step_improves_likelihood(mesh, rng):
    """Two successive mesh EM steps: likelihood must not decrease."""
    hmm = PairHmm.random(seed=7)
    reads, refs = _random_jobs(rng, 8, (20, 40), (20, 40))
    batch = pad_batch_lanes(
        pack_banded_batch(reads, refs, width=48), len(jax.devices())
    )
    dev = device_batch(batch)
    step = make_em_train_step(mesh)

    t = jax.numpy.asarray(hmm.transitions, jax.numpy.float32)
    e = jax.numpy.asarray(hmm.emissions, jax.numpy.float32)
    lls = []
    for _ in range(3):
        res = step(make_tables(_hmm_from(t, e)), t, e, dev)
        lls.append(float(res.log_likelihood))
        t, e = res.new_transitions, res.new_emissions
    assert lls[1] >= lls[0] - 1e-3
    assert lls[2] >= lls[1] - 1e-3


def _hmm_from(t, e):
    h = PairHmm(np.asarray(t, np.float64), np.asarray(e, np.float64))
    return h


def test_sharded_caller_expectation_merge_matches_unsharded(mesh, rng):
    """make_sharded_caller_expectations: lane-sharded segment-sum partials
    psummed over the mesh == the single-device band_expectations result."""
    from marginalign_trna_tpu.ops.expectations import (
        band_expectations, run_boundaries,
    )
    from marginalign_trna_tpu.parallel.mesh import (
        make_sharded_caller_expectations,
    )

    hmm = PairHmm.random(seed=11)
    reads, refs = _random_jobs(rng, 16)
    batch = pad_batch_lanes(
        pack_banded_batch(reads, refs, width=16), len(jax.devices())
    )
    tables = make_tables(hmm)
    dev = device_batch(batch)
    res = forward_backward(tables, dev, want_posteriors=True)

    span = int(batch.n.max())
    offsets = (np.arange(batch.batch) * span).astype(np.int64)
    total = span * batch.batch
    rg = -(-total // 512) * 512
    e1 = run_boundaries(batch, offsets, rg, batch.batch)
    merge = make_sharded_caller_expectations(mesh, batch.width, rg)
    got = np.asarray(merge(
        res.posteriors,
        jax.numpy.asarray(batch.valid),
        jax.numpy.asarray(batch.yb),
        jax.numpy.asarray(batch.lo),
        jax.numpy.asarray(e1),
    ))[:total]
    want = band_expectations(res.posteriors, batch, offsets, total)
    assert np.allclose(got, want, atol=1e-4)


def test_two_process_distributed_em_and_caller_reduce(tmp_path):
    """REAL 2-process jax.distributed run on CPU (SURVEY.md §4: multi-host
    tests via jax.distributed): spawn two worker processes against a
    localhost coordinator; each computes the EM E-step over its
    shard_for_host share plus a caller-shaped expectation partial and
    merges with allreduce_sum_host.  Both processes must agree with the
    single-process result to f64 tolerance — including the 1e9 + 1e-7
    mixed-magnitude terms that a float32 all-reduce transport would
    destroy (the round-3 silent-downcast bug in allreduce_sum_host)."""
    import json
    import socket
    import subprocess

    import dist_worker

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers use 1 CPU device each
    env["JAX_PLATFORMS"] = "cpu"
    worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
    procs = []
    outs = [str(tmp_path / ("out%d.json" % p)) for p in range(2)]
    for p in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, worker, str(port), "2", str(p), outs[p]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    for p, proc in enumerate(procs):
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert proc.returncode == 0, (
            "worker %d failed:\n%s\n%s"
            % (p, stdout.decode(), stderr.decode())
        )

    # Single-process ground truth, computed with the same helpers in f64.
    jobs = dist_worker.make_jobs()
    tc, em, eg, ll = dist_worker.local_counts(jobs)
    exp = dist_worker.caller_partial(list(enumerate(jobs)))

    for p in range(2):
        with open(outs[p]) as fh:
            got = json.load(fh)
        assert got["process_id"] == p
        # E-step counts: shard union == full set.  The device E-step is
        # f32 (batch packing differs between the shards and the full
        # set), so counts agree at f32 level; the f64 claim is tested on
        # the host-side expectation partials below.
        np.testing.assert_allclose(np.array(got["tc"]), tc,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.array(got["em"]), em,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.array(got["eg"]), eg,
                                   rtol=1e-5, atol=1e-5)
        assert np.isclose(got["ll"], ll, rtol=1e-6)
        # Mixed-magnitude expectations must survive at f64 precision:
        # rtol 1e-12 admits f64 accumulation-order noise only.  An f32
        # transport (the round-3 bug) rounds the 1e9-scale cells at a
        # ~64-absolute granularity (6.4e-8 relative) and fails this.
        np.testing.assert_allclose(
            np.array(got["exp"]), exp, rtol=1e-12, atol=1e-5
        )

    # Realign path under 2-process sharding: both processes' all-gathered
    # output SAM must be identical to the single-process run (the
    # reference's jobTree fan-out of realignment chunks,
    # marginAlignLib.py:283-297, reproduced with shard_for_host +
    # allgather_host_objects).
    want_sam = dist_worker.realign_multihost(str(tmp_path / "single"))
    for p in range(2):
        with open(outs[p]) as fh:
            got = json.load(fh)
        assert got["sam"] == want_sam, "process %d realign SAM differs" % p


def test_runtime_helpers(monkeypatch):
    from marginalign_trna_tpu.parallel.runtime import (
        is_host_zero, local_dispatch_devices, shard_for_host,
    )

    assert is_host_zero()  # single-process tests
    assert shard_for_host([1, 2, 3]) == [1, 2, 3]
    monkeypatch.setenv("MARGINALIGN_LOCAL_DEVICES", "3")
    assert len(local_dispatch_devices()) == 3


def test_multi_device_round_robin_realign_and_caller(rng, monkeypatch):
    """Production multi-device dispatch: round-robin bucket placement
    across the virtual 8-device CPU mesh produces byte-identical realign
    ops and caller expectations vs single-device dispatch (VERDICT r4
    item 4: the realign path used to run on one chip of N)."""
    from marginalign_trna_tpu.align.realign import (
        RealignJob, realigned_ops_for_jobs,
    )
    from marginalign_trna_tpu.call.caller import (
        CallerOptions, accumulate_expectations,
    )
    from marginalign_trna_tpu.io.sam import SamFile, SamRecord, make_header
    from marginalign_trna_tpu.ops.band import path_from_cigar
    from marginalign_trna_tpu.parallel.runtime import local_dispatch_devices
    from marginalign_trna_tpu.utils.seq import BASES

    assert len(local_dispatch_devices()) == 8  # conftest virtual mesh

    hmm = PairHmm.load("marginalign_trna_tpu/models/last_hmm_20.txt")
    jobs = []
    for _ in range(10):
        m = int(rng.integers(40, 90))
        n = int(rng.integers(40, 90))
        jobs.append(RealignJob(
            record=None,
            read_region=rng.integers(0, 4, size=m).astype(np.int8),
            ref_region=rng.integers(0, 4, size=n).astype(np.int8),
            path=path_from_cigar(
                [(0, min(m, n))]
                + ([(1, m - n)] if m > n else [(2, n - m)] if n > m else [])
            ),
        ))
    # Tiny cell budget forces many buckets -> many devices touched.
    kw = dict(max_batch_cells=40_000, split_size=0)
    monkeypatch.setenv("MARGINALIGN_LOCAL_DEVICES", "1")
    want = realigned_ops_for_jobs(jobs, hmm, 0.5, 0.0, **kw)
    monkeypatch.delenv("MARGINALIGN_LOCAL_DEVICES")
    got = realigned_ops_for_jobs(jobs, hmm, 0.5, 0.0, **kw)
    assert want == got

    ref_codes = rng.integers(0, 4, size=160)
    ref_seq = "".join(BASES[c] for c in ref_codes)
    records = []
    for i in range(6):
        start = int(rng.integers(0, 30))
        ln = int(rng.integers(50, 100))
        read = ref_codes[start : start + ln].copy()
        subs = rng.random(ln) < 0.1
        read[subs] = rng.integers(0, 4, size=int(subs.sum()))
        records.append(SamRecord(
            qname="r%d" % i, flag=0, rname="ref", pos=start, mapq=60,
            cigar=[(0, ln)], seq="".join(BASES[c] for c in read),
            qual="*",
        ))
    sam = SamFile(make_header([("ref", 160)]), records)
    opts = CallerOptions(split_size=0, max_batch_cells=40_000)
    monkeypatch.setenv("MARGINALIGN_LOCAL_DEVICES", "1")
    want_e = accumulate_expectations(sam, {"ref": ref_seq}, hmm, opts)
    monkeypatch.delenv("MARGINALIGN_LOCAL_DEVICES")
    got_e = accumulate_expectations(sam, {"ref": ref_seq}, hmm, opts)
    for k in want_e:
        assert np.array_equal(want_e[k], got_e[k]), k


def test_allgather_host_objects_single_process():
    from marginalign_trna_tpu.parallel.runtime import allgather_host_objects

    obj = [("x", 1), ("y", [2, 3])]
    assert allgather_host_objects(obj) == [obj]
