"""Anchor splitting (reference --splitMatrixBiggerThanThis semantics)."""
import os

import numpy as np
import pytest

from marginalign_trna_tpu.models.hmm import PairHmm
from marginalign_trna_tpu.align.realign import (
    RealignJob, realigned_ops_for_jobs, split_job_at_anchors,
    split_jobs_at_anchors,
)
from marginalign_trna_tpu.ops.band import path_from_cigar

MODEL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "marginalign_trna_tpu", "models", "last_hmm_20.txt",
)


def _noisy_pair(rng, n):
    """Read = ref with substitutions and known indels; returns the TRUE
    cigar alongside (a realistic guide, like the chained mapper output)."""
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    read_parts, ops = [], []
    pos = 0
    while pos < n:
        run = int(rng.integers(40, 90))
        run = min(run, n - pos)
        chunk = ref[pos : pos + run].copy()
        subs = rng.random(run) < 0.10
        chunk[subs] = rng.integers(0, 4, size=int(subs.sum()))
        read_parts.append(chunk)
        ops.append((0, run))
        pos += run
        if pos >= n:
            break
        what = rng.random()
        if what < 0.4:  # deletion from the read
            dl = int(rng.integers(1, 4))
            dl = min(dl, n - pos)
            ops.append((2, dl))
            pos += dl
        elif what < 0.8:  # insertion into the read
            il = int(rng.integers(1, 4))
            read_parts.append(
                rng.integers(0, 4, size=il).astype(np.int8))
            ops.append((1, il))
    read = np.concatenate(read_parts).astype(np.int8)
    return read, ref, ops


def _job(read, ref, ops):
    pd, pi = path_from_cigar(ops)
    return RealignJob(record=None, read_region=read, ref_region=ref,
                      path=(pd, pi))


def test_split_partitions_exactly(rng):
    read, ref, ops = _noisy_pair(rng, 1000)
    job = _job(read, ref, ops)
    pieces = split_job_at_anchors(job, 150)
    assert len(pieces) >= 6
    assert sum(len(p.read_region) for p in pieces) == len(read)
    assert sum(len(p.ref_region) for p in pieces) == len(ref)
    np.testing.assert_array_equal(
        np.concatenate([p.read_region for p in pieces]), read)
    np.testing.assert_array_equal(
        np.concatenate([p.ref_region for p in pieces]), ref)
    for p in pieces:
        ms, ns = len(p.read_region), len(p.ref_region)
        assert ms + ns <= 150 + 8  # d-span bounded by split (+snap)
        pd, pi = p.path
        assert pd[0] == 0 and pi[0] == 0
        assert pd[-1] == ms + ns and pi[-1] == ms
        assert np.all(np.diff(pd) > 0)
        assert np.all(np.diff(pi) >= 0)


def test_split_noop_below_threshold(rng):
    read, ref, ops = _noisy_pair(rng, 80)
    job = _job(read, ref, ops)
    assert split_job_at_anchors(job, 100) == [job]
    assert split_job_at_anchors(job, 0) == [job]


def test_split_realign_quality_close_to_unsplit(rng):
    """Split realignment is an approximation (the reference's): cigars must
    stay span-consistent and nearly as accurate as the exact DP."""
    hmm = PairHmm.load(MODEL)
    jobs = [_job(*_noisy_pair(rng, 600)) for _ in range(3)]

    exact = realigned_ops_for_jobs(jobs, hmm, 0.5, 0.0, split_size=0)
    split = realigned_ops_for_jobs(jobs, hmm, 0.5, 0.0, split_size=150)

    for job, ops_e, ops_s in zip(jobs, exact, split):
        m, n = len(job.read_region), len(job.ref_region)
        for ops in (ops_e, ops_s):
            assert sum(l for op, l in ops if op in (0, 1)) == m
            assert sum(l for op, l in ops if op in (0, 2)) == n

        def matches(ops, job=job):
            i = j = good = 0
            for op, l in ops:
                if op == 0:
                    a = job.read_region[i : i + l]
                    b = job.ref_region[j : j + l]
                    good += int((a == b).sum())
                    i += l
                    j += l
                elif op == 1:
                    i += l
                else:
                    j += l
            return good

        ge, gs = matches(ops_e), matches(ops_s)
        assert gs >= ge - max(8, 0.02 * ge)  # near-exact accuracy


def test_split_jobs_bookkeeping(rng):
    jobs = [_job(*_noisy_pair(rng, 400)), _job(*_noisy_pair(rng, 50))]
    segs, origin, starts = split_jobs_at_anchors(jobs, 100)
    assert origin == sorted(origin)
    assert sum(1 for o in origin if o == 1) == 1  # small job unsplit
    # Segment starts advance by segment sizes within each job.
    i0 = j0 = 0
    for s, o in enumerate(origin):
        if o != 0:
            continue
        assert starts[s] == (i0, j0)
        i0 += len(segs[s].read_region)
        j0 += len(segs[s].ref_region)
