"""Pair-HMM realignment of a chained SAM file (batched, on device).

Behavioural equivalent of the reference realignment stage
(src/margin/marginAlignLib.py:265-370): optionally chain, then for every
record realign the aligned read region against its reference span with the
banded pair-HMM posterior + AMAP decode, and splice the realigned cigar back
between the original clips.  Where the reference forked one cPecanRealign
process per read over jobTree, this batches all reads into device-wide
wavefront calls bucketed by size.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax
import numpy as np

from ..io.fasta import get_fasta_dictionary
from ..io.sam import SamFile, SamRecord
from ..models.hmm import PairHmm
from ..ops.band import bucket_by_cells, pack_banded_batch, path_from_cigar
from ..ops.dispatch import fb_posteriors, max_batch_cells_for
from ..ops.fb import device_batch, make_tables
from ..ops.mea import mea_decode
from ..parallel.runtime import local_dispatch_devices
from ..utils.obs import stage_sync, stage_timer
from .chain import chain_sam_file

# Band width = 2 * diagonalExpansion + 1 with the reference's expansion of 10
# (src/margin/marginAlignLib.py:315).
DEFAULT_BAND_WIDTH = 21

# Reference realign-path --splitMatrixBiggerThanThis
# (src/margin/marginAlignLib.py:316); 0 disables splitting.
DEFAULT_SPLIT_SIZE = 3000


@dataclass
class RealignJob:
    record: SamRecord
    read_region: np.ndarray  # encoded aligned read bases
    ref_region: np.ndarray   # encoded reference span
    path: Tuple[np.ndarray, np.ndarray]


def _jobs_from_sam(
    sam: SamFile, ref_sequences, encode_fn
) -> List[RealignJob]:
    jobs = []
    for rec in sam.mapped():
        read_region = rec.query_alignment_sequence
        ref_seq = ref_sequences[rec.rname]
        ref_region = ref_seq[rec.reference_start : rec.reference_end]
        aligned_ops = [(op, l) for op, l in rec.cigar if op in (0, 1, 2)]
        if not aligned_ops or not read_region or not ref_region:
            continue
        pd, pi = path_from_cigar(aligned_ops)
        jobs.append(
            RealignJob(
                record=rec,
                read_region=encode_fn(read_region),
                ref_region=encode_fn(ref_region),
                path=(pd, pi),
            )
        )
    return jobs


def split_job_at_anchors(
    job: RealignJob, split_size: int
) -> List[RealignJob]:
    """Decompose one alignment problem at guide-path anchor points so that
    no sub-matrix side exceeds split_size; each segment realigns
    independently, pinned through the anchor pair, and the segment results
    concatenate in order.

    Behavioural equivalent of cPecanRealign --splitMatrixBiggerThanThis=n
    [reconstructed from the call sites: n=3000 realign
    (src/margin/marginAlignLib.py:316), 300 EM (src/margin/marginAlign.py:41),
    100 caller / 1 noMargin (src/margin/marginCallerLib.py:50,55)]: the
    reference cuts large DP matrices into independent sub-problems at
    confident anchor points of the guide alignment.  split_size <= 0
    disables splitting (exact full-length DP)."""
    m = len(job.read_region)
    n = len(job.ref_region)
    if split_size <= 0 or max(m, n) <= split_size or min(m, n) < 2:
        return [job]
    pd, pi = job.path
    pj = pd - pi
    D = m + n
    k = -(-D // split_size)
    if k < 2:
        return [job]
    # Cut points ON the guide path (anchors must be actual guide pairs):
    # inside a match run the path is exactly diagonal, so any interior
    # (i, j) is a guide pair; inside an indel run snap to the nearer
    # vertex.  Cutting in d-space bounds every segment's m+n (hence both
    # sides) by ~split_size.
    keep = []
    last_i, last_j = 0, 0
    for c in range(1, k):
        dt = int(round(c * D / k))
        t = int(np.searchsorted(pd, dt, side="right")) - 1
        t = min(max(t, 0), len(pd) - 2)
        dd = int(pd[t + 1] - pd[t])
        di = int(pi[t + 1] - pi[t])
        if di > 0 and dd == 2 * di:
            step = min(max((dt - int(pd[t])) // 2, 0), di)
            ic = int(pi[t]) + step
            jc = int(pj[t]) + step
        elif dt - pd[t] <= pd[t + 1] - dt:
            ic, jc = int(pi[t]), int(pj[t])
        else:
            ic, jc = int(pi[t + 1]), int(pj[t + 1])
        if last_i < ic < m and last_j < jc < n:
            keep.append((ic, jc))
            last_i, last_j = ic, jc
    bounds = [(0, 0)] + keep + [(m, n)]
    if len(bounds) == 2:
        return [job]

    out = []
    for (i0, j0), (i1, j1) in zip(bounds[:-1], bounds[1:]):
        ms, ns = i1 - i0, j1 - j0
        d0, d1 = i0 + j0, i1 + j1
        sel = (pd > d0) & (pd < d1) & (pi >= i0) & (pi <= i1) \
            & (pj >= j0) & (pj <= j1)
        sub_d = np.concatenate([[0], pd[sel] - d0, [ms + ns]])
        sub_i = np.concatenate([[0], pi[sel] - i0, [ms]])
        # Keep strictly-increasing d (band_offsets interpolates vertices).
        uniq = np.concatenate([[True], np.diff(sub_d) > 0])
        out.append(
            RealignJob(
                record=job.record,
                read_region=job.read_region[i0:i1],
                ref_region=job.ref_region[j0:j1],
                path=(sub_d[uniq], sub_i[uniq]),
            )
        )
    return out


def _merge_op_runs(ops: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge adjacent same-op runs (segment concatenation seams)."""
    out: List[Tuple[int, int]] = []
    for op, ln in ops:
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + ln)
        else:
            out.append((op, ln))
    return out


def split_jobs_at_anchors(
    jobs: Sequence[RealignJob], split_size: int
) -> Tuple[List[RealignJob], List[int], List[Tuple[int, int]]]:
    """Explode jobs into anchor segments.  Returns (segments, origin,
    seg_starts) where origin[s] = source job index (segments of one job
    stay contiguous and ordered) and seg_starts[s] = (i0, j0) of the
    segment inside its job's aligned region."""
    segs: List[RealignJob] = []
    origin: List[int] = []
    starts: List[Tuple[int, int]] = []
    for idx, job in enumerate(jobs):
        pieces = split_job_at_anchors(job, split_size)
        i0 = j0 = 0
        for p in pieces:
            segs.append(p)
            origin.append(idx)
            starts.append((i0, j0))
            i0 += len(p.read_region)
            j0 += len(p.ref_region)
    return segs, origin, starts


def _bucket_jobs(
    jobs: Sequence[RealignJob], width: int, max_batch_cells: int
) -> List[List[int]]:
    """Group job indices into batches bounded by padded DP volume, after
    sorting by size so padding waste stays low (the reference's analog is
    the maxAlignmentLengthPerJob chunker, src/margin/utils.py:157-176)."""
    return bucket_by_cells(
        [len(j.read_region) + len(j.ref_region) + 1 for j in jobs],
        width, max_batch_cells,
    )


def realigned_ops_for_jobs(
    jobs: Sequence[RealignJob],
    hmm: PairHmm,
    gap_gamma: float,
    match_gamma: float,
    band_width: int = DEFAULT_BAND_WIDTH,
    max_batch_cells: Optional[int] = None,
    split_size: int = 0,
) -> List[List[Tuple[int, int]]]:
    """Run FB + MEA for every job; returns realigned aligned-region ops.

    max_batch_cells bounds each bucket's padded DP cells (default:
    dispatch.max_batch_cells_for("realign"), sized from device memory).
    split_size > 0 decomposes each problem at guide-path anchors
    (split_job_at_anchors) and concatenates the per-segment cigars."""
    if max_batch_cells is None:
        max_batch_cells = max_batch_cells_for("realign")
    if split_size and split_size > 0:
        segs, origin, _ = split_jobs_at_anchors(jobs, split_size)
        if len(segs) != len(jobs):
            seg_ops = realigned_ops_for_jobs(
                segs, hmm, gap_gamma, match_gamma, band_width,
                max_batch_cells, split_size=0,
            )
            out: List[List[Tuple[int, int]]] = [[] for _ in jobs]
            for s_idx, j_idx in enumerate(origin):
                out[j_idx].extend(seg_ops[s_idx])
            return [_merge_op_runs(ops) for ops in out]

    tables = make_tables(hmm)
    results: List[Optional[List[Tuple[int, int]]]] = [None] * len(jobs)
    devices = local_dispatch_devices()

    def _dispatch(bucket, device):
        """FB the bucket asynchronously on `device`; the posterior band
        stays there until the MEA decode pulls the traceback.  Committed
        inputs pin the bucket's computation to its device, so the
        in-flight window spreads buckets across all local devices (the
        reference fanned realign jobs across jobTree workers,
        src/margin/marginAlignLib.py:283-297)."""
        with stage_timer("realign.pack"):
            batch = pack_banded_batch(
                [jobs[i].read_region for i in bucket],
                [jobs[i].ref_region for i in bucket],
                width=band_width,
                paths=[jobs[i].path for i in bucket],
                quantize=True,
            )
        with stage_timer("realign.upload"):
            dev = stage_sync(device_batch(batch, device))
        with stage_timer("realign.fb"):
            _, post_dev = stage_sync(fb_posteriors(tables, dev))
        return batch, dev, post_dev

    # Window of in-flight buckets: bounded because each pins its posterior
    # band on device until decoded; with several local devices the window
    # widens so every device keeps a bucket in flight.
    pipeline_depth = 2 * len(devices)
    pending = []

    def _drain_one():
        bucket, (batch, dev, post_dev) = pending.pop(0)
        ops_list = mea_decode(post_dev, batch, gap_gamma, match_gamma,
                              dev=dev)
        for local_b, job_idx in enumerate(bucket):
            results[job_idx] = ops_list[local_b]

    for bi, bucket in enumerate(_bucket_jobs(jobs, band_width,
                                             max_batch_cells)):
        pending.append(
            (bucket, _dispatch(bucket, devices[bi % len(devices)]))
        )
        if len(pending) > pipeline_depth:
            _drain_one()
    while pending:
        _drain_one()
    return results  # type: ignore[return-value]


def splice_realigned_cigar(
    rec: SamRecord, new_ops: List[Tuple[int, int]]
) -> SamRecord:
    """Replace a record's aligned ops with realigned ones, re-adding
    soft/hard clips, with the reference's consistency assertions
    (realignSamFile3TargetFn, src/margin/marginAlignLib.py:320-367)."""
    out = rec.copy()
    ops: List[Tuple[int, int]] = []
    if rec.cigar and rec.cigar[0][0] == 5:
        ops.append(rec.cigar[0])
    if rec.query_alignment_start > 0:
        ops.append((4, rec.query_alignment_start))
    ops.extend(new_ops)
    if rec.query_alignment_end < len(rec.query_sequence):
        ops.append((4, len(rec.query_sequence) - rec.query_alignment_end))
    if len(rec.cigar) > 1 and rec.cigar[-1][0] == 5:
        ops.append(rec.cigar[-1])

    # Read-length consistency.
    assert sum(l for op, l in ops if op in (0, 1, 4)) == sum(
        l for op, l in rec.cigar if op in (0, 1, 4)
    )
    # Reference-span consistency.
    assert (
        sum(l for op, l in ops if op in (0, 2))
        == rec.reference_end - rec.reference_start
    )
    out.cigar = ops
    return out


def realign_sam_file(
    sam_path: str,
    output_sam_path: str,
    read_fastq_path: str,
    reference_fasta_path: str,
    hmm: PairHmm,
    gap_gamma: float = 0.5,
    match_gamma: float = 0.0,
    no_chain: bool = False,
    band_width: int = DEFAULT_BAND_WIDTH,
    split_size: int = DEFAULT_SPLIT_SIZE,
) -> None:
    """Chain (optional) + realign a SAM file end to end."""
    from ..utils.seq import encode

    work_sam = sam_path
    tmp = None
    if not no_chain:
        tmp = tempfile.NamedTemporaryFile(
            mode="w", suffix=".sam", delete=False
        )
        tmp.close()
        chain_sam_file(
            sam_path, tmp.name, read_fastq_path, reference_fasta_path
        )
        work_sam = tmp.name

    try:
        sam = SamFile.read(work_sam)
        ref_sequences = get_fasta_dictionary(reference_fasta_path)
        jobs = _jobs_from_sam(sam, ref_sequences, encode)

        # Multi-host: strided job sharding + an all-gather of the
        # realigned records, so every host writes the identical merged
        # SAM.  The reference fanned realign chunks across jobTree
        # workers and re-zipped the per-chunk cigars
        # (src/margin/marginAlignLib.py:283-297, 320-367); here the
        # job list shards by stride and records gather by index.
        from ..parallel.runtime import allgather_host_objects

        nproc = jax.process_count()
        if nproc > 1:
            my_idx = list(range(jax.process_index(), len(jobs), nproc))
            my_jobs = [jobs[i] for i in my_idx]
        else:
            my_idx = list(range(len(jobs)))
            my_jobs = jobs
        all_ops = realigned_ops_for_jobs(my_jobs, hmm, gap_gamma,
                                         match_gamma, band_width,
                                         split_size=split_size)
        local = [
            (idx, splice_realigned_cigar(job.record, ops))
            for idx, job, ops in zip(my_idx, my_jobs, all_ops)
        ]
        if nproc > 1:
            merged = [p for shard in allgather_host_objects(local)
                      for p in shard]
            merged.sort(key=lambda t: t[0])
            realigned = [rec for _, rec in merged]
        else:
            realigned = [rec for _, rec in local]
        SamFile(sam.header, realigned).write(output_sam_path)
    finally:
        if tmp is not None:
            os.unlink(tmp.name)
