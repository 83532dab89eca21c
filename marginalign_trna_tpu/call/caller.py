"""marginCaller: posterior-expectation SNV calling.

Behavioural equivalent of src/margin/marginCallerLib.py: accumulate, for
every reference position, the expected count of each read base (weighted by
pair-HMM posterior match probability, or 1.0 in --noMargin mode), then
Bayes-invert through the HMM's error substitution matrix and emit VCF for
non-reference bases above the posterior threshold.

Device shape: expectations live in dense [ref_len, 4] float arrays per
reference sequence (the psum-able representation replacing the reference's
pickled per-chunk dicts, marginCallerLib.py:171-187); the per-read posterior
computation reuses the banded FB engine batched over all reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.fasta import get_fasta_dictionary
from ..io.sam import SamFile
from ..io.vcf import vcf_read, vcf_write
from ..models.hmm import PairHmm
from ..align.realign import _bucket_jobs, _jobs_from_sam
from ..ops.band import pack_banded_batch
from ..ops.dispatch import fb_posteriors, max_batch_cells_for
from ..ops.expectations import add_lane_expectations, lane_expectations
from ..ops.fb import device_batch, make_tables
from ..parallel.runtime import local_dispatch_devices
from ..utils.seq import BASES, encode

DEFAULT_THRESHOLD = 0.3  # src/margin/marginCaller.py:28-30
CALLER_BAND_WIDTH = 21   # diagonalExpansion=10 (marginCallerLib.py:54)


@dataclass
class CallerOptions:
    threshold: float = DEFAULT_THRESHOLD
    no_margin: bool = False
    band_width: int = CALLER_BAND_WIDTH
    # Padded DP cells per device batch; None = sized from device memory
    # (dispatch.max_batch_cells_for("caller")).
    max_batch_cells: Optional[int] = None
    # Reference caller-path --splitMatrixBiggerThanThis=100
    # (src/margin/marginCallerLib.py:55); 0 disables splitting.
    split_size: int = 100


def accumulate_expectations(
    sam: SamFile,
    ref_sequences: Dict[str, str],
    alignment_hmm: Optional[PairHmm],
    options: CallerOptions,
) -> Dict[str, np.ndarray]:
    """-> {ref_name: [ref_len, 4] expected base counts}."""
    expectations = {
        name: np.zeros((len(seq), 4)) for name, seq in ref_sequences.items()
    }
    if options.no_margin:
        # Weight 1.0 per aligned pair of the input alignment
        # (marginCallerLib.py:69 with --rescoreOriginalAlignment).  The
        # reference still runs a cPecanRealign rescore pass in this mode
        # and then discards its posteriors; that pass is intentionally
        # elided here — output-equivalent, since only the weight-1.0
        # pairs reach the expectations.
        for rec in sam.mapped():
            exp = expectations[rec.rname]
            seq = rec.query_sequence
            for qpos, rpos in rec.aligned_pairs:
                if qpos is None or rpos is None:
                    continue
                code = int(encode(seq[qpos])[0])
                if code < 4 and rpos < exp.shape[0]:
                    exp[rpos, code] += 1.0
        return expectations

    jobs = _jobs_from_sam(sam, ref_sequences, encode)
    # Anchor splitting (reference --splitMatrixBiggerThanThis): segment
    # offsets shift by the segment's ref start inside its job.
    job_ref_off = [0] * len(jobs)
    if options.split_size and options.split_size > 0:
        from ..align.realign import split_jobs_at_anchors

        segs, origin, seg_starts = split_jobs_at_anchors(
            jobs, options.split_size
        )
        jobs = segs
        job_ref_off = [st[1] for st in seg_starts]
    tables = make_tables(alignment_hmm)
    max_batch_cells = options.max_batch_cells
    if max_batch_cells is None:
        max_batch_cells = max_batch_cells_for("caller")

    # Global coordinate space: all references concatenated, so one dense
    # [total_ref_len, 4] array takes every lane's window regardless of
    # which reference it aligns to (see ops/expectations.py).
    ref_names = list(ref_sequences.keys())
    global_off = {}
    total = 0
    for name in ref_names:
        global_off[name] = total
        total += len(ref_sequences[name])
    exp_global = np.zeros((total, 4))

    # Buckets are dispatched a few deep before each host sync; the window
    # is bounded because each in-flight call pins its bucket's device
    # input streams.  The per-bucket result is the [4, max n, lanes] lane
    # windows, added into exp_global on the host in dispatch order.
    # Committed inputs round-robin buckets across local devices.
    devices = local_dispatch_devices()
    pipeline_depth = max(8, 2 * len(devices))
    pending = []  # (device result, batch, offsets, n_real), dispatch order

    def _drain_one():
        local, b, off, n_real = pending.pop(0)
        add_lane_expectations(exp_global, local, b, off, n_real)

    for bi, bucket in enumerate(_bucket_jobs(jobs, options.band_width,
                                             max_batch_cells)):
        batch = pack_banded_batch(
            [jobs[i].read_region for i in bucket],
            [jobs[i].ref_region for i in bucket],
            width=options.band_width,
            paths=[jobs[i].path for i in bucket],
            quantize=True,
        )
        offsets = np.zeros(batch.batch, dtype=np.int64)
        for local_b, job_idx in enumerate(bucket):
            rec = jobs[job_idx].record
            offsets[local_b] = (global_off[rec.rname] + rec.reference_start
                                + job_ref_off[job_idx])
        # The posterior band stays on device; only the lane windows cross
        # to the host.
        dev = device_batch(batch, devices[bi % len(devices)])
        _, post_dev = fb_posteriors(tables, dev)
        local = lane_expectations(post_dev, batch, len(bucket), dev=dev)
        pending.append((local, batch, offsets, len(bucket)))
        if len(pending) >= pipeline_depth:
            _drain_one()
    while pending:
        _drain_one()
    for name in ref_names:
        off = global_off[name]
        expectations[name] += exp_global[off : off + len(ref_sequences[name])]
    return expectations


def calc_base_posterior_probs(
    base_observations: np.ndarray,  # [4] normalised expected counts
    ref_base: str,
    error_sub_matrix: np.ndarray,   # [4, 4] P(obs | true)
    evo_sub_matrix: Optional[np.ndarray] = None,  # [4, 4] prior (default null)
) -> np.ndarray:
    """Log-space Bayes with log-sum-exp normalisation
    (reference: calcBasePosteriorProbs, marginCallerLib.py:81-91)."""
    if evo_sub_matrix is None:
        evo_sub_matrix = np.ones((4, 4))
    rb = BASES.find(ref_base.upper())
    prior = evo_sub_matrix[rb] if rb >= 0 else np.ones(4)
    logp = np.log(prior) + (
        np.log(np.maximum(error_sub_matrix, 1e-300)) @ base_observations
    )
    logp -= logp.max()
    p = np.exp(logp)
    return p / p.sum()


def call_variants(
    expectations: Dict[str, np.ndarray],
    ref_sequences: Dict[str, str],
    error_hmm: PairHmm,
    threshold: float,
) -> List[Tuple[str, int, str, float]]:
    """-> [(ref_name, 0-based pos, alt base, posterior prob)]"""
    error_matrix = error_hmm.substitution_matrix()
    calls: List[Tuple[str, int, str, float]] = []
    for ref_name, exp in expectations.items():
        seq = ref_sequences[ref_name]
        covered = np.where(exp.sum(axis=1) > 0)[0]
        for pos in covered:
            total = exp[pos].sum()
            probs = calc_base_posterior_probs(
                exp[pos] / total, seq[pos], error_matrix
            )
            for bi, base in enumerate(BASES):
                if base != seq[pos] and probs[bi] >= threshold:
                    calls.append((ref_name, int(pos), base, float(probs[bi])))
    return calls


def margin_caller(
    sam_path: str,
    reference_fasta_path: str,
    output_vcf_path: str,
    alignment_model: PairHmm,
    error_model: PairHmm,
    options: Optional[CallerOptions] = None,
) -> List[Tuple[str, int, str, float]]:
    """Full marginCaller pipeline (reference: marginCallerTargetFn +
    variantCallSamFileTargetFn, marginCallerLib.py:15-222)."""
    options = options or CallerOptions()
    sam = SamFile.read(sam_path)
    ref_sequences = get_fasta_dictionary(reference_fasta_path)

    # Multi-host: strided record sharding + all-reduced expectation tensors
    # (single-process: no-ops).  Replaces the reference's per-chunk pickle
    # merge (marginCallerLib.py:179-187).
    from ..parallel.runtime import allreduce_sum_host, shard_for_host

    sam.records = shard_for_host(sam.records)
    expectations = accumulate_expectations(
        sam, ref_sequences, alignment_model, options
    )
    import jax

    if jax.process_count() > 1:
        expectations = {
            name: allreduce_sum_host(exp)
            for name, exp in expectations.items()
        }
    calls = call_variants(
        expectations, ref_sequences, error_model, options.threshold
    )
    vcf_write(reference_fasta_path, ref_sequences, calls, output_vcf_path)
    # Round-trip self-check, like the reference (marginCallerLib.py:219-222).
    vcf_calls = vcf_read(output_vcf_path)
    expected = {(c[0], c[1] + 1, c[2]) for c in calls}
    assert vcf_calls == expected
    return calls
