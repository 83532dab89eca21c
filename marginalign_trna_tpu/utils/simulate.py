"""Seeded nanopore-like read simulation with the true alignment.

Test and smoke corpora are generated, not shipped: a read is a noisy copy
of a reference window (substitutions, deletions, insertions), and the edit
script doubles as its true alignment, so a SAM of true alignments comes
with every corpus.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..io.sam import SamRecord
from ..utils.seq import BASES, decode, reverse_complement


def random_sequence(length: int, rng: np.random.Generator) -> str:
    return decode(rng.integers(0, 4, size=length).astype(np.int8))


def noisy_copy(
    template: np.ndarray,
    rng: np.random.Generator,
    sub: float = 0.05,
    dele: float = 0.03,
    ins: float = 0.03,
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """(read codes, ops) for a noisy copy of template codes: each template
    base is deleted with probability dele, else copied (and substituted
    with probability sub); an insertion of one random base follows it with
    probability ins.  ops are run-length (op, len) with 0=M, 1=I, 2=D
    relative to the template."""
    L = len(template)
    deleted = rng.random(L) < dele
    subs = rng.random(L) < sub
    inserted = rng.random(L) < ins
    copied = np.where(subs, (template + rng.integers(1, 4, size=L)) % 4,
                      template).astype(np.int8)
    # Two slots per template base: (M or D, optional I).
    op = np.stack([np.where(deleted, 2, 0), np.where(inserted, 1, -1)], 1)
    base = np.stack([copied, rng.integers(0, 4, size=L).astype(np.int8)], 1)
    op, base = op.reshape(-1), base.reshape(-1)
    keep = op >= 0
    op, base = op[keep], base[keep]
    read = base[op != 2].astype(np.int8)
    cuts = np.flatnonzero(np.diff(op)) + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [len(op)]])
    ops = [(int(op[s]), int(e - s)) for s, e in zip(starts, ends)]
    return read, ops


def true_alignment_record(
    name: str, ref_name: str, start: int, read: str,
    ops: List[Tuple[int, int]], reverse: bool = False,
) -> SamRecord:
    """SAM record of a simulated read's true alignment (read given in
    reference orientation).  Edge deletions move or end the alignment and
    edge insertions become soft clips."""
    ops = list(ops)
    while ops and ops[0][0] == 2:
        start += ops.pop(0)[1]
    while ops and ops[-1][0] == 2:
        ops.pop()
    if ops and ops[0][0] == 1:
        ops[0] = (4, ops[0][1])
    if ops and ops[-1][0] == 1:
        ops[-1] = (4, ops[-1][1])
    return SamRecord(
        qname=name, flag=16 if reverse else 0, rname=ref_name, pos=start,
        mapq=60, cigar=ops, seq=read, qual="*",
    )


def simulate_reads(
    refs: dict, n_reads: int, min_len: int, max_len: int,
    rng: np.random.Generator, reverse_fraction: float = 0.3, **noise,
):
    """[(name, fastq sequence, SamRecord of the true alignment)] for reads
    drawn uniformly over the references (noise: noisy_copy rates).  A
    reverse read's FASTQ sequence is the reverse complement of its SAM SEQ,
    as a mapper would report it."""
    from ..utils.seq import encode

    names = list(refs)
    out = []
    for idx in range(n_reads):
        ref_name = names[idx % len(names)]
        ref = refs[ref_name]
        length = int(rng.integers(min_len, max_len + 1))
        length = min(length, len(ref))
        start = int(rng.integers(0, len(ref) - length + 1))
        codes, ops = noisy_copy(encode(ref[start : start + length]), rng,
                                **noise)
        fwd = "".join(BASES[c] for c in codes)
        reverse = bool(rng.random() < reverse_fraction)
        rec = true_alignment_record("read_%d" % idx, ref_name, start, fwd,
                                    ops, reverse)
        out.append((rec.qname, reverse_complement(fwd) if reverse else fwd,
                    rec))
    return out
