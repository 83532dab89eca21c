"""Seeded test corpus: everything the tests read, generated into a directory.

Two random references (named like the reference distribution's fixtures,
shorter), reads simulated from them with their true alignments, a
SNP-mutated copy of the references with its mutation list, and SAM files of
true alignments:

  references.fa          DNA_CS, M13
  reads.fq               N_READS reads (some reverse strand)
  lessReads.fq           the first LESS_READS of them
  referencesMutated.fa   references with SNPs at SNP_RATE
  mutations.txt          name, 0-based pos, original base, mutated base
  inputBigMutations.sam  true alignments of reads.fq (against either
                         reference set: SNPs leave the cigars unchanged)
  input.sam              two forward reads' true alignments, hard-clipped
                         6H ... 2H
  facts.json             the numbers tests assert on
"""
from __future__ import annotations

import json
import os

import numpy as np

from marginalign_trna_tpu.io.fasta import write_fasta_file
from marginalign_trna_tpu.io.sam import SamFile, SamRecord, make_header
from marginalign_trna_tpu.utils.mutate import mutate_sequences
from marginalign_trna_tpu.utils.simulate import random_sequence, simulate_reads

SEED = 20151016
REF_LENGTHS = {"DNA_CS": 1500, "M13": 2400}
N_READS = 16
LESS_READS = 5
READ_LENGTHS = (300, 1400)
SNP_RATE = 0.02


def hard_clip(rec: SamRecord, head: int, tail: int) -> SamRecord:
    """rec with `head` leading and `tail` trailing read bases hard-clipped
    (rec has no clips; deletions next to a cut are dropped)."""

    def cut_front(ops, n, pos):
        out = list(ops)
        while out and (n > 0 or out[0][0] == 2):
            op, ln = out.pop(0)
            if op == 2:
                pos += ln
                continue
            take = min(ln, n)
            n -= take
            if op == 0:
                pos += take
            if ln > take:
                out.insert(0, (op, ln - take))
        return out, pos

    ops, pos = cut_front(rec.cigar, head, rec.pos)
    rev, _ = cut_front(list(reversed(ops)), tail, 0)
    out = rec.copy()
    out.pos = pos
    out.cigar = [(5, head)] + list(reversed(rev)) + [(5, tail)]
    out.seq = rec.seq[head : len(rec.seq) - tail]
    return out


def write_fixtures(path: str, seed: int = SEED) -> dict:
    rng = np.random.default_rng(seed)
    refs = {name: random_sequence(n, rng) for name, n in REF_LENGTHS.items()}
    header = make_header(list(REF_LENGTHS.items()))
    write_fasta_file(os.path.join(path, "references.fa"), refs.items())
    mutated, muts = mutate_sequences(refs, SNP_RATE, seed=seed)
    write_fasta_file(os.path.join(path, "referencesMutated.fa"),
                     mutated.items())
    with open(os.path.join(path, "mutations.txt"), "w") as fh:
        for name, pos, orig, alt in muts:
            fh.write("%s\t%d\t%s\t%s\n" % (name, pos, orig, alt))

    reads = simulate_reads(refs, N_READS, *READ_LENGTHS, rng)
    for fname, subset in (("reads.fq", reads),
                          ("lessReads.fq", reads[:LESS_READS])):
        with open(os.path.join(path, fname), "w") as fh:
            for name, seq, _ in subset:
                fh.write("@%s\n%s\n+\n%s\n" % (name, seq, "I" * len(seq)))
    SamFile(header, [rec for _, _, rec in reads]).write(
        os.path.join(path, "inputBigMutations.sam"))
    forward = [rec for _, _, rec in reads if not rec.is_reverse][:2]
    clipped = [hard_clip(rec, 6, 2) for rec in forward]
    SamFile(header, clipped).write(os.path.join(path, "input.sam"))

    lengths = [len(seq) for _, seq, _ in reads]
    facts = {
        "ref_lengths": REF_LENGTHS,
        "n_reads": N_READS,
        "less_reads": LESS_READS,
        "min_read_len": min(lengths),
        "max_read_len": max(lengths),
        "n_mutations": len(muts),
        "input_sam_first": {
            "qname": clipped[0].qname, "rname": clipped[0].rname,
            "pos1": clipped[0].pos + 1,
        },
    }
    with open(os.path.join(path, "facts.json"), "w") as fh:
        json.dump(facts, fh)
    return facts


if __name__ == "__main__":
    import sys

    print(write_fixtures(sys.argv[1]))
