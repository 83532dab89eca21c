"""I/O substrate tests against the seeded fixture files."""
import os

import numpy as np
import pytest

from marginalign_trna_tpu.io.cigar import ExonerateCigar, from_sam_record
from marginalign_trna_tpu.io.fasta import fasta_read, get_fasta_dictionary
from marginalign_trna_tpu.io.fastq import fastq_read, get_fastq_dictionary
from marginalign_trna_tpu.io.sam import SamFile, format_cigar, parse_cigar
from marginalign_trna_tpu.io.vcf import vcf_read, vcf_write
from marginalign_trna_tpu.utils.seq import encode, decode, reverse_complement


def test_fasta_read(fixtures_dir, fixture_facts):
    d = get_fasta_dictionary(os.path.join(fixtures_dir, "references.fa"))
    assert set(d) == {"DNA_CS", "M13"}
    assert len(d["DNA_CS"]) == fixture_facts["ref_lengths"]["DNA_CS"]
    assert len(d["M13"]) == fixture_facts["ref_lengths"]["M13"]


def test_fastq_read(fixtures_dir, fixture_facts):
    n = fixture_facts["n_reads"]
    reads = list(fastq_read(os.path.join(fixtures_dir, "reads.fq")))
    assert len(reads) == n
    lengths = [len(s) for _, s, _ in reads]
    assert min(lengths) == fixture_facts["min_read_len"]
    assert max(lengths) == fixture_facts["max_read_len"]
    d = get_fastq_dictionary(os.path.join(fixtures_dir, "reads.fq"))
    assert len(d) == n


def test_encode_decode():
    s = "ACGTNacgtn"
    codes = encode(s)
    assert list(codes) == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4]
    assert decode(codes[:5]) == "ACGTN"


def test_reverse_complement():
    assert reverse_complement("ACGT") == "ACGT"
    assert reverse_complement("AACG") == "CGTT"
    assert reverse_complement("acgN") == "Ncgt"


def test_cigar_roundtrip():
    ops = parse_cigar("6H11M3I16M1D6M2S")
    assert ops[0] == (5, 6) and ops[-1] == (4, 2)
    assert format_cigar(ops) == "6H11M3I16M1D6M2S"
    assert parse_cigar("*") == []


def test_sam_read(fixtures_dir, fixture_facts):
    sam = SamFile.read(os.path.join(fixtures_dir, "input.sam"))
    assert len(sam.records) == 2
    rec = sam.records[0]
    first = fixture_facts["input_sam_first"]
    assert rec.qname == first["qname"]
    assert rec.rname == first["rname"]
    assert rec.pos + 1 == first["pos1"]  # SAM text is 1-based
    text = open(os.path.join(fixtures_dir, "input.sam")).read()
    assert "\t%d\t" % first["pos1"] in text.splitlines()[2]
    assert rec.cigar[0] == (5, 6) and rec.cigar[-1] == (5, 2)
    assert not rec.is_reverse
    assert sam.reference_lengths() == fixture_facts["ref_lengths"]
    # CIGAR-derived coordinates must be internally consistent.
    ref_span = sum(l for op, l in rec.cigar if op in (0, 2))
    assert rec.reference_end - rec.reference_start == ref_span
    q_span = sum(l for op, l in rec.cigar if op in (0, 1))
    assert rec.query_alignment_end - rec.query_alignment_start == q_span


def test_sam_roundtrip(fixtures_dir, tmp_path):
    src = os.path.join(fixtures_dir, "input.sam")
    sam = SamFile.read(src)
    out = tmp_path / "out.sam"
    sam.write(str(out))
    orig = open(src).read()
    assert open(out).read() == orig


def test_aligned_pairs(fixtures_dir):
    sam = SamFile.read(os.path.join(fixtures_dir, "input.sam"))
    rec = sam.records[0]
    pairs = rec.aligned_pairs
    both = [(q, r) for q, r in pairs if q is not None and r is not None]
    n_match = sum(l for op, l in rec.cigar if op == 0)
    assert len(both) == n_match
    assert both[0][1] == rec.reference_start
    assert both[-1][1] == rec.reference_end - 1


def test_exonerate_cigar(fixtures_dir):
    sam = SamFile.read(os.path.join(fixtures_dir, "input.sam"))
    rec = sam.records[0]
    ec = from_sam_record(rec)
    line = ec.to_string()
    ec2 = ExonerateCigar.from_string(line)
    assert ec2.ops == ec.ops
    assert ec2.query_start == rec.query_alignment_start
    assert ec2.ref_start == rec.reference_start
    # Same assertion as the reference (utils.py:50-53): M ops == aligned pairs.
    n_match = sum(l for op, l in ec.ops if op == 0)
    both = [
        (q, r) for q, r in rec.aligned_pairs if q is not None and r is not None
    ]
    assert n_match == len(both)


def test_vcf_roundtrip(tmp_path):
    refs = {"chrA": "ACGTACGT", "chrB": "GGGG"}
    calls = [("chrA", 2, "T", 0.9), ("chrA", 2, "C", 0.4), ("chrB", 0, "A", 0.5)]
    path = str(tmp_path / "x.vcf")
    vcf_write("ref.fa", refs, calls, path)
    back = vcf_read(path)
    assert back == {("chrA", 3, "T"), ("chrA", 3, "C"), ("chrB", 1, "A")}
