"""Aux tool tests: BAM/2bit writers, substitutions, kmers, mutation, hub."""
import gzip
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from marginalign_trna_tpu.io.bam import sam_to_bam_file
from marginalign_trna_tpu.io.fasta import get_fasta_dictionary
from marginalign_trna_tpu.io.sam import SamFile
from marginalign_trna_tpu.io.twobit import read_2bit_names_and_sizes, write_2bit
from marginalign_trna_tpu.tools.assembly_hub import create_assembly_hub
from marginalign_trna_tpu.tools.kmer import count_kmers, write_kmer_table
from marginalign_trna_tpu.tools.substitutions import (
    substitution_matrix_from_sam,
)
from marginalign_trna_tpu.utils.mutate import mutate_sequences

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read_bam_raw(path):
    """Decompress BGZF (gzip multi-member) and parse minimal BAM."""
    data = gzip.open(path, "rb").read()
    assert data[:4] == b"BAM\x01"
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        name = data[off : off + l_name - 1].decode()
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        refs.append((name, l_ref))
    records = []
    while off < len(data):
        (block_size,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_id, pos = struct.unpack_from("<ii", data, off)
        records.append((ref_id, pos))
        off += block_size
    return refs, records


def test_bam_writer_roundtrip(fixtures_dir, fixture_facts, tmp_path):
    sam_path = os.path.join(fixtures_dir, "input.sam")
    bam = str(tmp_path / "out.bam")
    sam_to_bam_file(sam_path, bam, sort=True, index=True)
    refs, records = _read_bam_raw(bam)
    assert refs == list(fixture_facts["ref_lengths"].items())
    sam = SamFile.read(sam_path)
    assert len(records) == len(sam.records)
    # Sorted by (ref, pos).
    assert records == sorted(records)
    assert os.path.exists(bam + ".bai")
    with open(bam + ".bai", "rb") as fh:
        assert fh.read(4) == b"BAI\x01"


def test_twobit_roundtrip(tmp_path):
    seqs = {"a": "ACGTACGTNNNacgt", "b": "TTTT"}
    path = str(tmp_path / "x.2bit")
    write_2bit(seqs, path)
    sizes = read_2bit_names_and_sizes(path)
    assert sizes == {"a": 15, "b": 4}


def test_substitution_matrix(fixtures_dir):
    m = substitution_matrix_from_sam(
        os.path.join(fixtures_dir, "input.sam"),
        os.path.join(fixtures_dir, "reads.fq"),
        os.path.join(fixtures_dir, "references.fa"),
    )
    assert m.matrix.sum() > 0
    assert 0.5 < m.identity() <= 1.0
    xml = m.to_xml()
    assert xml.tag == "substitutions"


def test_kmer_counts(fixtures_dir, fixture_facts, tmp_path):
    ref_k, read_k = count_kmers(
        5,
        os.path.join(fixtures_dir, "references.fa"),
        os.path.join(fixtures_dir, "lessReads.fq"),
    )
    assert sum(ref_k.values()) == sum(
        n - 4 for n in fixture_facts["ref_lengths"].values()
    )
    out = str(tmp_path / "kmers.txt")
    write_kmer_table(ref_k, read_k, out)
    lines = open(out).read().splitlines()
    assert len(lines) == 4**5 + 1


def test_mutate_sequences():
    seqs = {"s": "ACGT" * 100}
    mutated, muts = mutate_sequences(seqs, snp_rate=0.2, seed=1)
    assert len(muts) > 40
    for name, pos, ref, alt in muts:
        assert seqs[name][pos] == ref
        assert mutated[name][pos] == alt
        assert ref != alt
    # Determinism.
    mutated2, muts2 = mutate_sequences(seqs, snp_rate=0.2, seed=1)
    assert muts == muts2


def test_assembly_hub(fixtures_dir, fixture_facts, tmp_path):
    path = create_assembly_hub(
        os.path.join(fixtures_dir, "input.sam"),
        os.path.join(fixtures_dir, "references.fa"),
        str(tmp_path),
        hub_tag="testhub",
    )
    assert os.path.exists(os.path.join(path, "hub.txt"))
    assert os.path.exists(os.path.join(path, "genomes.txt"))
    ref_dir = os.path.join(path, "references")
    assert os.path.exists(os.path.join(ref_dir, "trackDb.txt"))
    assert os.path.exists(os.path.join(ref_dir, "references.2bit"))
    bams = os.listdir(os.path.join(ref_dir, "bamFiles"))
    assert any(b.endswith(".sorted.bam") for b in bams)
    assert any(b.endswith(".bai") for b in bams)
    sizes = read_2bit_names_and_sizes(
        os.path.join(ref_dir, "references.2bit")
    )
    assert sizes == fixture_facts["ref_lengths"]


def test_script_launchers_run(fixtures_dir, fixture_facts, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out_fq = str(tmp_path / "u.fq")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "uniquifyFastq"),
         os.path.join(fixtures_dir, "lessReads.fq"), out_fq],
        capture_output=True, env=env,
    )
    assert r.returncode == 0, r.stderr
    assert os.path.exists(out_fq)

    out_fa = str(tmp_path / "mut.fa")
    out_muts = str(tmp_path / "muts.txt")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "mutateReference"),
         os.path.join(fixtures_dir, "references.fa"), out_fa, out_muts,
         "--snpRate", "0.1"],
        capture_output=True, env=env,
    )
    assert r.returncode == 0, r.stderr
    n_muts = len(open(out_muts).read().splitlines())
    total = sum(fixture_facts["ref_lengths"].values())
    assert 0.07 * total < n_muts < 0.14 * total  # ~10% of the references
