"""End-to-end marginAlign pipeline tests on the seeded fixtures."""
import os

import numpy as np
import pytest

from marginalign_trna_tpu.align.chain import chain_sam_file
from marginalign_trna_tpu.align.guide import GuideConfig, map_reads
from marginalign_trna_tpu.align.realign import realign_sam_file
from marginalign_trna_tpu.io.sam import SamFile
from marginalign_trna_tpu.models.hmm import PairHmm
from marginalign_trna_tpu.stats.stats import ReadAlignmentStats

MODEL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "marginalign_trna_tpu", "models", "last_hmm_20.txt",
)


@pytest.fixture(scope="module")
def guide_sam(fixtures_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("guide") / "guide.sam")
    map_reads(
        os.path.join(fixtures_dir, "lessReads.fq"),
        os.path.join(fixtures_dir, "references.fa"),
        out,
    )
    return out


def _stats(sam_path, fixtures_dir, reads="lessReads.fq"):
    return ReadAlignmentStats.get_read_alignment_stats(
        sam_path,
        os.path.join(fixtures_dir, reads),
        os.path.join(fixtures_dir, "references.fa"),
        global_alignment=True,
    )


def test_guide_alignment(guide_sam, fixtures_dir):
    sam = SamFile.read(guide_sam)
    assert len(sam.records) == 5  # all lessReads map
    # The stats constructor is assertion-dense: validity check, like the
    # reference's validateSam (tests/tests.py:52-60).
    stats = _stats(guide_sam, fixtures_dir)
    identity = np.mean([s.read_identity() for s in stats])
    assert identity > 0.75, identity


def test_chaining(guide_sam, fixtures_dir, tmp_path):
    out = str(tmp_path / "chained.sam")
    chain_sam_file(
        guide_sam, out,
        os.path.join(fixtures_dir, "lessReads.fq"),
        os.path.join(fixtures_dir, "references.fa"),
    )
    sam = SamFile.read(out)
    # One global alignment per (read, ref) pair; all reads single-ref here.
    assert len(sam.records) == 5
    for rec in sam.records:
        ops = set(op for op, _ in rec.cigar)
        assert 5 not in ops  # no hard clips after merging
    stats = _stats(out, fixtures_dir)
    assert len(stats) == 5


def test_realign_pipeline(guide_sam, fixtures_dir, tmp_path):
    out = str(tmp_path / "realigned.sam")
    hmm = PairHmm.load(MODEL)
    realign_sam_file(
        guide_sam, out,
        os.path.join(fixtures_dir, "lessReads.fq"),
        os.path.join(fixtures_dir, "references.fa"),
        hmm,
    )
    sam = SamFile.read(out)
    assert len(sam.records) == 5
    stats = _stats(out, fixtures_dir)
    identity = np.mean([s.read_identity() for s in stats])
    assert identity > 0.75, identity


def test_realign_no_chain(guide_sam, fixtures_dir, tmp_path):
    out = str(tmp_path / "realigned_nc.sam")
    hmm = PairHmm.load(MODEL)
    realign_sam_file(
        guide_sam, out,
        os.path.join(fixtures_dir, "lessReads.fq"),
        os.path.join(fixtures_dir, "references.fa"),
        hmm, no_chain=True,
    )
    assert len(SamFile.read(out).records) == 5
    _stats(out, fixtures_dir)


def test_chain_reference_input_sam(fixtures_dir, tmp_path):
    """Chain the bundled input.sam (reference-produced alignments)."""
    out = str(tmp_path / "chained.sam")
    chain_sam_file(
        os.path.join(fixtures_dir, "input.sam"), out,
        os.path.join(fixtures_dir, "reads.fq"),
        os.path.join(fixtures_dir, "references.fa"),
    )
    sam = SamFile.read(out)
    assert len(sam.records) == 2


def test_realign_reference_input_sam(fixtures_dir, tmp_path):
    """Realign reference-produced alignments: exercises hard-clip handling
    (input.sam records carry 6H/2H ops)."""
    out = str(tmp_path / "realigned.sam")
    hmm = PairHmm.load(MODEL)
    realign_sam_file(
        os.path.join(fixtures_dir, "input.sam"), out,
        os.path.join(fixtures_dir, "reads.fq"),
        os.path.join(fixtures_dir, "references.fa"),
        hmm, no_chain=True,
    )
    sam = SamFile.read(out)
    assert len(sam.records) == 2
    for rec in sam.records:
        # Hard clips preserved at the ends (realignSamFile3TargetFn).
        assert rec.cigar[0][0] == 5 or rec.cigar[-1][0] == 5


def test_one_call_api(fixtures_dir, tmp_path):
    """pipeline.align_and_call: full FASTQ -> SAM -> VCF in one call."""
    from marginalign_trna_tpu import pipeline

    out_sam = str(tmp_path / "api.sam")
    out_vcf = str(tmp_path / "api.vcf")
    calls = pipeline.align_and_call(
        os.path.join(fixtures_dir, "lessReads.fq"),
        os.path.join(fixtures_dir, "references.fa"),
        out_sam, out_vcf,
    )
    assert os.path.exists(out_sam) and os.path.exists(out_vcf)
    assert isinstance(calls, list)
    stats = _stats(out_sam, fixtures_dir)
    assert len(stats) == 5


def test_mapper_presets_distinct_and_beat_reference_mappers(fixtures_dir,
                                                            tmp_path):
    """The three mapper presets are behaviorally DISTINCT (different
    seeding + scoring: exact 13-mers / bwa-ont2d 8-mers + unit gaps +
    coverage floor / (15,10) minimizers + map-ont scores) and each
    matches the guide quality of the reads' TRUE alignments
    (inputBigMutations.sam), which any mapper's output stands in for."""
    reads = os.path.join(fixtures_dir, "reads.fq")
    ref = os.path.join(fixtures_dir, "referencesMutated.fa")

    def mean_stats(sam_path):
        stats = ReadAlignmentStats.get_read_alignment_stats(
            sam_path, reads, ref, global_alignment=True
        )
        return (
            len(stats),
            float(np.mean([s.alignment_identity() for s in stats])),
            float(np.mean([s.read_coverage() for s in stats])),
        )

    ours = {}
    texts = {}
    for preset in ("last", "bwa", "minimap2"):
        out = str(tmp_path / (preset + ".sam"))
        map_reads(reads, ref, out, GuideConfig.preset(preset))
        ours[preset] = mean_stats(out)
        texts[preset] = open(out).read()

    # Distinct behavior: no two presets emit the same alignments.
    assert texts["last"] != texts["bwa"]
    assert texts["last"] != texts["minimap2"]
    assert texts["bwa"] != texts["minimap2"]

    # Quality: identity AND coverage >= the true alignments' (CPU backend:
    # truth 0.4314 / 0.9707, presets 0.4335-0.4354 / 0.9713-0.9756; the
    # identity counts the unaligned reference ends as deletions).
    n_ref, id_ref, cov_ref = mean_stats(
        os.path.join(fixtures_dir, "inputBigMutations.sam")
    )
    for preset in ("last", "bwa", "minimap2"):
        n_our, id_our, cov_our = ours[preset]
        assert n_our >= n_ref, (preset, n_our, n_ref)
        assert id_our >= id_ref - 0.005, (preset, id_our, id_ref)
        assert cov_our >= cov_ref - 0.005, (preset, cov_our, cov_ref)

