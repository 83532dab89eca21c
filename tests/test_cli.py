"""CLI-level tests mirroring the reference's test matrix (tests/tests.py):
marginAlign flag combinations, mapper presets, marginCaller modes,
marginStats.  Long variants (full reads.fq, EM defaults) gate on
MARGINALIGN_LONG_TESTS=1, like the reference's --longTests."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LONG = os.environ.get("MARGINALIGN_LONG_TESTS") == "1"


def _run(cmd, **kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(cmd, capture_output=True, env=env, text=True, **kw)
    assert r.returncode == 0, (cmd, r.stderr[-2000:])
    return r


def _validate_sam(sam_path, fastq, fixtures_dir):
    from marginalign_trna_tpu.stats.stats import ReadAlignmentStats

    stats = ReadAlignmentStats.get_read_alignment_stats(
        sam_path, os.path.join(fixtures_dir, fastq),
        os.path.join(fixtures_dir, "references.fa"), True,
    )
    assert stats
    return float(np.mean([s.read_identity() for s in stats]))


@pytest.mark.parametrize("extra,name", [
    ([], "defaults"),
    (["--noChain"], "nochain"),
    (["--noRealign"], "norealign"),
    (["--noRealign", "--noChain"], "raw"),
    (["--bwa", "--noRealign"], "bwa"),
    (["--minimap2", "--noRealign"], "mm2"),
    (["--inputModel",
      os.path.join(REPO, "marginalign_trna_tpu/models/last_hmm_0.txt")],
     "custommodel"),
])
def test_margin_align_cli_matrix(fixtures_dir, tmp_path, extra, name):
    out = str(tmp_path / ("%s.sam" % name))
    _run([sys.executable, os.path.join(REPO, "marginAlign"),
          os.path.join(fixtures_dir, "lessReads.fq"),
          os.path.join(fixtures_dir, "references.fa"),
          out, "--jobTree", str(tmp_path / "jt")] + extra)
    identity = _validate_sam(out, "lessReads.fq", fixtures_dir)
    assert identity > 0.7, (name, identity)


def test_margin_align_cli_em(fixtures_dir, tmp_path):
    out = str(tmp_path / "em.sam")
    model = str(tmp_path / "em.hmm")
    _run([sys.executable, os.path.join(REPO, "marginAlign"),
          os.path.join(fixtures_dir, "lessReads.fq"),
          os.path.join(fixtures_dir, "references.fa"),
          out, "--em", "--outputModel", model,
          "--trials", "1", "--iterations", "3",
          "--useDefaultModelAsStart", "--updateTheBand"])
    from marginalign_trna_tpu.models.hmm import PairHmm

    PairHmm.load(model).check()  # reference checkHmm equivalent
    # outputTrialHmms defaults ON like the reference (marginAlign.py:43).
    PairHmm.load(model + ".trial0").check()
    _validate_sam(out, "lessReads.fq", fixtures_dir)


def test_margin_align_cli_em_no_trial_hmms(fixtures_dir, tmp_path):
    out = str(tmp_path / "em2.sam")
    model = str(tmp_path / "em2.hmm")
    _run([sys.executable, os.path.join(REPO, "marginAlign"),
          os.path.join(fixtures_dir, "lessReads.fq"),
          os.path.join(fixtures_dir, "references.fa"),
          out, "--em", "--outputModel", model,
          "--trials", "1", "--iterations", "2", "--noOutputTrialHmms"])
    assert os.path.exists(model)
    assert not os.path.exists(model + ".trial0")


@pytest.mark.skipif(not LONG, reason="set MARGINALIGN_LONG_TESTS=1")
def test_long_full_reads_em_and_call(fixtures_dir, tmp_path):
    """The reference's integrative long test shape (tests/tests.py:189-209):
    EM-train on the full read set against the mutated reference, call
    variants with the trained model, modifyHmm, call again."""
    out = str(tmp_path / "full.sam")
    model = str(tmp_path / "full.hmm")
    _run([sys.executable, os.path.join(REPO, "marginAlign"),
          os.path.join(fixtures_dir, "reads.fq"),
          os.path.join(fixtures_dir, "referencesMutated.fa"),
          out, "--em", "--outputModel", model,
          "--trials", "2", "--iterations", "10"])
    vcf = str(tmp_path / "full.vcf")
    _run([sys.executable, os.path.join(REPO, "marginCaller"),
          out, os.path.join(fixtures_dir, "referencesMutated.fa"), vcf,
          "--alignmentModel", model, "--errorModel", model])
    _run([sys.executable, os.path.join(REPO, "scripts", "modifyHmm"),
          model, model, "--gcContent=0.5", "--substitutionRate=0.2",
          "--setFlatIndelEmissions"])
    vcf2 = str(tmp_path / "full2.vcf")
    _run([sys.executable, os.path.join(REPO, "marginCaller"),
          out, os.path.join(fixtures_dir, "referencesMutated.fa"), vcf2,
          "--alignmentModel", model, "--errorModel", model])
    from marginalign_trna_tpu.io.vcf import vcf_read

    assert vcf_read(vcf) and vcf_read(vcf2)
