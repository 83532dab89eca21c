"""End-to-end production throughput: pipeline.align on the bench corpus.

bench.py measures the device-resident forward-backward; this measures what
a user gets from the marginAlign stages — guide mapping (host k-mer index +
chain + device Viterbi and traceback), chaining, banded FB + MEA decode and
traceback, and cigar splicing + SAM writing — on the same corpus shape
(reads ~3.5 kb vs a 3.5 kb reference, band 21).  make_corpus is also the
corpus chip_smoke.py runs.

Two passes: the first pays XLA compiles (shapes are ladder-quantized so
they cache), the second is the steady-state number.  Prints one JSON line
per pass with total reads/s and per-stage seconds.

    python benchmarks/e2e.py            # N=1024 reads
    E2E_READS=256 python benchmarks/e2e.py
    JAX_PLATFORMS=cpu E2E_READS=8 E2E_READ_LEN=300 python benchmarks/e2e.py
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_corpus(n_reads, read_len, tmpdir, seed=7):
    """Reference FASTA + noisy-read FASTQ (10% sub / 5% del / 5% ins,
    the __graft_entry__ noise model)."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    ref = rng.integers(0, 4, size=read_len + 64)
    ref_path = os.path.join(tmpdir, "ref.fa")
    with open(ref_path, "w") as fh:
        fh.write(">bench_ref\n")
        fh.write("".join(bases[ref]) + "\n")

    fq_path = os.path.join(tmpdir, "reads.fq")
    with open(fq_path, "w") as fh:
        for idx in range(n_reads):
            start = int(rng.integers(0, 48))
            read = ref[start : start + read_len].copy()
            subs = rng.random(len(read)) < 0.10
            read[subs] = rng.integers(0, 4, size=int(subs.sum()))
            keep = rng.random(len(read)) >= 0.05
            read = read[keep]
            ins = np.flatnonzero(rng.random(len(read)) < 0.05)
            if len(ins):
                read = np.insert(
                    read, ins + 1, rng.integers(0, 4, size=len(ins))
                )
            seq = "".join(bases[read])
            fh.write("@r%d\n%s\n+\n%s\n" % (idx, seq, "I" * len(seq)))
    return fq_path, ref_path


def run_pass(fq, ref, tmpdir, tag):
    from marginalign_trna_tpu.align.chain import chain_sam_file
    from marginalign_trna_tpu.align.guide import GuideConfig, map_reads
    from marginalign_trna_tpu.align.realign import realign_sam_file
    from marginalign_trna_tpu.models.hmm import PairHmm

    hmm = PairHmm.load(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "marginalign_trna_tpu", "models", "last_hmm_20.txt",
    ))
    guide_sam = os.path.join(tmpdir, "guide_%s.sam" % tag)
    chained_sam = os.path.join(tmpdir, "chained_%s.sam" % tag)
    out_sam = os.path.join(tmpdir, "out_%s.sam" % tag)

    stages = {}
    t0 = time.perf_counter()
    map_reads(fq, ref, guide_sam, GuideConfig())
    stages["guide_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    chain_sam_file(guide_sam, chained_sam, fq, ref)
    stages["chain_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    realign_sam_file(chained_sam, out_sam, fq, ref, hmm, no_chain=True)
    stages["realign_s"] = time.perf_counter() - t0

    n_out = sum(
        1 for ln in open(out_sam) if ln.strip() and not ln.startswith("@")
    )
    total = sum(stages.values())
    return {
        "pass": tag,
        "reads_out": n_out,
        "reads_per_sec": n_out / total,
        "total_s": round(total, 3),
        **{k: round(v, 3) for k, v in stages.items()},
    }


def main():
    from marginalign_trna_tpu.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    n_reads = int(os.environ.get("E2E_READS", "1024"))
    read_len = int(os.environ.get("E2E_READ_LEN", "3500"))
    with tempfile.TemporaryDirectory() as tmpdir:
        fq, ref = make_corpus(n_reads, read_len, tmpdir)
        print(json.dumps(run_pass(fq, ref, tmpdir, "cold")), flush=True)
        print(json.dumps(run_pass(fq, ref, tmpdir, "warm")), flush=True)


if __name__ == "__main__":
    main()
