"""Benchmark: banded pair-HMM forward-backward DP throughput on one GPU.

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device"}.

Metric: in-band DP cells per second for the full forward-backward with
posterior extraction (the marginAlign realign / marginCaller hot path, via
ops/dispatch.fb_posteriors) on a batch shaped like the end-to-end corpus
(reads ~3.5 kb vs refs ~3.5 kb, band width 21 = the reference's
--diagonalExpansion=10).  The batch is uploaded once; each timed call ends
in block_until_ready.

Baseline: the reference's cPecanRealign is single-threaded C scheduled 4-way
by jobTree (--maxThreads default 4, reference README.md:52).  BASELINE.md
estimates ~5e7 cells/s/core -> 2e8 cells/s for that configuration; no run
measured it.  vs_baseline = value / 2e8.

    python bench.py        # BENCH_READS=3072 BENCH_READ_LEN=3500 BENCH_REPS=3
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_CELLS_PER_SEC = 2.0e8


def main():
    import jax

    from __graft_entry__ import _example_batch
    from marginalign_trna_tpu.models.hmm import PairHmm
    from marginalign_trna_tpu.ops.dispatch import fb_posteriors
    from marginalign_trna_tpu.ops.fb import device_batch, make_tables
    from marginalign_trna_tpu.utils.compile_cache import (
        configure_compile_cache,
    )
    from marginalign_trna_tpu.utils.device import (
        card_name_and_power_limit, require_gpu,
    )

    configure_compile_cache()
    dev0 = require_gpu()
    print(card_name_and_power_limit(), flush=True)
    n_reads = int(os.environ.get("BENCH_READS", "3072"))
    read_len = int(os.environ.get("BENCH_READ_LEN", "3500"))
    reps = int(os.environ.get("BENCH_REPS", "3"))

    hmm = PairHmm.load(os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "marginalign_trna_tpu", "models", "last_hmm_20.txt",
    ))
    tables = make_tables(hmm)
    batch = _example_batch(n_reads, read_len, read_len, width=21, seed=1)
    cells = batch.dp_cells()
    dev = device_batch(batch)

    jax.block_until_ready(fb_posteriors(tables, dev))  # compile + warm up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fb_posteriors(tables, dev))
        times.append(time.perf_counter() - t0)
    value = cells / min(times)
    print(json.dumps({
        "metric": "banded_pairhmm_fb_cells_per_sec_per_device",
        "value": value,
        "unit": "DP cells/s (%d reads x %dbp, band 21)" % (n_reads, read_len),
        "vs_baseline": value / BASELINE_CELLS_PER_SEC,
        "device": {"platform": dev0.platform, "kind": dev0.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
