"""Where the guide and realign stages spend their time on one GPU.

1,024 reads x 3.5 kb (benchmarks/e2e.make_corpus).  After a warm-up pass
that compiles everything, each stage runs twice as users run it (the
stage's wall time), then once with debug logging on, where the stage
timers inside the code (utils/obs.stage_timer, stage_sync) block after
every device step and report each piece: band packing, upload, NW or FB,
MEA weights, MEA DP, traceback, move pull and decode.  "other" is the
synced stage's wall time less its pieces (jobs, SAM and FASTA I/O, seeding
and chaining).  Prints the card's name and power limit, then one JSON line
per stage.

    python benchmarks/stage_profile.py
"""
import collections
import json
import logging
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))


class _Pieces(logging.Handler):
    """Sums the seconds of stage_timer records by stage name."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.seconds = collections.defaultdict(float)

    def emit(self, record):
        if hasattr(record, "stage"):
            self.seconds[record.stage] += record.seconds


def _wall(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main():
    from e2e import make_corpus
    from marginalign_trna_tpu.align.chain import chain_sam_file
    from marginalign_trna_tpu.align.guide import map_reads
    from marginalign_trna_tpu.align.realign import realign_sam_file
    from marginalign_trna_tpu.models.hmm import PairHmm
    from marginalign_trna_tpu.utils.compile_cache import (
        configure_compile_cache,
    )
    from marginalign_trna_tpu.utils.device import (
        card_name_and_power_limit, require_gpu,
    )
    from marginalign_trna_tpu.utils.obs import logger

    configure_compile_cache()
    require_gpu()
    print(card_name_and_power_limit(), flush=True)
    hmm = PairHmm.load(os.path.join(
        REPO, "marginalign_trna_tpu", "models", "last_hmm_20.txt"))
    with tempfile.TemporaryDirectory() as work:
        fq, ref = make_corpus(1024, 3500, work)
        guide, chained = work + "/g.sam", work + "/c.sam"
        out = work + "/r.sam"
        stages = {
            "guide": lambda: map_reads(fq, ref, guide),
            "realign": lambda: realign_sam_file(chained, out, fq, ref, hmm,
                                                no_chain=True),
        }
        map_reads(fq, ref, guide)
        chain_sam_file(guide, chained, fq, ref)
        realign_sam_file(chained, out, fq, ref, hmm, no_chain=True)
        for name, fn in stages.items():
            walls = [_wall(fn), _wall(fn)]
            pieces = _Pieces()
            logger.addHandler(pieces)
            logger.setLevel(logging.DEBUG)
            try:
                synced = _wall(fn)
            finally:
                logger.setLevel(logging.NOTSET)
                logger.removeHandler(pieces)
            secs = dict(pieces.seconds)
            secs["other"] = synced - sum(secs.values())
            print(json.dumps({
                "stage": name, "wall_s": walls, "synced_wall_s": synced,
                "pieces_s": secs,
                "share_of_synced": {k: v / synced for k, v in secs.items()},
            }), flush=True)


if __name__ == "__main__":
    main()
