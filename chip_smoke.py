"""Chip smoke test: marginAlign, marginCaller and EM on one GPU.

Drives the system's main path once, in ONE process (a second JAX process
on the card would fail for want of memory), at the end-to-end size: reads
~3.5 kb on a 3.5 kb reference, band 21, guide band 40.  Phases, each
printing one line with its numbers and time:

  1. device      the first JAX device must be a GPU; card name + power limit
  2. compile     the FB engine at 3,072 lanes x 3.5 kb and the guide NW
                 at 1,024 lanes x width 40, with memory_analysis(); the
                 realign FB and the three-trial E-step at the largest
                 buckets the device budgets admit, each held to its
                 bytes per cell
  3. reference   the FB engine on the GPU vs the same engine on the CPU
                 backend (posterior atol 2e-4, logZ rtol 1e-5), guide NW
                 and MEA decode exact
  4. marginAlign 1,024 reads through the CLI entry; 64 re-run on the CPU
  5. caller      a mutated 7.3 kb reference at >= 100x depth: precision /
                 recall against the known mutations
  6. EM          --em (the CLI's 3 lockstep trials) for 3 iterations on
                 the phase-4 corpus: every trial's likelihood monotone,
                 the trained model loads

The last line is {"ok": true, "device": {...}}.  Any failed phase exits
non-zero before it.  `--devices 4` runs only the multi-device path
(realign, caller and EM E-step round-robined over 4 local devices, and
the psum EM train step on a 4-device mesh), each against a one-device run
of the same inputs.  `--rehearse` runs every phase at a tiny size and
accepts the CPU backend (the CPU tests use it).

    python chip_smoke.py
    python chip_smoke.py --devices 4
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse
"""
import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

import numpy as np  # noqa: E402

from e2e import make_corpus  # noqa: E402
from marginalign_trna_tpu.utils.compile_cache import (  # noqa: E402
    configure_compile_cache,
)

MODEL = os.path.join(REPO, "marginalign_trna_tpu", "models",
                     "last_hmm_20.txt")
POST_ATOL = 2e-4   # the tests' engine-vs-engine posterior tolerance
LOGZ_RTOL = 1e-5
# Sizes.  caller_min_*: phase 5 floors, set from the same corpus run on
# the CPU backend, less the margin stated beside each.
# CPU: precision 0.915 (54 of 59 calls; the 5 false calls sit in the last
# 50 bases, where coverage thins), recall 1.0; margins 0.065 and 0.05.
FULL = dict(compile_lanes=3072, guide_lanes=1024, check_lanes=64,
            budget_lanes=None,
            reads=1024, read_len=3500, cpu_reads=64,
            caller_ref=7300, caller_depth=100, caller_read_len=(1500, 2500),
            caller_min_precision=0.85, caller_min_recall=0.95,
            em_iterations=3, multi_reads=64)
# CPU: precision 0.556 (5 of 9 calls), recall 1.0; margin ~0.15.
TINY = dict(compile_lanes=8, guide_lanes=8, check_lanes=4, budget_lanes=8,
            reads=12, read_len=400, cpu_reads=4,
            caller_ref=600, caller_depth=20, caller_read_len=(200, 400),
            caller_min_precision=0.4, caller_min_recall=0.8,
            em_iterations=2, multi_reads=12)


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def line(phase, t0, **kw):
    kw = {"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
          **kw}
    print(json.dumps(kw, default=str), flush=True)


def load_hmm():
    from marginalign_trna_tpu.models.hmm import PairHmm

    return PairHmm.load(MODEL)


def sequences(n, length, seed):
    from __graft_entry__ import _example_sequences

    reads, refs, _ = _example_sequences(n, length, length, seed=seed)
    return reads, refs


# ------------------------------------------------------------------ phases


def phase_device(rehearse):
    import jax

    from marginalign_trna_tpu.utils.device import card_name_and_power_limit

    t0 = time.perf_counter()
    dev = jax.devices()[0]
    if not rehearse and dev.platform != "gpu":
        raise SystemExit("no GPU: JAX found %s devices" % dev.platform)
    smi = card_name_and_power_limit() if dev.platform == "gpu" else "none"
    line("device", t0, platform=dev.platform, kind=dev.device_kind,
         count=len(jax.devices()), nvidia_smi=smi)
    return dev, smi


def phase_compile(cfg):
    import jax
    import jax.numpy as jnp

    from marginalign_trna_tpu.align.em import make_tables_stacked
    from marginalign_trna_tpu.ops.band import (
        padded_band_width, quantized_steps,
    )
    from marginalign_trna_tpu.ops.dispatch import (
        BYTES_PER_CELL, fb_counts_trials, max_batch_cells_for,
    )
    from marginalign_trna_tpu.ops.fb import (
        DeviceBatch, forward_backward, make_tables,
    )
    from marginalign_trna_tpu.ops.nw import banded_nw

    t0 = time.perf_counter()
    tables = make_tables(load_hmm())
    D1 = quantized_steps(2 * cfg["read_len"] + 1)

    def spec(lanes, width, d1=D1):
        wp = padded_band_width(width)
        sd = jax.ShapeDtypeStruct
        return DeviceBatch(
            xb=sd((d1, wp, lanes), jnp.int8), yb=sd((d1, wp, lanes), jnp.int8),
            valid=sd((d1, wp, lanes), jnp.bool_),
            s1=sd((d1, lanes), jnp.int32), s2=sd((d1, lanes), jnp.int32),
            final_d=sd((lanes,), jnp.int32), final_k=sd((lanes,), jnp.int32),
        )

    def mem(compiled):
        ma = compiled.memory_analysis()
        return {k: getattr(ma, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(ma, k)}

    posteriors = jax.jit(lambda t, b: forward_backward(t, b).posteriors)
    fb = posteriors.lower(tables, spec(cfg["compile_lanes"], 21)).compile()
    out = {"fb": mem(fb)}
    params = jnp.zeros((4,), jnp.float32)
    out["nw_width40"] = mem(
        banded_nw.lower(params, spec(cfg["guide_lanes"], 40)).compile())

    # The largest buckets the device budgets admit (ops/dispatch.py): the
    # realign FB at this read length, and the three-trial lockstep E-step
    # on anchor segments (split at 300: <= 601 diagonals, padded to 1,024).
    # Each program's bytes per budget cell must stay within BYTES_PER_CELL.
    per_cell = {}
    for stage, d1, ntr, fn, tabs in (
            ("realign", D1, 1, posteriors, tables),
            ("em", 1024, 3, jax.jit(fb_counts_trials),
             make_tables_stacked([load_hmm()] * 3))):
        budget = max_batch_cells_for(stage, trials=ntr)
        lanes = cfg["budget_lanes"] or 1 << (
            (budget // (d1 * 21)).bit_length() - 1)
        m = mem(fn.lower(tabs, spec(lanes, 21, d1)).compile())
        per_cell[stage] = (
            m["argument_size_in_bytes"] + m["output_size_in_bytes"]
            + m["temp_size_in_bytes"]) / (d1 * lanes * 21 * ntr)
        out["%s_budget" % stage] = dict(
            m, d1=d1, lanes=lanes, trials=ntr, budget_cells=budget,
            bytes_per_cell_per_trial=per_cell[stage],
            bytes_per_cell_allowed=BYTES_PER_CELL[stage])
    line("compile", t0, d1=D1, lanes=cfg["compile_lanes"],
         guide_lanes=cfg["guide_lanes"], memory_analysis=out)
    if not cfg["budget_lanes"]:
        for stage, got in per_cell.items():
            check(got <= BYTES_PER_CELL[stage],
                  "%s takes %.1f bytes per budget cell, budget %d"
                  % (stage, got, BYTES_PER_CELL[stage]))


def phase_reference(cfg):
    import jax
    import jax.numpy as jnp

    from marginalign_trna_tpu.ops.band import pack_banded_batch
    from marginalign_trna_tpu.ops.dispatch import fb_posteriors
    from marginalign_trna_tpu.ops.fb import (
        device_batch, forward_backward, make_tables,
    )
    from marginalign_trna_tpu.ops.mea import mea_decode
    from marginalign_trna_tpu.ops.nw import banded_nw

    t0 = time.perf_counter()
    cpu = jax.devices("cpu")[0]
    hmm = load_hmm()
    reads, refs = sequences(cfg["check_lanes"], cfg["read_len"], seed=11)
    batch = pack_banded_batch(reads, refs, width=21, quantize=True)
    logz_g, post_g = fb_posteriors(make_tables(hmm), device_batch(batch))
    logz_g, post_g = np.asarray(logz_g), np.asarray(post_g)
    with jax.default_device(cpu):
        res_c = forward_backward(make_tables(hmm), device_batch(batch))
        logz_c, post_c = np.asarray(res_c.logZ), np.asarray(res_c.posteriors)
    n = len(reads)
    post_dev = float(np.abs(post_g - post_c).max())
    logz_dev = float(np.max(np.abs(logz_g[:n] - logz_c[:n])
                            / np.abs(logz_c[:n])))

    # Guide NW at width 40 and the MEA decode (fed the same posteriors):
    # the same XLA programs on both backends must agree exactly.
    gbatch = pack_banded_batch(reads, refs, width=40, quantize=True)
    params = np.asarray([1.0, -2.0, -3.0, -1.0], np.float32)
    nw_g = banded_nw(params, device_batch(gbatch))
    ops_g = mea_decode(post_c, batch)
    with jax.default_device(cpu):
        nw_c = banded_nw(jnp.asarray(params), device_batch(gbatch))
        ops_c = mea_decode(post_c, batch)
        nw_ptr_c, nw_score_c = np.asarray(nw_c.pointers), np.asarray(nw_c.score)
    nw_ptr_equal = bool(np.array_equal(np.asarray(nw_g.pointers), nw_ptr_c))
    nw_score_equal = bool(np.array_equal(np.asarray(nw_g.score), nw_score_c))
    mea_equal = ops_g == ops_c
    line("reference", t0, lanes=n, d1=batch.num_steps,
         max_abs_posterior_dev=post_dev, max_rel_logz_dev=logz_dev,
         nw_pointers_equal=nw_ptr_equal, nw_score_equal=nw_score_equal,
         mea_ops_equal=mea_equal)
    check(np.isfinite(post_g).all() and np.isfinite(logz_g).all(),
          "non-finite GPU output")
    check(post_dev <= POST_ATOL, "posterior deviation %g" % post_dev)
    check(logz_dev <= LOGZ_RTOL, "logZ deviation %g" % logz_dev)
    check(nw_ptr_equal and nw_score_equal, "NW differs from the CPU backend")
    check(mea_equal, "MEA ops differ from the CPU backend")


def _sam_by_name(path):
    from marginalign_trna_tpu.io.sam import SamFile

    return {r.qname: r for r in SamFile.read(path).records}


def _median_identity(sam, fq, ref):
    from marginalign_trna_tpu.stats.stats import ReadAlignmentStats

    stats = ReadAlignmentStats.get_read_alignment_stats(sam, fq, ref, True)
    return float(np.median([s.alignment_identity() for s in stats]))


def phase_margin_align(cfg, work):
    import jax

    from marginalign_trna_tpu.cli import margin_align_main

    t0 = time.perf_counter()
    fq, ref = make_corpus(cfg["reads"], cfg["read_len"], work)
    out = os.path.join(work, "out.sam")
    check(margin_align_main([fq, ref, out]) == 0, "marginAlign failed")
    t_gpu = time.perf_counter() - t0
    recs = _sam_by_name(out)
    check(len(recs) == cfg["reads"],
          "%d of %d reads output" % (len(recs), cfg["reads"]))

    k = cfg["cpu_reads"]
    fq_k = os.path.join(work, "first.fq")
    with open(fq) as src, open(fq_k, "w") as dst:
        for _ in range(4 * k):
            dst.write(src.readline())
    out_k = os.path.join(work, "first_cpu.sam")
    with jax.default_device(jax.devices("cpu")[0]):
        check(margin_align_main([fq_k, ref, out_k]) == 0,
              "marginAlign on the CPU backend failed")
    cpu_recs = _sam_by_name(out_k)
    same = sum(int(name in recs and recs[name].cigar == rec.cigar)
               for name, rec in cpu_recs.items())
    gpu_k = os.path.join(work, "first_gpu.sam")
    from marginalign_trna_tpu.io.sam import SamFile

    full = SamFile.read(out)
    full.records = [recs[name] for name in cpu_recs if name in recs]
    full.write(gpu_k)
    id_gpu = _median_identity(gpu_k, fq_k, ref)
    id_cpu = _median_identity(out_k, fq_k, ref)
    line("marginAlign", t0, reads=cfg["reads"], read_len=cfg["read_len"],
         reads_out=len(recs), gpu_seconds=round(t_gpu, 3),
         reads_per_sec=round(cfg["reads"] / t_gpu, 3),
         cpu_rerun=len(cpu_recs), identical_cigars=same,
         median_identity_gpu=id_gpu, median_identity_cpu=id_cpu)
    check(len(cpu_recs) == k, "CPU re-run output %d of %d" % (len(cpu_recs), k))
    check(same >= k - max(1, k // 64), "%d of %d CIGARs identical" % (same, k))
    check(abs(id_gpu - id_cpu) <= 0.005,
          "median identity %g vs %g" % (id_gpu, id_cpu))
    return fq, ref


def caller_corpus(cfg, work, seed=5):
    """True genome -> SNP-mutated reference + mutation list; reads from the
    true genome at the configured depth."""
    from marginalign_trna_tpu.io.fasta import write_fasta_file
    from marginalign_trna_tpu.utils.mutate import mutate_sequences
    from marginalign_trna_tpu.utils.simulate import (
        random_sequence, simulate_reads,
    )

    rng = np.random.default_rng(seed)
    genome = {"phage": random_sequence(cfg["caller_ref"], rng)}
    mutated, muts = mutate_sequences(genome, 0.01, seed=seed)
    lo, hi = cfg["caller_read_len"]
    n_reads = -(-cfg["caller_ref"] * cfg["caller_depth"] // ((lo + hi) // 2))
    reads = simulate_reads(genome, n_reads, lo, hi, rng)
    ref = os.path.join(work, "mutated.fa")
    write_fasta_file(ref, mutated.items())
    fq = os.path.join(work, "caller_reads.fq")
    with open(fq, "w") as fh:
        for name, seq, _ in reads:
            fh.write("@%s\n%s\n+\n%s\n" % (name, seq, "I" * len(seq)))
    # A call against the mutated reference names the ORIGINAL base.
    truth = {(name, pos + 1, orig.upper()) for name, pos, orig, _ in muts}
    return fq, ref, truth, n_reads


def phase_caller(cfg, work):
    from marginalign_trna_tpu.cli import margin_align_main, margin_caller_main
    from marginalign_trna_tpu.io.vcf import vcf_read

    t0 = time.perf_counter()
    fq, ref, truth, n_reads = caller_corpus(cfg, work)
    sam = os.path.join(work, "caller.sam")
    check(margin_align_main([fq, ref, sam]) == 0, "marginAlign failed")
    vcf = os.path.join(work, "calls.vcf")
    t1 = time.perf_counter()
    check(margin_caller_main([sam, ref, vcf]) == 0, "marginCaller failed")
    t_call = time.perf_counter() - t1
    called = vcf_read(vcf)
    inter = len(truth & called)
    precision = inter / max(1, len(called))
    recall = inter / max(1, len(truth))
    line("caller", t0, ref_len=cfg["caller_ref"], reads=n_reads,
         depth=cfg["caller_depth"], mutations=len(truth), calls=len(called),
         precision=precision, recall=recall,
         caller_seconds=round(t_call, 3))
    check(precision >= cfg["caller_min_precision"],
          "precision %g" % precision)
    check(recall >= cfg["caller_min_recall"], "recall %g" % recall)


def phase_em(cfg, work, fq, ref):
    from marginalign_trna_tpu.cli import margin_align_main
    from marginalign_trna_tpu.models.hmm import PairHmm

    t0 = time.perf_counter()
    out = os.path.join(work, "em.sam")
    model = os.path.join(work, "em.hmm")
    log = io.StringIO()
    with contextlib.redirect_stderr(log):
        rc = margin_align_main([
            fq, ref, out, "--em", "--outputModel", model,
            "--iterations", str(cfg["em_iterations"]),
        ])
    check(rc == 0, "marginAlign --em failed")
    lls = {}
    for trial, value in re.findall(
            r"EM trial (\d+) iter \d+ log-likelihood (-?[0-9.]+(?:e[-+]?\d+)?)",
            log.getvalue()):
        lls.setdefault(int(trial), []).append(float(value))
    hmm = PairHmm.load(model)
    hmm.check()
    line("em", t0, trials=len(lls), log_likelihood=lls,
         model_likelihood=hmm.likelihood,
         reads_out=len(_sam_by_name(out)))
    check(len(lls) == 3, "EM logged %d trials, expected the CLI's 3"
          % len(lls))
    for trial, ll in lls.items():
        check(len(ll) >= 2, "EM trial %d logged %d iterations"
              % (trial, len(ll)))
        check(all(b >= a - 1e-6 * abs(a) for a, b in zip(ll, ll[1:])),
              "trial %d likelihood not monotone: %s" % (trial, ll))


# ------------------------------------------------------------ four devices


def phase_multi_device(cfg, work, n_devices):
    """Realign, caller and EM E-step round-robined over n local devices,
    and the psum EM train step on an n-device mesh, each against one
    device on the same inputs."""
    import jax
    import jax.numpy as jnp

    from marginalign_trna_tpu.align.chain import chain_sam_file
    from marginalign_trna_tpu.align.em import (
        expectation_step, prepare_em_batches,
    )
    from marginalign_trna_tpu.align.guide import map_reads
    from marginalign_trna_tpu.align.realign import (
        _jobs_from_sam, realigned_ops_for_jobs, split_jobs_at_anchors,
    )
    from marginalign_trna_tpu.call.caller import (
        CallerOptions, accumulate_expectations,
    )
    from marginalign_trna_tpu.io.fasta import get_fasta_dictionary
    from marginalign_trna_tpu.io.sam import SamFile
    from marginalign_trna_tpu.ops.band import (
        pack_banded_batch, quantized_steps,
    )
    from marginalign_trna_tpu.ops.fb import (
        device_batch, forward_backward, make_tables,
    )
    from marginalign_trna_tpu.parallel.mesh import (
        make_data_mesh, make_em_train_step, pad_batch_lanes,
    )
    from marginalign_trna_tpu.parallel.runtime import local_dispatch_devices
    from marginalign_trna_tpu.utils.seq import encode

    t0 = time.perf_counter()
    devices = jax.local_devices()
    check(len(devices) >= n_devices,
          "%d devices, need %d" % (len(devices), n_devices))
    hmm = load_hmm()
    fq, ref = make_corpus(cfg["multi_reads"], cfg["read_len"], work)
    guide = os.path.join(work, "guide.sam")
    chained = os.path.join(work, "chained.sam")
    map_reads(fq, ref, guide)
    chain_sam_file(guide, chained, fq, ref)
    sam = SamFile.read(chained)
    refs = get_fasta_dictionary(ref)
    jobs = _jobs_from_sam(sam, refs, encode)
    check(len(jobs) == cfg["multi_reads"], "%d jobs" % len(jobs))
    def cells_for(problems):
        """A budget that packs the problems into >= 2 buckets per device:
        a power of two of at least 8 lanes each, else one problem each
        (a bucket of two or more pads to 8 lanes)."""
        sizes = [len(j.read_region) + len(j.ref_region) + 1
                 for j in problems]
        lanes = len(sizes) // (2 * n_devices)
        steps = quantized_steps(max(sizes)) * 21
        return steps * (1 << (lanes.bit_length() - 1)) if lanes >= 8 else (
            steps * 8 - 1)

    cells = cells_for(jobs)

    def one_device(fn):
        saved = os.environ["MARGINALIGN_LOCAL_DEVICES"]
        os.environ["MARGINALIGN_LOCAL_DEVICES"] = "1"
        try:
            return fn()
        finally:
            os.environ["MARGINALIGN_LOCAL_DEVICES"] = saved

    os.environ["MARGINALIGN_LOCAL_DEVICES"] = str(n_devices)
    check(len(local_dispatch_devices()) == n_devices, "dispatch devices")

    realign = lambda: realigned_ops_for_jobs(  # noqa: E731
        jobs, hmm, 0.5, 0.0, max_batch_cells=cells, split_size=3000)
    ops_n, ops_1 = realign(), one_device(realign)
    realign_equal = ops_n == ops_1

    opts = CallerOptions(max_batch_cells=cells // 4)
    call = lambda: accumulate_expectations(sam, refs, hmm, opts)  # noqa
    exp_n, exp_1 = call(), one_device(call)
    caller_equal = all(np.array_equal(exp_n[k], exp_1[k]) for k in exp_n)

    segs, _, _ = split_jobs_at_anchors(jobs, 300)
    seg_cells = cells_for(segs)
    batches_n = prepare_em_batches(segs, 21, seg_cells)
    placed = sorted({d.id for b, _ in batches_n for d in b.xb.devices()})
    counts_n = expectation_step(batches_n, hmm)
    counts_1 = one_device(
        lambda: expectation_step(prepare_em_batches(segs, 21, seg_cells),
                                 hmm))
    estep_dev = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
                    for a, b in zip(counts_n[:3], counts_1[:3]))
    estep_ll = abs(counts_n[3] - counts_1[3]) / abs(counts_1[3])
    del os.environ["MARGINALIGN_LOCAL_DEVICES"]

    # psum EM train step over a flat n-device data mesh vs one device.
    mesh = make_data_mesh(devices[:n_devices])
    batch = pad_batch_lanes(pack_banded_batch(
        [j.read_region for j in segs[:64 * n_devices]],
        [j.ref_region for j in segs[:64 * n_devices]], width=21,
        paths=[j.path for j in segs[:64 * n_devices]], quantize=True),
        n_devices)
    tables = make_tables(hmm)
    step = make_em_train_step(mesh)
    res = step(tables, jnp.asarray(hmm.transitions, jnp.float32),
               jnp.asarray(hmm.emissions, jnp.float32), device_batch(batch))
    with jax.default_device(devices[0]):
        one = forward_backward(tables, device_batch(batch),
                               want_posteriors=False, want_counts=True)
    mesh_dev = max(
        float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                     / np.maximum(np.abs(np.asarray(b)), 1e-30)))
        for a, b in ((res.trans_counts, one.trans_counts),
                     (res.emit_match, one.emit_match),
                     (res.emit_gap, one.emit_gap)))
    mesh_ll = abs(float(res.log_likelihood) - float(np.sum(one.logZ))) / abs(
        float(np.sum(one.logZ)))
    line("multi_device", t0, devices=n_devices, reads=len(jobs),
         realign_ops_equal=realign_equal, caller_expectations_equal=caller_equal,
         em_batches=len(batches_n), em_batch_devices=placed,
         estep_counts_max_rel_dev=estep_dev, estep_ll_rel_dev=estep_ll,
         mesh_counts_max_rel_dev=mesh_dev, mesh_ll_rel_dev=mesh_ll)
    check(realign_equal, "realign ops differ across device counts")
    check(caller_equal, "caller expectations differ across device counts")
    check(len(placed) == n_devices, "E-step batches on devices %s" % placed)
    check(estep_dev <= 1e-5 and estep_ll <= 1e-5, "E-step counts differ")
    check(mesh_dev <= 1e-5 and mesh_ll <= 1e-5, "mesh EM step differs")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4: run only the multi-device path")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes; the CPU backend is accepted")
    args = ap.parse_args(argv)
    cfg = TINY if args.rehearse else FULL
    configure_compile_cache()

    import jax

    dev, smi = phase_device(args.rehearse)
    with tempfile.TemporaryDirectory() as work:
        if args.devices > 1:
            phase_multi_device(cfg, work, args.devices)
        else:
            phase_compile(cfg)
            phase_reference(cfg)
            fq, ref = phase_margin_align(cfg, work)
            phase_caller(cfg, work)
            phase_em(cfg, work, fq, ref)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as exc:
        print("FAILED: %s" % exc, file=sys.stderr)
        sys.exit(1)
