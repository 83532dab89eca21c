"""Baum-Welch EM training of the pair-HMM on the data itself.

Device replacement for cPecan's jobTree EM driver
(cPecanEm.expectationMaximisationTrials, called at
src/margin/marginAlignLib.py:219-221): multiple random-start trials, each
running iterations of (E-step: banded forward-backward expected counts over
all read/ref pairs, summed on device and psum-merged across the data mesh
axis; M-step: row renormalisation), keeping the maximum-likelihood trial.

Reference defaults mirrored from src/margin/marginAlign.py:38-53:
trials=3, iterations=100, randomStart=True, maxAlignmentLengthToSample=50M.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..models.hmm import GAP_X_STATES, GAP_Y_STATES, MODEL_TYPES, PairHmm
from ..ops.band import pack_banded_batch
from ..ops.fb import device_batch, make_tables
from .realign import RealignJob, _bucket_jobs, DEFAULT_BAND_WIDTH


@dataclass
class EmOptions:
    """EM options, mirroring the cPecanEm.Options surface the reference
    configures (src/margin/marginAlign.py:38-53)."""

    trials: int = 3
    iterations: int = 100
    random_start: bool = True
    # Model family (reference: cPecanEm modelType, marginAlign.py:40).
    model_type: str = "fiveStateAsymmetric"
    max_alignment_length_to_sample: int = 50_000_000
    band_width: int = DEFAULT_BAND_WIDTH
    # Split EM DP problems at guide anchors so no side exceeds this
    # (reference EM realign options --splitMatrixBiggerThanThis=300,
    # src/margin/marginAlign.py:41); 0 = exact full-length DP.
    split_size: int = 300
    # Start trial 0 from the input model instead of a random start; the
    # remaining trials stay random (reference: useDefaultModelAsStart,
    # commented out at src/margin/marginAlign.py:49 — semantics
    # [reconstructed]: seed one trial from the supplied model).
    use_default_model_as_start: bool = False
    # Padded DP cells per E-step batch; None = sized from device memory
    # (dispatch.max_batch_cells_for("em")).
    max_batch_cells: Optional[int] = None
    seed: int = 0
    # Early-exit when the total log-likelihood improves by less than this.
    tolerance: float = 1e-3
    train_emissions: bool = True
    # Tie short and long gap-state emissions (reference: tieEmissions).
    tie_emissions: bool = False
    # Write each trial's trained model to <path>.trial<N> (outputTrialHmms).
    output_trial_hmms_path: Optional[str] = None
    # Start emissions at a Jukes-Cantor matrix with this substitution rate
    # instead of random/flat (reference: setJukesCantorStartingEmissions).
    jukes_cantor_start: Optional[float] = None
    # Run all random-start trials in lockstep: every E-step batch computes
    # every trial's expected counts in ONE device call (a vmap over the
    # trials), instead of the reference's serial trials
    # (cPecanEm expectationMaximisationTrials, marginAlignLib.py:219-221).
    lockstep: bool = True
    # Re-derive the EM band every k iterations by MEA-realigning the
    # training pairs with the current model (cPecanEm updateTheBand
    # [reconstructed]: the DP band follows the evolving model's alignment
    # instead of the original guide; the reference ships the flag
    # commented out, src/margin/marginAlign.py:50).  0 = off (default,
    # like the reference).  In lockstep mode the current best-likelihood
    # trial's model drives the shared band.
    update_band_every: int = 0


@dataclass
class EmTrialResult:
    hmm: PairHmm
    likelihood: float
    likelihood_history: List[float]


def _m_step(
    hmm: PairHmm,
    trans_counts: np.ndarray,
    emit_match: np.ndarray,
    emit_gap: np.ndarray,
    train_emissions: bool,
) -> PairHmm:
    """Row-renormalise expected counts into new parameters.  Rows with no
    mass keep their previous values (cPecan keeps the old row too)."""
    new = hmm.copy()
    row = trans_counts.sum(axis=1, keepdims=True)
    ok = row[:, 0] > 0
    new.transitions[ok] = trans_counts[ok] / row[ok]

    if train_emissions:
        # Match state: drop the N row/column, renormalise over ACGT x ACGT.
        m4 = emit_match[:4, :4]
        if m4.sum() > 0:
            new.emissions[0] = (m4 / m4.sum()).reshape(-1)
        # Gap states: the per-base marginal expands to a 16-vector, uniform
        # over the silent axis (the reference flattens gap emissions after
        # training anyway; marginAlignLib.py:229).
        for s in range(1, 5):
            marg = emit_gap[s, :4]
            if marg.sum() <= 0:
                continue
            marg = marg / marg.sum()
            e = np.empty((4, 4))
            if s in GAP_X_STATES:
                e[:, :] = marg[:, None] / 4.0
            else:
                e[:, :] = marg[None, :] / 4.0
            new.emissions[s] = e.reshape(-1)
    return new


def prepare_em_batches(
    jobs: Sequence[RealignJob],
    band_width: int = DEFAULT_BAND_WIDTH,
    max_batch_cells: Optional[int] = None,
    trials: int = 1,
) -> List[Tuple[object, int]]:
    """Pack jobs into device-resident E-step batches ONCE per training run
    (band geometry is iteration-invariant).  Returns (DeviceBatch, n_real)
    per batch.  trials: the lockstep trials each batch serves; the default
    budget is divided among them.  Batches round-robin across local devices: committed inputs
    pin each batch's counts call to its device, and _counts_pipelined
    keeps every batch in flight (the reference fanned EM expectation jobs
    across jobTree workers, SURVEY.md §3.2)."""
    from ..ops.dispatch import max_batch_cells_for
    from ..parallel.runtime import local_dispatch_devices

    if max_batch_cells is None:
        max_batch_cells = max_batch_cells_for("em", trials=trials)
    devices = local_dispatch_devices()
    out: List[Tuple[object, int]] = []
    for bi, bucket in enumerate(
        _bucket_jobs(jobs, band_width, max_batch_cells)
    ):
        batch = pack_banded_batch(
            [jobs[i].read_region for i in bucket],
            [jobs[i].ref_region for i in bucket],
            width=band_width,
            paths=[jobs[i].path for i in bucket],
            quantize=True,
        )
        out.append((device_batch(batch, devices[bi % len(devices)]),
                    len(bucket)))
    return out


def _counts_pipelined(batches, count_fn):
    """Dispatch one expected-counts call per batch WITHOUT syncing, then
    materialise in order: yields (np-arrays tuple, n_real) per batch.
    Count outputs are tiny ([5,5]-class), so keeping every batch's results
    in flight holds no device memory to speak of."""
    pending = [(count_fn(dev), n_real) for dev, n_real in batches]
    for res, n_real in pending:
        yield tuple(np.asarray(a) for a in res), n_real


def expectation_step(
    batches: List[Tuple[object, int]],
    hmm: PairHmm,
    psum_fn=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Expected counts + total log-likelihood over prepared batches
    (prepare_em_batches).  psum_fn, when given, merges count tensors
    across the data-parallel mesh axis."""
    tables = make_tables(hmm)
    tc = np.zeros((5, 5))
    em = np.zeros((5, 5))
    eg = np.zeros((5, 5))
    total_ll = 0.0
    from ..ops.dispatch import fb_counts

    for (logZ, tc_b, em_b, eg_b), n_real in _counts_pipelined(
        batches, lambda d: fb_counts(tables, d)
    ):
        total_ll += float(np.sum(logZ[:n_real]))
        tc += tc_b.astype(np.float64)
        em += em_b.astype(np.float64)
        eg += eg_b.astype(np.float64)
    if psum_fn is not None:
        tc, em, eg, total_ll = psum_fn(tc, em, eg, total_ll)
    return tc, em, eg, total_ll


def make_tables_stacked(hmms: Sequence[PairHmm]):
    """FbTables with a leading [Ntr] trials axis on every leaf."""
    import jax.numpy as jnp

    from ..ops.fb import FbTables

    ts = [make_tables(h) for h in hmms]
    return FbTables(
        T=jnp.stack([t.T for t in ts]),
        Ematch=jnp.stack([t.Ematch for t in ts]),
        Egap=jnp.stack([t.Egap for t in ts]),
        pi=jnp.stack([t.pi for t in ts]),
    )


def expectation_step_trials(
    batches: List[Tuple[object, int]],
    hmms: Sequence[PairHmm],
    psum_fn=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Expected counts + per-trial total log-likelihood for ALL trials over
    prepared batches: one device call per batch regardless of trial count
    (vs the reference's per-trial sweeps).  Returns ([Ntr,5,5] x3, [Ntr])."""
    tables = make_tables_stacked(hmms)
    ntr = len(hmms)
    tc = np.zeros((ntr, 5, 5))
    em = np.zeros((ntr, 5, 5))
    eg = np.zeros((ntr, 5, 5))
    total_ll = np.zeros(ntr)
    from ..ops.dispatch import fb_counts_trials

    for (logZ, tc_b, em_b, eg_b), n_real in _counts_pipelined(
        batches, lambda d: fb_counts_trials(tables, d)
    ):
        total_ll += logZ[:, :n_real].sum(axis=1)
        tc += tc_b.astype(np.float64)
        em += em_b.astype(np.float64)
        eg += eg_b.astype(np.float64)
    if psum_fn is not None:
        tc, em, eg, total_ll = psum_fn(tc, em, eg, total_ll)
    return tc, em, eg, total_ll


def sample_jobs(
    jobs: List[RealignJob], max_bases: int, seed: int = 0
) -> List[RealignJob]:
    """Cap the total aligned read bases used for training
    (maxAlignmentLengthToSample, src/margin/marginAlign.py:47)."""
    if sum(len(j.read_region) for j in jobs) <= max_bases:
        return jobs
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(jobs))
    out, total = [], 0
    for idx in order:
        n = len(jobs[idx].read_region)
        if total + n > max_bases and out:
            break
        out.append(jobs[idx])
        total += n
    return out


def _tie_gap_emissions(hmm: PairHmm) -> None:
    """Tie short/long gap-state emissions (average 1<->3 and 2<->4)."""
    for a, b in ((1, 3), (2, 4)):
        avg = 0.5 * (hmm.emissions[a] + hmm.emissions[b])
        hmm.emissions[a] = avg
        hmm.emissions[b] = avg.copy()


def _init_trial_hmm(
    options: EmOptions, input_hmm: Optional[PairHmm], trial: int
) -> PairHmm:
    from_input = input_hmm is not None and (
        not options.random_start
        or (options.use_default_model_as_start and trial == 0)
    )
    if from_input:
        hmm = input_hmm.copy()
    else:
        hmm = PairHmm.random(seed=options.seed * 1000 + trial)
    hmm.model_type = MODEL_TYPES[options.model_type]
    if options.jukes_cantor_start is not None:
        r = options.jukes_cantor_start
        jc = np.full((4, 4), r / 3.0)
        np.fill_diagonal(jc, 1.0 - r)
        hmm.emissions[0] = (jc / jc.sum()).reshape(-1)
    hmm.apply_model_type_constraints()
    if options.tie_emissions:
        _tie_gap_emissions(hmm)
    return hmm


def _update_band_jobs(
    jobs: List[RealignJob], hmm: PairHmm, options: EmOptions
) -> List[RealignJob]:
    """Re-derive each training pair's band path by MEA-realigning it with
    the current model (EmOptions.update_band_every)."""
    from ..ops.band import path_from_cigar
    from .realign import realigned_ops_for_jobs

    ops_list = realigned_ops_for_jobs(
        jobs, hmm, 0.5, 0.0, options.band_width, split_size=0,
    )
    out = []
    for job, ops in zip(jobs, ops_list):
        aligned = [(op, ln) for op, ln in ops if op in (0, 1, 2)]
        if not aligned:
            out.append(job)
            continue
        pd, pi = path_from_cigar(aligned)
        out.append(RealignJob(
            record=job.record, read_region=job.read_region,
            ref_region=job.ref_region, path=(pd, pi),
        ))
    return out


def _train_em_lockstep(
    batches: List[Tuple[object, int]],
    options: EmOptions,
    input_hmm: Optional[PairHmm],
    psum_fn,
    log_fn,
    checkpoint_path: Optional[str],
    jobs: Optional[List[RealignJob]] = None,
) -> EmTrialResult:
    """All trials advance together: per iteration, ONE device call per
    E-step batch computes every trial's counts (a vmap over the trials).  Trial trajectories are identical to the serial
    path (same seeds, same per-trial arithmetic) EXCEPT under
    update_band_every: lockstep shares one band (derived from the current
    best trial's model) across all trials, while the serial path keeps
    each trial's band trial-local — a documented deviation, since
    per-trial bands would need per-trial E-step batches and break the
    single-call lockstep shape.  Converged trials freeze (params stop
    updating) until all are done."""
    from .checkpoint import EmLockstepCheckpoint

    ntr = options.trials
    ck = EmLockstepCheckpoint.try_load(checkpoint_path)
    if ck is not None and ck.transitions.shape[0] == ntr:
        hmms = ck.hmms()
        for h in hmms:
            h.model_type = MODEL_TYPES[options.model_type]
        histories = [list(h) for h in ck.histories]
        frozen = list(ck.frozen)
        start_iter = ck.iteration
        lls = np.array([h[-1] if h else -np.inf for h in histories])
        if (options.update_band_every and jobs is not None
                and start_iter > 0 and not all(frozen)):
            # Band state is not checkpointed: re-derive it from the
            # restored best model so a resumed run matches an
            # uninterrupted one (exactly, when update_band_every == 1;
            # for larger periods the resumed band is at most one period
            # fresher — documented deviation).
            jobs = _update_band_jobs(
                jobs, hmms[int(np.argmax(lls))], options
            )
            batches = prepare_em_batches(
                jobs, options.band_width, options.max_batch_cells, ntr
            )
    else:
        hmms = [_init_trial_hmm(options, input_hmm, t) for t in range(ntr)]
        histories = [[] for _ in range(ntr)]
        frozen = [False] * ntr
        start_iter = 0
        lls = np.full(ntr, -np.inf)

    for it in range(start_iter, options.iterations):
        if all(frozen):
            break
        tc, em, eg, new_ll = expectation_step_trials(batches, hmms, psum_fn)
        for t in range(ntr):
            if frozen[t]:
                continue
            hmms[t] = _m_step(
                hmms[t], tc[t], em[t], eg[t], options.train_emissions
            )
            hmms[t].apply_model_type_constraints()
            if options.tie_emissions:
                _tie_gap_emissions(hmms[t])
            histories[t].append(float(new_ll[t]))
            if log_fn:
                log_fn("EM trial %d iter %d log-likelihood %.4f"
                       % (t, it, new_ll[t]))
            if np.isfinite(lls[t]) and abs(new_ll[t] - lls[t]) < (
                options.tolerance
            ):
                frozen[t] = True
            lls[t] = new_ll[t]
        if checkpoint_path:
            EmLockstepCheckpoint(
                iteration=it + 1,
                transitions=np.stack([h.transitions for h in hmms]),
                emissions=np.stack([h.emissions for h in hmms]),
                histories=histories,
                frozen=frozen,
            ).save(checkpoint_path)
        if (options.update_band_every and jobs is not None
                and (it + 1) % options.update_band_every == 0
                and not all(frozen)):
            # Band follows the current best trial's model; per-trial
            # likelihoods are then over the NEW band from the next
            # iteration on (the reference's updateTheBand shares this
            # band-change likelihood discontinuity).
            jobs = _update_band_jobs(
                jobs, hmms[int(np.argmax(lls))], options
            )
            batches = prepare_em_batches(
                jobs, options.band_width, options.max_batch_cells, ntr
            )

    best_t = int(np.argmax(lls))
    results = []
    for t in range(ntr):
        hmms[t].likelihood = float(lls[t])
        if options.output_trial_hmms_path:
            hmms[t].write(
                "%s.trial%d" % (options.output_trial_hmms_path, t)
            )
        results.append(EmTrialResult(
            hmm=hmms[t], likelihood=float(lls[t]),
            likelihood_history=histories[t],
        ))
    return results[best_t]


def train_em(
    jobs: List[RealignJob],
    options: EmOptions,
    input_hmm: Optional[PairHmm] = None,
    psum_fn=None,
    log_fn=None,
    checkpoint_path: Optional[str] = None,
) -> EmTrialResult:
    """Run the full multi-trial EM and return the best trial.

    With checkpoint_path, state is saved after every iteration and training
    resumes mid-trial from an existing checkpoint file (the jobTree-resume
    equivalent; see align/checkpoint.py)."""
    from .checkpoint import EmCheckpoint

    jobs = sample_jobs(jobs, options.max_alignment_length_to_sample,
                       options.seed)

    # Multi-host: each process trains on its strided share of the jobs and
    # count tensors all-reduce across hosts (single-process: no-ops).
    from ..parallel.runtime import allreduce_sum_host, shard_for_host

    jobs = shard_for_host(jobs)

    # Anchor splitting (reference EM realign options
    # --splitMatrixBiggerThanThis=300, src/margin/marginAlign.py:41):
    # long alignments decompose at guide anchors into independent DP
    # sub-problems; expected counts sum over segments and the trial
    # likelihood is the sum of segment logZs.
    if options.split_size and options.split_size > 0:
        from .realign import split_jobs_at_anchors

        jobs, _, _ = split_jobs_at_anchors(jobs, options.split_size)
    if psum_fn is None:
        import jax

        if jax.process_count() > 1:
            def psum_fn(tc, em, eg, ll):
                return allreduce_sum_host(tc, em, eg, ll)

    # Lockstep trials unless resuming an old serial-format checkpoint.
    from .checkpoint import is_lockstep_checkpoint

    serial_resume = (
        checkpoint_path
        and EmCheckpoint.try_load(checkpoint_path) is not None
        and not is_lockstep_checkpoint(checkpoint_path)
    )
    lockstep = options.lockstep and options.trials > 1 and not serial_resume
    batches = prepare_em_batches(jobs, options.band_width,
                                 options.max_batch_cells,
                                 options.trials if lockstep else 1)
    if lockstep:
        return _train_em_lockstep(
            batches, options, input_hmm, psum_fn, log_fn, checkpoint_path,
            jobs=jobs,
        )

    ckpt = EmCheckpoint.try_load(checkpoint_path)
    start_trial = ckpt.trial if ckpt else 0
    best: Optional[EmTrialResult] = None
    if ckpt and ckpt.best_hmm() is not None:
        bh = ckpt.best_hmm()
        best = EmTrialResult(hmm=bh, likelihood=bh.likelihood,
                             likelihood_history=[])

    for trial in range(start_trial, options.trials):
        if ckpt and trial == ckpt.trial:
            hmm = ckpt.hmm()
            history = list(ckpt.likelihood_history)
            start_iter = ckpt.iteration
            ll = history[-1] if history else -np.inf
            hmm.model_type = MODEL_TYPES[options.model_type]
            hmm.apply_model_type_constraints()
            if options.tie_emissions:
                _tie_gap_emissions(hmm)
        else:
            hmm = _init_trial_hmm(options, input_hmm, trial)
            history = []
            start_iter = 0
            ll = -np.inf
        # Each serial trial starts from the ORIGINAL guide band; band
        # updates (update_band_every) stay trial-local.
        trial_jobs, trial_batches = jobs, batches
        for it in range(start_iter, options.iterations):
            tc, em, eg, new_ll = expectation_step(trial_batches, hmm,
                                                  psum_fn)
            hmm = _m_step(hmm, tc, em, eg, options.train_emissions)
            hmm.apply_model_type_constraints()
            if options.tie_emissions:
                _tie_gap_emissions(hmm)
            history.append(new_ll)
            if log_fn:
                log_fn("EM trial %d iter %d log-likelihood %.4f"
                       % (trial, it, new_ll))
            if checkpoint_path:
                EmCheckpoint(
                    trial=trial, iteration=it + 1,
                    transitions=hmm.transitions, emissions=hmm.emissions,
                    likelihood_history=history,
                    best_trial_likelihood=(
                        best.likelihood if best else -np.inf
                    ),
                    best_transitions=(
                        best.hmm.transitions if best else None
                    ),
                    best_emissions=best.hmm.emissions if best else None,
                ).save(checkpoint_path)
            if np.isfinite(ll) and abs(new_ll - ll) < options.tolerance:
                ll = new_ll
                break
            ll = new_ll
            if (options.update_band_every
                    and (it + 1) % options.update_band_every == 0):
                trial_jobs = _update_band_jobs(trial_jobs, hmm, options)
                trial_batches = prepare_em_batches(
                    trial_jobs, options.band_width, options.max_batch_cells
                )
        hmm.likelihood = ll
        if options.output_trial_hmms_path:
            hmm.write("%s.trial%d" % (options.output_trial_hmms_path, trial))
        result = EmTrialResult(hmm=hmm, likelihood=ll,
                               likelihood_history=history)
        if best is None or result.likelihood > best.likelihood:
            best = result
        if checkpoint_path:
            # Mark this trial complete: next trial starts fresh on resume.
            EmCheckpoint(
                trial=trial + 1, iteration=0,
                transitions=hmm.transitions, emissions=hmm.emissions,
                likelihood_history=[],
                best_trial_likelihood=best.likelihood,
                best_transitions=best.hmm.transitions,
                best_emissions=best.hmm.emissions,
            ).save(checkpoint_path)
    assert best is not None
    return best


def normalise_trained_hmm(hmm: PairHmm) -> PairHmm:
    """Post-EM normalisation: flat indel emissions + GC 0.5 renormalisation
    (reference: learnModelFromSamFileTargetFn2, marginAlignLib.py:227-232)."""
    out = hmm.copy()
    out.set_flat_indel_emissions()
    out.normalise_by_gc_content(0.5)
    return out
