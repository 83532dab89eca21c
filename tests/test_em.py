"""EM training tests: convergence, recovery of known parameters,
checkpoint/resume."""
import os

import numpy as np
import pytest

from marginalign_trna_tpu.align.em import (
    EmOptions, normalise_trained_hmm, sample_jobs, train_em,
)
from marginalign_trna_tpu.align.realign import RealignJob
from marginalign_trna_tpu.align.checkpoint import EmCheckpoint
from marginalign_trna_tpu.io.sam import SamRecord
from marginalign_trna_tpu.models.hmm import PairHmm
from marginalign_trna_tpu.ops.band import path_from_cigar


def _synthetic_jobs(rng, n_pairs=12, length=60, sub_rate=0.15):
    """Read/ref pairs generated from refs with substitutions only (so the
    true match fraction is known)."""
    jobs = []
    for idx in range(n_pairs):
        ref = rng.integers(0, 4, size=length).astype(np.int8)
        read = ref.copy()
        k = max(1, int(sub_rate * length))
        pos = rng.choice(length, size=k, replace=False)
        read[pos] = (read[pos] + rng.integers(1, 4, size=k)) % 4
        pd, pi = path_from_cigar([(0, length)])
        rec = SamRecord(
            qname="r%d" % idx, flag=0, rname="ref", pos=0, mapq=255,
            cigar=[(0, length)], seq="A" * length,
        )
        jobs.append(RealignJob(record=rec, read_region=read, ref_region=ref,
                               path=(pd, pi)))
    return jobs


def test_em_likelihood_monotone(rng):
    jobs = _synthetic_jobs(rng)
    opts = EmOptions(trials=1, iterations=6, band_width=15, seed=3,
                     tolerance=0.0)
    result = train_em(jobs, opts)
    hist = result.likelihood_history
    assert len(hist) >= 3
    assert all(b >= a - 1e-2 for a, b in zip(hist, hist[1:])), hist


def test_em_recovers_match_structure():
    """On substitution-only data, the trained model should put most match
    emission mass on the diagonal and favour match-to-match transitions.
    Own fixed-seed rng: the session rng's state depends on test order and
    this test's thresholds are data-marginal."""
    rng = np.random.default_rng(7)
    jobs = _synthetic_jobs(rng, n_pairs=16, length=80, sub_rate=0.1)
    opts = EmOptions(trials=2, iterations=15, band_width=15, seed=1)
    result = train_em(jobs, opts)
    e = result.hmm.emissions[0].reshape(4, 4)
    diag_mass = np.trace(e)
    assert diag_mass > 0.7, diag_mass
    assert result.hmm.transitions[0, 0] > 0.8


def test_em_normalisation_post_pass():
    hmm = PairHmm.random(seed=5)
    out = normalise_trained_hmm(hmm)
    out.check()
    assert np.allclose(out.emissions[2], 1.0 / 16.0)  # insert states flat
    e1 = out.emissions[1].reshape(4, 4)
    assert np.allclose(e1.sum(axis=1), 0.25)  # GC-0.5 ref rows


def test_sample_jobs_cap(rng):
    jobs = _synthetic_jobs(rng, n_pairs=10, length=50)
    capped = sample_jobs(jobs, max_bases=120, seed=0)
    assert sum(len(j.read_region) for j in capped) <= 120
    assert len(capped) >= 1


def test_checkpoint_roundtrip(tmp_path):
    ck = EmCheckpoint(
        trial=1, iteration=7,
        transitions=np.full((5, 5), 0.2),
        emissions=np.full((5, 16), 1 / 16),
        likelihood_history=[-10.0, -9.0],
        best_trial_likelihood=-8.5,
        best_transitions=np.eye(5),
        best_emissions=np.full((5, 16), 1 / 16),
    )
    path = str(tmp_path / "em.ckpt")
    ck.save(path)
    back = EmCheckpoint.load(path)
    assert back.trial == 1 and back.iteration == 7
    assert back.likelihood_history == [-10.0, -9.0]
    assert np.allclose(back.best_transitions, np.eye(5))


def test_em_resume_matches_uninterrupted(rng, tmp_path):
    jobs = _synthetic_jobs(rng, n_pairs=6, length=40)
    base = EmOptions(trials=1, iterations=6, band_width=15, seed=2,
                     tolerance=0.0)

    full = train_em(jobs, base)

    # Simulate a crash after 3 iterations: the per-iteration checkpoint
    # written inside the loop is what a real interruption leaves behind.
    ckpt = str(tmp_path / "em.ckpt")

    class _Boom(Exception):
        pass

    calls = {"n": 0}

    def crashing_log(_msg):
        calls["n"] += 1
        if calls["n"] == 4:  # during the 4th iteration, after 3 saves
            raise _Boom()

    with pytest.raises(_Boom):
        train_em(jobs, base, checkpoint_path=ckpt, log_fn=crashing_log)
    ck = EmCheckpoint.load(ckpt)
    assert ck.trial == 0 and 0 < ck.iteration < 6

    resumed = train_em(jobs, base, checkpoint_path=ckpt)

    assert np.allclose(
        resumed.hmm.transitions, full.hmm.transitions, atol=1e-5
    )
    assert np.allclose(resumed.hmm.emissions, full.hmm.emissions, atol=1e-5)


@pytest.mark.parametrize("model_type", [
    "fiveState", "threeState", "threeStateAsymmetric",
])
def test_em_model_families(rng, model_type, tmp_path):
    """All four model families train and satisfy their constraints
    (reference surface: cPecanEm modelType, marginAlign.py:40)."""
    jobs = _synthetic_jobs(rng, n_pairs=6, length=40)
    opts = EmOptions(trials=1, iterations=4, band_width=15, seed=4,
                     model_type=model_type, tolerance=0.0)
    result = train_em(jobs, opts)
    hmm = result.hmm
    hmm.check()
    if model_type.startswith("threeState"):
        assert np.all(hmm.transitions[:3, 3:] == 0)
        assert hmm.transitions[3, 3] == 1.0
        assert hmm.native_state_number == 3
        # Round-trips through the 3-state on-disk format.
        p = str(tmp_path / "m3.hmm")
        hmm.write(p)
        back = PairHmm.load(p)
        assert back.native_state_number == 3
        assert np.allclose(back.transitions[:3, :3], hmm.transitions[:3, :3])
    if model_type in ("fiveState", "threeState"):
        swap = [0, 2, 1, 4, 3]
        t = hmm.transitions
        assert np.allclose(t, t[swap][:, swap], atol=1e-9)
        e = hmm.emissions.reshape(5, 4, 4)
        assert np.allclose(e, e[swap].transpose(0, 2, 1), atol=1e-9)
    hist = result.likelihood_history
    assert all(b >= a - 1e-2 for a, b in zip(hist, hist[1:])), hist


def test_em_split_at_anchors_matches_unsplit():
    """EM with the reference's splitMatrixBiggerThanThis=300 (now the
    EmOptions default; src/margin/marginAlign.py:41) trains to nearly the
    same parameters as exact full-length DP on longer-than-300 problems.
    Own fixed-seed rng: the trajectory comparison is data-sensitive."""
    from marginalign_trna_tpu.align.realign import split_jobs_at_anchors

    rng = np.random.default_rng(42)
    jobs = _synthetic_jobs(rng, n_pairs=5, length=420, sub_rate=0.12)
    segs, _, _ = split_jobs_at_anchors(jobs, 300)
    assert len(segs) > len(jobs)  # the default really splits these

    inp = PairHmm.load(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "marginalign_trna_tpu", "models", "last_hmm_20.txt"))
    # 10 iterations: split/unsplit trajectories pass through a transient
    # phase difference around iterations 3-6 (emissions move ~0.15/step
    # there) before converging to the same optimum.
    base = dict(trials=1, iterations=10, band_width=15, seed=8,
                tolerance=0.0, random_start=False)
    split = train_em(jobs, EmOptions(split_size=300, **base), input_hmm=inp)
    unsplit = train_em(jobs, EmOptions(split_size=0, **base), input_hmm=inp)
    assert np.allclose(split.hmm.transitions, unsplit.hmm.transitions,
                       atol=0.02), (split.hmm.transitions,
                                    unsplit.hmm.transitions)
    assert np.isclose(split.likelihood, unsplit.likelihood, rtol=0.01)
    # Compare the PIPELINE artifact (post-EM normalisation flattens the
    # under-determined gap-emission rows, marginAlignLib.py:227-232 —
    # raw low-occupancy gap rows are noise-level between any two
    # near-identical trainings).
    ns = normalise_trained_hmm(split.hmm)
    nu = normalise_trained_hmm(unsplit.hmm)
    assert np.allclose(ns.emissions, nu.emissions, atol=0.02)


def test_em_use_default_model_as_start(rng):
    """useDefaultModelAsStart: trial 0 starts from the input model (the
    remaining trials stay random); with trials=1 the result equals a
    noRandomStart run, and differs from a pure random start."""
    jobs = _synthetic_jobs(rng, n_pairs=4, length=30)
    inp = PairHmm.random(seed=42)
    base = dict(trials=1, iterations=1, band_width=15, seed=6,
                tolerance=0.0)
    a = train_em(jobs, EmOptions(use_default_model_as_start=True, **base),
                 input_hmm=inp)
    b = train_em(jobs, EmOptions(random_start=False, **base), input_hmm=inp)
    assert np.allclose(a.hmm.transitions, b.hmm.transitions, atol=1e-6)
    assert np.allclose(a.hmm.emissions, b.hmm.emissions, atol=1e-6)
    c = train_em(jobs, EmOptions(**base), input_hmm=inp)
    assert not np.allclose(c.hmm.transitions, a.hmm.transitions, atol=1e-3)


def test_em_option_surface(rng, tmp_path):
    """outputTrialHmms / tieEmissions / Jukes-Cantor starts / XML dump."""
    jobs = _synthetic_jobs(rng, n_pairs=4, length=30)
    trial_path = str(tmp_path / "out.hmm")
    opts = EmOptions(trials=2, iterations=2, band_width=15, seed=6,
                     tie_emissions=True, output_trial_hmms_path=trial_path,
                     jukes_cantor_start=0.3, tolerance=0.0)
    result = train_em(jobs, opts)
    assert os.path.exists(trial_path + ".trial0")
    assert os.path.exists(trial_path + ".trial1")
    hmm = result.hmm
    assert np.allclose(hmm.emissions[1], hmm.emissions[3])
    assert np.allclose(hmm.emissions[2], hmm.emissions[4])
    xml_path = str(tmp_path / "m.xml")
    hmm.write_xml(xml_path)
    import xml.etree.ElementTree as ET
    root = ET.parse(xml_path).getroot()
    assert root.tag == "hmm"
    assert len(root.find("transitions")) == 25


def test_em_update_the_band(rng):
    """updateTheBand: band re-derivation from the current model runs for
    both lockstep and serial trials and still trains a valid improving
    model (reference: cPecanEm updateTheBand, shipped commented out at
    marginAlign.py:50 — semantics [reconstructed])."""
    jobs = _synthetic_jobs(rng, n_pairs=8, length=50)
    for lockstep in (False, True):
        opts = EmOptions(
            trials=2 if lockstep else 1, iterations=4, band_width=15,
            seed=5, split_size=0, lockstep=lockstep, update_band_every=1,
        )
        best = train_em(jobs, opts)
        assert np.isfinite(best.likelihood)
        assert len(best.likelihood_history) >= 2
        # Training still helps despite band changes between iterations.
        assert best.likelihood_history[-1] > best.likelihood_history[0]
        best.hmm.check()


@pytest.mark.parametrize("trials,lockstep,want", [
    (3, True, 3), (1, True, 1), (3, False, 1),
])
def test_em_batch_budget_divides_among_lockstep_trials(
        rng, monkeypatch, trials, lockstep, want):
    """The E-step batches of a lockstep run share the device budget among
    the trials that the vmap stacks; serial trials take it whole."""
    from marginalign_trna_tpu.ops import dispatch

    asked = []
    real = dispatch.max_batch_cells_for

    def spy(stage, device=None, trials=1):
        asked.append((stage, trials))
        return real(stage, device, trials)

    monkeypatch.setattr(dispatch, "max_batch_cells_for", spy)
    train_em(_synthetic_jobs(rng, n_pairs=4, length=30),
             EmOptions(trials=trials, iterations=1, band_width=9,
                       lockstep=lockstep))
    assert asked == [("em", want)]
