"""PairHmm codec and surgery tests against the reference model files."""
import os

import numpy as np
import pytest

from marginalign_trna_tpu.models.hmm import PairHmm, SYMBOL_NUMBER

MODELS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "marginalign_trna_tpu", "models",
)


def test_load_reference_model():
    hmm = PairHmm.load(os.path.join(MODELS, "last_hmm_20.txt"))
    assert hmm.model_type == 1
    assert hmm.transitions.shape == (5, 5)
    assert np.allclose(hmm.transitions.sum(axis=1), 1.0, atol=1e-5)
    assert np.allclose(hmm.emissions.sum(axis=1), 1.0, atol=1e-5)
    # Indel states are flat 1/16 in the shipped models.
    assert np.allclose(hmm.emissions[1:], 1.0 / 16.0)


def test_write_roundtrip(tmp_path):
    hmm = PairHmm.load(os.path.join(MODELS, "last_hmm_20.txt"))
    path = str(tmp_path / "m.hmm")
    hmm.write(path)
    hmm2 = PairHmm.load(path)
    assert np.allclose(hmm.transitions, hmm2.transitions, atol=0)
    assert np.allclose(hmm.emissions, hmm2.emissions, atol=0)
    assert hmm.likelihood == hmm2.likelihood


def test_substitution_rate_relaxation_matches_shipped_models():
    """last_hmm_20/40 are last_hmm_0 with 0.2/0.4 substitution-rate surgery
    (reference: modifyHmmEmissionsByExpectedVariationRate,
    marginAlignLib.py:258-263)."""
    base = PairHmm.load(os.path.join(MODELS, "last_hmm_0.txt"))
    for rate, name in [(0.2, "last_hmm_20.txt"), (0.4, "last_hmm_40.txt")]:
        h = base.copy()
        h.modify_by_substitution_rate(rate)
        shipped = PairHmm.load(os.path.join(MODELS, name))
        assert np.allclose(h.emissions[0], shipped.emissions[0], atol=1e-9), name
        assert np.allclose(h.transitions, shipped.transitions)


def test_flat_indels():
    hmm = PairHmm.random(seed=0)
    hmm.set_flat_indel_emissions()
    assert np.allclose(hmm.emissions[1:], 1.0 / 16.0)
    hmm.check()


def test_gc_normalisation():
    hmm = PairHmm.random(seed=1)
    hmm.normalise_by_gc_content(0.5)
    hmm.check()
    # Ref-emitting states have per-ref-base mass 1/4 at gc=0.5.
    for s in (0, 1, 3):
        e = hmm.emissions[s].reshape(4, 4)
        assert np.allclose(e.sum(axis=1), 0.25)
    # Asymmetric GC: C and G rows carry gc/2 of the mass.
    hmm2 = PairHmm.random(seed=2)
    hmm2.normalise_by_gc_content(0.8)
    e = hmm2.emissions[0].reshape(4, 4)
    assert np.allclose(e[1].sum(), 0.4) and np.allclose(e[2].sum(), 0.4)
    assert np.allclose(e[0].sum(), 0.1) and np.allclose(e[3].sum(), 0.1)


def test_substitution_matrix_rows():
    hmm = PairHmm.load(os.path.join(MODELS, "last_hmm_20.txt"))
    sub = hmm.substitution_matrix()
    assert np.allclose(sub.sum(axis=1), 1.0)


def test_match_emissions_5x5_wildcard():
    hmm = PairHmm.load(os.path.join(MODELS, "last_hmm_20.txt"))
    t = hmm.match_emissions_5x5()
    e = hmm.emissions[0].reshape(4, 4)
    assert np.allclose(t[:4, :4], e)
    assert np.allclose(t[4, :4], e.mean(axis=0))
    assert np.allclose(t[:4, 4], e.mean(axis=1))


def test_random_start_is_stochastic():
    hmm = PairHmm.random(seed=7)
    hmm.check()
    hmm2 = PairHmm.random(seed=7)
    assert np.allclose(hmm.transitions, hmm2.transitions)
    hmm3 = PairHmm.random(seed=8)
    assert not np.allclose(hmm.transitions, hmm3.transitions)
