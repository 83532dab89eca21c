"""Test configuration: JAX on a virtual 8-device CPU mesh, seeded fixtures.

Tests run with JAX_PLATFORMS=cpu; XLA_FLAGS gives the CPU backend eight
virtual devices so the sharding, collective and round-robin tests exercise a
multi-device topology.  Every input file is generated from a seed
(tests/synthetic.py) into a session directory; models load from
marginalign_trna_tpu/models/.  Tests marked `gpu` compare the engines on a
card with the CPU backend and skip here; run them on one with
`JAX_PLATFORMS=cuda python -m pytest tests -m gpu`.
"""
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

MODELS = os.path.join(REPO, "marginalign_trna_tpu", "models")
MODEL = os.path.join(MODELS, "last_hmm_20.txt")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def fixtures_dir(tmp_path_factory):
    import synthetic

    path = str(tmp_path_factory.mktemp("fixtures"))
    synthetic.write_fixtures(path)
    return path


@pytest.fixture(scope="session")
def fixture_facts(fixtures_dir):
    with open(os.path.join(fixtures_dir, "facts.json")) as fh:
        return json.load(fh)


@pytest.fixture
def gpu():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU")
    return dev
