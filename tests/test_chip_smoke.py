"""chip_smoke.py rehearsed on the CPU backend at its tiny size."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, devices, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"),
               XLA_FLAGS="--xla_force_host_platform_device_count=%d"
               % devices)
    env.pop("MARGINALIGN_LOCAL_DEVICES", None)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")] + args,
        capture_output=True, text=True, env=env, timeout=600,
    )


@pytest.mark.parametrize("args,devices", [
    (["--rehearse"], 1), (["--rehearse", "--devices", "4"], 4),
])
def test_chip_smoke_rehearsal(tmp_path, args, devices):
    r = _run(args, devices, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": devices}}
    phases = [json.loads(ln)["phase"] for ln in lines if ln.startswith("{")
              and "phase" in ln]
    want = (["device", "multi_device"] if devices > 1 else
            ["device", "compile", "reference", "marginAlign", "caller", "em"])
    assert phases == want


def test_chip_smoke_refuses_cpu_without_rehearse(tmp_path):
    r = _run([], 1, tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr
