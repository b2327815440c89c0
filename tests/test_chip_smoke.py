"""The GPU smoke script's contract, checked without a GPU: it refuses
the CPU, fails outside a checkout, and its last line is exact."""
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


def test_device_check_refuses_cpu():
    with pytest.raises(SystemExit, match="platform 'cpu'"):
        chip_smoke.require_gpu(jax.devices("cpu"))


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_script_exits_nonzero_without_result(where, tmp_path):
    if where == "checkout":
        r = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
        assert "platform 'cpu'" in r.stderr
    else:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        r = _run(str(tmp_path / "chip_smoke.py"), tmp_path)
        assert "mfs_tpu" in r.stderr
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("count", [1, 4])
def test_contract_line_is_exact(count):
    devices = [types.SimpleNamespace(platform="gpu", device_kind=H100)] * count
    line = chip_smoke.contract_line(devices)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        f'"kind": "{H100}", "count": {count}}}}}'
    )
    assert json.loads(line)["device"]["count"] == count
