"""The measurement entry points on the CPU: chip_smoke.py's phases at nano
size, the four-device phase on virtual devices, and the refusals (no GPU,
removed backend names) that keep a CPU run from passing for a card run."""

import os
import subprocess
import sys

import jax
import pytest

import chip_smoke
import tfhe_jax as tfhe
from tfhe_jax.params import get_params

NANO = get_params("nano")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def nano_keys():
    (ck, sk) = chip_smoke.run_phase("keygen", chip_smoke.keygen_phase, NANO)
    return ck, sk


def test_device_check_refuses_cpu():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu(jax.devices())


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_exits_nonzero_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout
    assert "GPU" in r.stderr


def test_gates_phase_nano(nano_keys, capsys):
    ck, sk = nano_keys
    chip_smoke.run_phase("gates", chip_smoke.gates_phase, NANO, ck, sk,
                         (1, 8), "cpu", 2)
    out = capsys.readouterr().out
    assert "B=1 (conv): 0/1 gate errors" in out
    assert "B=8 (conv): 0/8 gate errors" in out


def test_gates_phase_fails_on_wrong_key(nano_keys):
    ck, _ = nano_keys
    _, other = tfhe.keygen(NANO, jax.random.key(99))
    with pytest.raises(chip_smoke.SmokeFailure, match="gate errors"):
        chip_smoke.gates_phase(NANO, ck, other, (64,), "cpu", 1)


def test_golden_phase_nano(capsys):
    chip_smoke.run_phase("golden", chip_smoke.golden_phase, NANO)
    out = capsys.readouterr().out
    assert "golden sample(s) bit-exact for conv, matmul, ntt, ntts" in out
    assert "bmmp bit-identical through conv, matmul, ntts" in out


def test_adder_phase_nano(nano_keys):
    ck, sk = nano_keys
    chip_smoke.adder_phase(NANO, ck, sk, 8, 16)


def test_cli_phase_nano():
    _, summary = chip_smoke.cli_phase("nano")
    assert summary.endswith("= 1110")


def test_four_phase_on_virtual_devices():
    _, summary = chip_smoke.four_phase(NANO, jax.devices()[:4], 16, "cpu", 1)
    assert "{'batch': 4, 'model': 1}: bit-identical" in summary
    assert "{'batch': 2, 'model': 2}: bit-identical" in summary


def test_gpu_tests_phase_fails_without_a_card():
    """Without a card the ``gpu`` tests skip or error, which must fail the
    phase."""
    with pytest.raises(chip_smoke.SmokeFailure, match="gpu tests"):
        chip_smoke.gpu_tests_phase()


@pytest.mark.parametrize("impl", ["pallas", "fusedb"])
def test_cli_refuses_removed_backend(impl, tmp_path):
    from tfhe_jax.cli import main

    with pytest.raises(SystemExit) as e:
        main(["gate", "--server", str(tmp_path / "s.npz"), "--op", "nand",
              "--lhs", "a", "--rhs", "b", "--out", "o", "--impl", impl])
    assert e.value.code == 2


def test_memory_limit_comes_from_the_device():
    """No built-in device-memory constant: a device that reports no limit
    (the CPU) needs an explicit ``hbm_bytes``."""
    from tfhe_jax.parallel.mesh import device_bytes_limit, make_mesh, plan_key_placement

    with pytest.raises(ValueError, match="reports no memory limit"):
        device_bytes_limit(jax.devices()[0])
    mesh = make_mesh(batch=4, model=2)
    with pytest.raises(ValueError, match="pass hbm_bytes"):
        plan_key_placement(get_params("default_128"), mesh)


def test_ntt_key_guard_reads_free_device_memory(monkeypatch):
    from tfhe_jax.models import keys as mkeys

    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 1 << 20, "bytes_in_use": 0}

    _, sk = tfhe.keygen(get_params("test_insecure"), jax.random.key(1))
    monkeypatch.setattr(mkeys.jax, "devices", lambda: [Dev()])
    with pytest.raises(ValueError, match="impl='ntts'"):
        mkeys.with_ntt_key(sk)
