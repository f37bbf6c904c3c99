import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def run_with_devices(code: str, n_devices: int = 8, timeout: int = 560) -> str:
    """Run python code in a subprocess with N virtual CPU devices.

    Needed because jax locks the device count at first init; the main test
    process stays single-device (per the assignment: smoke tests see 1
    device).
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout, env=env)
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:\n{proc.stdout}\n"
            f"STDERR:\n{proc.stderr}")
    return proc.stdout


@pytest.fixture
def subproc():
    return run_with_devices


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU with CUDA (skips without one)")
