"""The entry points in __graft_entry__ must work as shipped.

dryrun_multichip must not assume the host already exposes n devices: on a
one-accelerator host JAX initializes that device first. It self-provisions
a virtual CPU mesh — in-process when JAX is uninitialized, via subprocess
re-exec when a backend already claimed the process.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_inprocess():
    # conftest already provisioned 8 virtual CPU devices; the in-process
    # path must be taken and pass.
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as g

        g.dryrun_multichip(8)
    finally:
        sys.path.remove(REPO)


def test_dryrun_multichip_self_provisions_smoke():
    # Fast-tier guard on the graded driver contract (the full 8-device
    # variant is nightly): JAX pre-initialized with ONE device, dryrun
    # must re-exec itself with a forced 2-device virtual CPU platform.
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "assert len(jax.devices()) == 1\n"
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(2)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.nightly
def test_dryrun_multichip_self_provisions_like_driver():
    # Simulate the driver host: JAX pre-initialized with ONE device before
    # dryrun_multichip is called. The dry run must still succeed by
    # re-executing itself with a forced 8-device virtual CPU platform.
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "assert len(jax.devices()) == 1\n"
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(8)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=1200,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
