"""Test configuration: force CPU with 8 virtual devices.

Multi-device sharding tests run on a virtual CPU mesh
(xla_force_host_platform_device_count), the standard way to validate
shard_map layouts without several accelerators. Tests marked `gpu` need a
CUDA device and skip elsewhere; the `gpu_device` fixture decides.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_platforms", "cpu")
# The Engine turns on the persistent compilation cache; tests keep it off.
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE_SCENE = os.path.join(REPO, "assets", "sample_scene.rtvs")


@pytest.fixture(scope="session")
def sample_scene_path():
    return SAMPLE_SCENE


def analytic_scene_file() -> str:
    """sample_scene.rtvs minus its FBX nodes (cached in the tmp dir).

    The canonical scene renders WITH its 5.9k-triangle wine glass, which
    makes every CPU render of it slow. Tests whose subject is NOT the mesh
    path (goldens, viewer plumbing, CLI animation) use this analytic
    subset; the full scene stays covered by test_rtvs/test_cli."""
    import json
    import tempfile

    path = os.path.join(tempfile.gettempdir(), "rtvs_sample_analytic.rtvs")
    with open(SAMPLE_SCENE) as f:
        doc = json.load(f)
    doc["Nodes"] = [n for n in doc["Nodes"] if "FBX" not in n.get("Type", "")]
    tmp = f"{path}.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)  # atomic: xdist workers share the tmp dir
    return path


@pytest.fixture(scope="session")
def analytic_scene_path():
    return analytic_scene_file()


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test on hosts without one."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a CUDA device (JAX_PLATFORMS=cuda,cpu pytest -m gpu)")
    return devices[0]


def pytest_collection_modifyitems(config, items):
    """Fast/nightly split: the slow parity suites run only with
    RTVS_NIGHTLY=1."""
    if os.environ.get("RTVS_NIGHTLY"):
        return
    skip = pytest.mark.skip(reason="nightly suite; set RTVS_NIGHTLY=1")
    for item in items:
        if "nightly" in item.keywords:
            item.add_marker(skip)
