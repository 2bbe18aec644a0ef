"""Checks that need a CUDA card (marker `gpu`; they skip elsewhere).

Run on a GPU host: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""
import os
import sys

import pytest

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.gpu
def test_frame_on_card_matches_cpu(gpu_device, analytic_scene_path):
    """One interactive frame (spp 1, 5 bounces) of the analytic canonical
    scene on the card against the CPU, at chip_smoke's tolerances."""
    import chip_smoke as cs
    from raytracevs_tpu.ops.render import render_frame
    from raytracevs_tpu.runtime.engine import Engine

    eng = Engine(128, 64, device_mesh=None)
    eng.load_rtvs(analytic_scene_path, samples_per_pixel=1, max_bounces=5)
    out = {}
    for name, dev in (("card", gpu_device), ("cpu", jax.devices("cpu")[0])):
        out[name] = jax.device_get(render_frame(jax.device_put(eng._flat, dev), eng._cfg))
    rays = float(out["card"].rays), float(out["cpu"].rays)
    assert abs(rays[0] - rays[1]) <= cs.RAYS_RTOL * rays[1]
    cs.compare("hdr", out["card"].color, out["cpu"].color)
    cs.compare("view_z", out["card"].gbuffer.view_z[:, None],
               out["cpu"].gbuffer.view_z[:, None])
