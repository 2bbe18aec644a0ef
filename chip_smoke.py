#!/usr/bin/env python
"""Smoke test of the render path on one CUDA card.

Drives the canonical scene (assets/sample_scene.rtvs) through the entry
points a user calls (the CLI and `Engine`) at 1920x1080, checks every output
and compares the card with the plain CPU reference. Each phase prints one
line; a failing phase ends the script with exit code 1. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage:
    python chip_smoke.py           # one card: phases 1-6
    python chip_smoke.py --four    # four cards: row-sharded interactive
                                   # frames against the same frames on one

Refuses to run (exit 1, no result line) when JAX finds no GPU.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracevs_tpu import constants as C  # noqa: E402
from raytracevs_tpu.api import cli  # noqa: E402
from raytracevs_tpu.io.png import read_png  # noqa: E402
from raytracevs_tpu.ops.render import render_rows  # noqa: E402
from raytracevs_tpu.post import denoise as denoise_mod  # noqa: E402
from raytracevs_tpu.runtime.cache import enable_compilation_cache  # noqa: E402
from raytracevs_tpu.runtime.engine import Engine, _render_pipeline  # noqa: E402

SCENE = os.path.join(REPO, "assets", "sample_scene.rtvs")
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
# The interactive configuration: the reference's defaults (README.md:228).
INTERACTIVE = dict(samples_per_pixel=1, max_bounces=5, enable_denoiser=True)
ORBIT_DEG = 2.0
# Card vs CPU reference (phase 5). Transcendentals differ by a few ULP
# between XLA's CPU and GPU backends, which can flip a Fresnel or TIR branch
# on a few lanes; the RNG is integer PCG and bit-exact.
RAYS_RTOL = 1e-3
PIXEL_ATOL = PIXEL_RTOL = 1e-3
PIXEL_SHARE_MIN = 0.995
MEAN_ABS_REL_MAX = 1e-3


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"
    return proc.stdout.strip().replace("\n", " | ") or proc.stderr.strip()


def peak_bytes(device) -> object:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not measured")


def run_cli(args) -> dict:
    """api.cli.main with --json; returns its stats line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in args] + ["--json"])
    check(rc == 0, f"cli exited {rc}: {buf.getvalue()[-500:]}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


# ---- phases ----------------------------------------------------------------

def phase_device() -> dict:
    import jaxlib

    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"no GPU: jax.devices()[0].platform is {dev.platform!r}")
    info = dict(device_kind=repr(dev.device_kind), count=len(jax.devices()),
                jax=jax.__version__, jaxlib=jaxlib.__version__,
                XLA_FLAGS=repr(os.environ.get("XLA_FLAGS", "")),
                compile_cache=enable_compilation_cache())
    emit("device", **info)
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    return info


def phase_offline(width, height, scene=SCENE, out_dir=OUT_DIR, frames=2) -> dict:
    """Scene-carried settings (spp 16 capped by the ray budget, 10 bounces,
    denoiser on) through the CLI; the PNG must decode and not be flat."""
    png = os.path.join(out_dir, "offline.png")
    st = run_cli([scene, "-o", png, "-W", width, "-H", height,
                  "--frames", frames])
    img = read_png(png)
    check(img.shape == (height, width, 4), f"PNG shape {img.shape}")
    check(img[..., :3].std() > 1.0, "PNG is constant")
    check(st["rays_per_frame"] > 0, "no rays traced")
    res = dict(first_frame_ms=st["first_frame_ms"],
               steady_ms=st["steady_frame_ms"], mrays_per_s=st["mrays_per_s"],
               rays_per_frame=st["rays_per_frame"],
               peak_bytes_in_use=peak_bytes(jax.devices()[0]))
    emit("offline", **res)
    return res


def phase_interactive(width, height, scene=SCENE, out_dir=OUT_DIR, frames=8) -> dict:
    """spp 1, 5 bounces, denoiser on, orbiting camera (history carried by
    motion vectors) through the CLI, then the frame step's memory analysis."""
    png = os.path.join(out_dir, "interactive.png")
    st = run_cli([scene, "-o", png, "-W", width, "-H", height,
                  "--spp", 1, "--bounces", 5, "--denoise",
                  "--frames", frames, "--orbit", ORBIT_DEG])
    img = read_png(png)
    check(img[..., :3].std() > 1.0, "interactive PNG is constant")
    eng = interactive_engine(width, height, scene)
    state = denoise_mod.init_state(height, width)
    ma = _render_pipeline.lower(eng._flat, eng._cfg, state).compile().memory_analysis()
    mem = {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")} if ma else None
    res = dict(first_frame_ms=st["first_frame_ms"],
               steady_ms=st["steady_frame_ms"], mrays_per_s=st["mrays_per_s"],
               memory_analysis=json.dumps(mem))
    emit("interactive", **res)
    return res


def interactive_engine(width, height, scene=SCENE, device_mesh=None, **extra):
    eng = Engine(width, height, device_mesh=device_mesh)
    eng.load_rtvs(scene, **INTERACTIVE, **extra)
    return eng


def phase_caustics(width, height, scene=SCENE, out_dir=OUT_DIR) -> dict:
    """The interactive config with --caustics once through the CLI, then the
    caustic term: the HDR frame with caustics minus the same frame (same
    RNG frame index) without them."""
    st = run_cli([scene, "-o", os.path.join(out_dir, "caustics.png"),
                  "-W", width, "-H", height, "--spp", 1, "--bounces", 5,
                  "--denoise", "--caustics"])
    hdr = {}
    for on in (True, False):
        eng = interactive_engine(width, height, scene, enable_caustics=on)
        eng.render()
        hdr[on] = np.asarray(eng.last_hdr, np.float64)
        if on:
            photons = eng._cfg.num_photons
    term = hdr[True] - hdr[False]
    check(photons > 0, "caustics on but no photon budget")
    check(np.isfinite(term).all(), "caustic term not finite")
    lit = np.abs(term).max(axis=-1) > 0
    check(lit.any(), "caustic term is zero everywhere")
    res = dict(first_frame_ms=st["first_frame_ms"], photons=photons,
               caustic_pixels=int(lit.sum()), caustic_sum=float(term.sum()))
    emit("caustics", **res)
    return res


def compare(name, got, ref) -> dict:
    """Share of pixels within atol+rtol on every channel, and the mean
    absolute difference relative to the reference's mean magnitude."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    check(np.isfinite(got).all() and np.isfinite(ref).all(), f"{name}: non-finite")
    err = np.abs(got - ref)
    ok = (err <= PIXEL_ATOL + PIXEL_RTOL * np.abs(ref)).all(axis=-1)
    share = float(ok.mean())
    mean_rel = float(err.mean() / max(np.abs(ref).mean(), 1e-12))
    worst = np.argsort(err.max(axis=-1))[::-1][:3]
    res = dict(within=share, outside=1.0 - share, mean_abs_rel=mean_rel,
               worst=";".join(f"px{int(i)}:{err[i].max():.3g}" for i in worst))
    emit(f"parity.{name}", **res)
    check(share >= PIXEL_SHARE_MIN,
          f"{name}: {share:.5f} of pixels within tolerance < {PIXEL_SHARE_MIN}")
    check(mean_rel <= MEAN_ABS_REL_MAX,
          f"{name}: mean abs diff {mean_rel:.3g} of the mean > {MEAN_ABS_REL_MAX}")
    return res


def slab_row(gbuffer, flat, width, height, rows) -> int:
    """First row of the `rows`-row slab holding the most pixels of both the
    glass spheres and the mesh, if the scene has one (obj_id = type * 65536
    + index)."""
    oid = np.asarray(gbuffer.obj_id).reshape(height, width)
    trans = np.asarray(flat.mat_transmission)[:flat.sphere_capacity]
    per_row = [np.isin(oid, np.flatnonzero(trans > 0.01)).sum(axis=1)]
    if flat.mesh is not None:
        per_row.append((oid // 65536 == C.OBJECT_TYPE_MESH).sum(axis=1))
    best, best_row = 0, None
    for r in range(0, height - rows + 1, 8):
        score = min(int(c[r:r + rows].sum()) for c in per_row)
        if score > best:
            best, best_row = score, r
    check(best_row is not None, "no slab crosses the glass sphere and the mesh")
    return best_row


def phase_parity(width, height, scene=SCENE, rows=16, frames=3,
                 ref_device=None) -> dict:
    """Card against the CPU reference in one process: a full-width slab of
    `rows` rows through render_rows, then the card's G-buffers of `frames`
    orbiting frames through denoise_frame at full size."""
    dev = jax.devices()[0]
    ref_device = ref_device or jax.devices("cpu")[0]
    eng = interactive_engine(width, height, scene, device_mesh=None)
    orbit = cli.Orbit(eng, INTERACTIVE)
    gbufs = []
    for f in range(frames):
        if f:
            orbit.set_angle(ORBIT_DEG * f)
        eng.render()
        gbufs.append(jax.device_get(eng._last_gbuffer))
    orbit.set_angle(0.0)
    flat, cfg = eng._flat, eng._cfg
    r0 = slab_row(gbufs[0], flat, width, height, rows)

    slab = jax.jit(render_rows, static_argnums=(1, 3))
    out = {}
    for name, d in (("card", dev), ("ref", ref_device)):
        out[name] = jax.device_get(
            slab(jax.device_put(flat, d), cfg, jax.device_put(jnp.int32(r0), d), rows))
    rays = float(out["card"].rays), float(out["ref"].rays)
    emit("parity.slab", row_start=r0, rows=rows, width=width,
         rays_card=rays[0], rays_ref=rays[1])
    check(abs(rays[0] - rays[1]) <= RAYS_RTOL * rays[1],
          f"ray counts differ: {rays}")
    res = {"slab_hdr": compare("slab_hdr", out["card"].color, out["ref"].color)}

    denoise = jax.jit(denoise_mod.denoise_frame, static_argnums=(1, 2))
    devs = (dev, ref_device)
    state = [jax.device_put(denoise_mod.init_state(height, width), d) for d in devs]
    for f, g in enumerate(gbufs):
        planes = []
        for k, d in enumerate(devs):
            *p, state[k] = denoise(jax.device_put(g, d), height, width, state[k])
            planes.append(jax.device_get(p))
        for name, a, b in zip(("diffuse", "specular", "shadow"), *planes):
            res[f"denoise{f}_{name}"] = compare(f"denoise{f}.{name}", a, b)
    return res


def phase_validate(width, height, scene=SCENE) -> dict:
    eng = interactive_engine(width, height, scene, device_mesh=None)
    res = eng.validate_frame()
    emit("validate", ok=res["ok"], violations=json.dumps(res["violations"]))
    check(res["ok"], f"validate_frame: {res['violations']}")
    return res


def phase_four(width, height, scene=SCENE, frames=4, n_dev=4) -> dict:
    """The interactive config row-sharded over `n_dev` cards against the
    same orbiting frames on card 0 alone; RGBA8 frames must be equal or
    differ by at most 1 LSB on all but 0.1% of pixels (the sharded denoiser
    filters the same values in another fusion order)."""
    from raytracevs_tpu.parallel.tiles import make_mesh

    devices = jax.devices()
    check(len(devices) >= n_dev, f"needs {n_dev} devices, found {len(devices)}")
    res = {}
    imgs = {}
    for name, mesh in (("sharded", make_mesh(devices[:n_dev])), ("single", None)):
        eng = interactive_engine(width, height, scene, device_mesh=mesh)
        orbit = cli.Orbit(eng, INTERACTIVE)
        imgs[name], times = [], []
        for f in range(frames):
            if f:
                orbit.set_angle(ORBIT_DEG * f)
            imgs[name].append(eng.render().astype(np.int32))
            times.append(eng.last_render_ms)
        res[f"{name}_first_ms"] = times[0]
        res[f"{name}_steady_ms"] = float(np.mean(times[1:])) if frames > 1 else None
    diffs = [np.abs(a - b).max(axis=-1) for a, b in zip(imgs["sharded"], imgs["single"])]
    res["identical_frames"] = sum(int((d == 0).all()) for d in diffs)
    res["max_lsb"] = int(max(d.max() for d in diffs))
    res["share_within_1lsb"] = float(min((d <= 1).mean() for d in diffs))
    emit("four", n_dev=n_dev, **res)
    check(res["share_within_1lsb"] >= 0.999,
          f"sharded frames differ: {res['share_within_1lsb']:.5f} within 1 LSB")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded comparison")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    W, H = 1920, 1080
    if args.four:
        phases = [("device", phase_device),
                  ("four", lambda: phase_four(W, H))]
    else:
        phases = [("device", phase_device),
                  ("output", lambda: os.makedirs(OUT_DIR, exist_ok=True)),
                  ("offline", lambda: phase_offline(W, H)),
                  ("interactive", lambda: phase_interactive(W, H)),
                  ("caustics", lambda: phase_caustics(W, H)),
                  ("parity", lambda: phase_parity(W, H)),
                  ("validate", lambda: phase_validate(W, H))]
    for name, fn in phases:
        t = time.perf_counter()
        try:
            fn()
        except SmokeFailure as e:
            print(f"FAIL {name}: {e}", flush=True)
            return 1
        print(f"[{name}] wall_s={time.perf_counter() - t:.1f}", flush=True)
    dev = jax.devices()[0]
    print(f"total_wall_s={time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
