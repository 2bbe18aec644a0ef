"""Command-line renderer: .rtvs scene file -> PNG.

The headless equivalent of the reference's RenderWindow toolbar path
(Views/RenderWindow.xaml.cs:244 StartRenderingFromToolbar).

Usage:
    python -m raytracevs_tpu.api.cli scene.rtvs -o out.png -W 1920 -H 1080
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np


class Orbit:
    """Turns an engine's frame-0 camera around the vertical axis through
    its look-at point. Geometry is unchanged, so the engine's content
    checksum keeps the temporal history and the denoiser reprojects
    through the motion vectors (utils/checksum.py)."""

    def __init__(self, engine, overrides=None):
        self.engine = engine
        self.overrides = dict(overrides or {})
        cam = engine._scene.camera
        self.look = np.asarray(cam.look_at, dtype=float).copy()
        self.rel = np.asarray(cam.position, dtype=float) - self.look

    def set_angle(self, degrees: float) -> None:
        """Place the camera `degrees` around the orbit and re-upload."""
        ang = math.radians(degrees)
        c, s = math.cos(ang), math.sin(ang)
        r = self.rel
        scene = self.engine._scene
        scene.camera.position = self.look + np.array(
            [r[0] * c + r[2] * s, r[1], -r[0] * s + r[2] * c])
        self.engine.update_scene(scene, **self.overrides)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Render a .rtvs scene to PNG.")
    p.add_argument("scene", help="path to the .rtvs scene file")
    p.add_argument("-o", "--output", default="render.png", help="output PNG path")
    p.add_argument("-W", "--width", type=int, default=1920)
    p.add_argument("-H", "--height", type=int, default=1080)
    p.add_argument("--spp", type=int, default=None, help="override samples per pixel")
    p.add_argument("--bounces", type=int, default=None, help="override max bounces")
    p.add_argument("--frames", type=int, default=1, help="frames to render (timing)")
    p.add_argument("--orbit", type=float, default=None, metavar="DEG",
                   help="animate: rotate the camera DEG degrees per frame "
                        "around the look-at point (temporal denoiser history "
                        "carries across frames via motion-vector "
                        "reprojection, never reset — scene_content_checksum "
                        "excludes the camera exactly like "
                        "DXRPipeline.cpp:2795-2860)")
    p.add_argument("--save-frames", metavar="DIR", default=None,
                   help="write every rendered frame as DIR/frame_NNNN.png "
                        "(batch/animation output; with --frames N)")
    p.add_argument("--caustics", action="store_true",
                   help="enable photon-mapped caustics (the reference's "
                        "causticsEnabled runtime toggle)")
    p.add_argument("--photon-debug", type=int, default=None, metavar="MODE",
                   help="photon debug visualization mode 0-12 (the reference "
                        "UI's P-key cycle, RenderWindow.xaml.cs:628)")
    p.add_argument("--photon-scale", type=float, default=None,
                   help="photon debug brightness scale (reference cycles "
                        "1/4/16)")
    p.add_argument("--denoise", action="store_true", help="enable the denoiser")
    p.add_argument("--debug-view", type=int, default=None, metavar="MODE",
                   help="write a composite debug view 1-10 instead of the "
                        "final frame (Composite.hlsl DebugMode)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU even when an accelerator is present")
    p.add_argument("--json", action="store_true", help="print timing stats as JSON")
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from ..runtime.engine import Engine

    overrides = {}
    if args.spp is not None:
        overrides["samples_per_pixel"] = args.spp
    if args.bounces is not None:
        overrides["max_bounces"] = args.bounces
    if args.caustics:
        overrides["enable_caustics"] = True
    if args.photon_debug is not None:
        if not 0 <= args.photon_debug <= 12:
            print("error: --photon-debug must be 0-12", file=sys.stderr)
            return 1
        overrides["photon_debug_mode"] = args.photon_debug
    if args.photon_scale is not None:
        overrides["photon_debug_scale"] = args.photon_scale
    if args.denoise:
        overrides["enable_denoiser"] = True

    engine = Engine(args.width, args.height)
    try:
        engine.load_rtvs(args.scene, **overrides)
    except FileNotFoundError:
        print(f"error: scene file not found: {args.scene}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    def save(img, path):
        try:
            from PIL import Image

            Image.fromarray(img).save(path)
        except ImportError:
            from ..io.png import write_png

            write_png(path, img)

    if args.save_frames:
        import os

        os.makedirs(args.save_frames, exist_ok=True)

    orbit = Orbit(engine, overrides) if args.orbit is not None else None
    img = engine.render()  # first frame includes compile
    if args.debug_view is not None:
        img = engine.render_debug_view(args.debug_view)
    compile_ms = engine.last_render_ms
    if args.save_frames:
        save(img, f"{args.save_frames}/frame_0000.png")
    times = []
    for f in range(1, max(1, args.frames)):
        if orbit is not None:
            orbit.set_angle(args.orbit * f)
        img = engine.render()
        times.append(engine.last_render_ms)
        if args.debug_view is not None:
            img = engine.render_debug_view(args.debug_view)
        if args.save_frames:
            save(img, f"{args.save_frames}/frame_{f:04d}.png")

    save(img, args.output)

    stats = {
        "output": args.output,
        "width": args.width,
        "height": args.height,
        "first_frame_ms": round(compile_ms, 2),
        "steady_frame_ms": round(sum(times) / len(times), 2) if times else None,
        "rays_per_frame": engine.last_rays,
        "mrays_per_s": round(engine.last_mrays_per_s, 2),
    }
    if args.json:
        print(json.dumps(stats))
    else:
        print(f"wrote {args.output} ({args.width}x{args.height})")
        print(f"first frame {stats['first_frame_ms']} ms (incl. compile); "
              f"steady {stats['steady_frame_ms']} ms; "
              f"{stats['mrays_per_s']} Mrays/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
