"""Rotation reprojection: the temporal history survives an orbiting camera.

Camera rotation gives every pixel its own motion vector. The denoiser
reprojects history per pixel through them (NRDDenoiser.cpp:774-1280 does
the same), so history must survive the orbit, and the accumulated history
must end up closer to a converged render than a single frame. A wrong
motion vector or reprojection rejects history (depth test) or ghosts, and
fails one of the two checks.
"""
import numpy as np

from raytracevs_tpu.post import denoise as dn

H, W = 48, 96
ORBIT_DEG_PER_FRAME = 2.0  # a brisk orbit: ~120 deg/s at 60 fps
FRAMES = 5


def _orbit_scene(angle_deg):
    from conftest import analytic_scene_file
    from raytracevs_tpu.runtime.engine import Engine
    from raytracevs_tpu.scene.evaluator import evaluate_scene

    engine = Engine(W, H, device_mesh=None)
    scene = evaluate_scene(engine.load_rtvs_graph(analytic_scene_file()))
    # orbit the camera around the look-at point (y axis)
    a = np.deg2rad(angle_deg)
    look = np.asarray(scene.camera.look_at, np.float64)
    rel = np.asarray(scene.camera.position, np.float64) - look
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]])
    scene.camera.position = look + rot @ rel
    return scene


def _frame(scene, frame, prev_vp):
    """Render one spp-1 frame; returns it and its view-projection."""
    from raytracevs_tpu.ops.render import render_frame
    from raytracevs_tpu.scene.flatten import flatten_scene, make_config
    from raytracevs_tpu.scene.sanitize import sanitize_scene

    clean = sanitize_scene(scene)
    flat = flatten_scene(clean, frame_index=frame, aspect=W / H,
                         prev_view_proj=prev_vp)
    cfg = make_config(clean, W, H, samples_per_pixel=1, max_bounces=3,
                      enable_denoiser=True)
    return render_frame(flat, cfg), np.asarray(flat.view_proj)


def _orbit(flip_motion=False):
    """Denoise FRAMES orbiting frames; returns the last frame and state."""
    state = dn.init_state(H, W)
    prev_vp = None
    for frame in range(FRAMES):
        scene = _orbit_scene(frame * ORBIT_DEG_PER_FRAME)
        out, prev_vp = _frame(scene, frame, prev_vp)
        g = out.gbuffer
        if flip_motion:
            g = g._replace(motion=-g.motion, motion_spec=-g.motion_spec)
        _dd, _ds, _sh, state = dn.denoise_frame(g, H, W, state)
    return out, state


def _ghosting(out, state, hit):
    """Mean |history - last frame| over hit pixels, relative to the frame
    (the scene's diffuse term is nearly noise-free at one sample)."""
    single = np.asarray(out.gbuffer.diffuse_hitdist)[:, :3].reshape(H, W, 3)
    history = np.asarray(state.diffuse)[..., :3]
    return np.abs(history - single)[hit].mean() / np.abs(single)[hit].mean()


def test_orbiting_camera_keeps_history():
    out, state = _orbit()
    # history survives the rotation on the surfaces seen in every frame
    hit = np.asarray(out.gbuffer.view_z).reshape(H, W) < 0.99 * dn.C.VIEWZ_SKY
    frames = np.asarray(state.frames)[hit]  # bilinear: fractional counts
    assert np.median(frames) >= FRAMES - 1, np.bincount(frames.astype(int))
    assert (frames >= FRAMES - 2).mean() > 0.8, np.bincount(frames.astype(int))

    # without ghosting, while motion vectors of the wrong sign ghost
    good = _ghosting(out, state, hit)
    assert good < 0.03, good
    _out, bad_state = _orbit(flip_motion=True)
    assert _ghosting(out, bad_state, hit) > 2.0 * good


def test_motion_vectors_match_projected_points():
    """The G-buffer motion at a surface point's pixel is where the point
    moved on screen (pixel space, current minus previous) under a camera
    that orbits and rises between the two frames."""
    from raytracevs_tpu.scene.flatten import flatten_scene
    from raytracevs_tpu.scene.sanitize import sanitize_scene

    s0 = _orbit_scene(0.0)
    out0, vp0 = _frame(s0, 0, None)
    s1 = _orbit_scene(6.0)
    s1.camera.position = s1.camera.position + np.array([0.0, 0.3, 0.0])
    out1, vp1 = _frame(s1, 0, vp0)
    mv = np.asarray(out1.gbuffer.motion).reshape(H, W, 2)

    def pixel(vp, x):
        clip = np.array([*x, 1.0]) @ vp
        ndc = clip[:2] / clip[3]
        return np.array([(ndc[0] * 0.5 + 0.5) * W, (0.5 - ndc[1] * 0.5) * H])

    # floor points and a point on the mirror sphere's front
    for x in ([-1.0, 0.0, -1.5], [1.5, 0.0, 1.0], [0.0, 0.0, -0.5],
              [-2.0, 1.0, -0.8]):
        p0, p1 = pixel(vp0, x), pixel(vp1, x)
        got = mv[int(p1[1]), int(p1[0])]
        np.testing.assert_allclose(got, p1 - p0, atol=0.2, err_msg=str(x))
