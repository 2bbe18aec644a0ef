"""Properties of the denoiser (post/denoise.py) on synthetic inputs.

Temporal reprojection, history resets, responsive accumulation and the
REBLUR prepass, each checked against what the NRD settings block they
mirror (NRDDenoiser.cpp:858-871) implies.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from raytracevs_tpu import constants as C
from raytracevs_tpu.post import denoise as D

H, W = 32, 48


def _state(seed=0, frames=None):
    rng = np.random.RandomState(seed)

    def mk(shape, scale=1.0):
        return jnp.asarray(rng.rand(*shape).astype(np.float32) * scale)

    return D.DenoiserState(
        diffuse=mk((H, W, 4)), specular=mk((H, W, 4)),
        fast_diffuse=mk((H, W, 3)), fast_specular=mk((H, W, 3)),
        frames=(mk((H, W), 10.0) if frames is None
                else jnp.full((H, W), float(frames), jnp.float32)),
        view_z=jnp.full((H, W), 7.0, jnp.float32),  # flat wall
    )


def _curr(seed=1):
    rng = np.random.RandomState(seed)
    return (jnp.asarray(rng.rand(H, W, 4).astype(np.float32)),
            jnp.asarray(rng.rand(H, W, 4).astype(np.float32)))


def _motion(mx, my):
    return jnp.tile(jnp.asarray([mx, my], jnp.float32), (H, W, 1))


def test_zero_motion_is_exponential_accumulation():
    """Static camera: history stays in place and blends with the current
    frame at alpha = 1/(1 + frames), frames = min(old + 1, 16). The
    hit-distance channel bypasses the anti-lag clamp, so it shows the raw
    blend."""
    state = _state(2)
    curr_d, curr_s = _curr(3)
    acc_d, acc_s, _fd, _fs, frames = D.temporal_accumulate(
        curr_d, curr_s, _motion(0.0, 0.0), state.view_z, state)
    want_frames = np.minimum(np.asarray(state.frames) + 1.0, D.MAX_ACCUM_FRAMES)
    np.testing.assert_allclose(np.asarray(frames), want_frames, rtol=1e-6)
    alpha = 1.0 / (1.0 + want_frames)
    for acc, hist, cur in ((acc_d, state.diffuse, curr_d),
                           (acc_s, state.specular, curr_s)):
        h, c = np.asarray(hist)[..., 3], np.asarray(cur)[..., 3]
        np.testing.assert_allclose(np.asarray(acc)[..., 3],
                                   h + (c - h) * alpha, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mx,my", [(3.0, -2.0), (-1.0, 4.0)])
def test_integer_motion_shifts_history(mx, my):
    """Uniform integer motion fetches history from (x - mx, y - my):
    equal to the static result on the shifted history; pixels whose
    source lies outside the frame restart (frames 0, output = current)."""
    state = _state(4)
    curr_d, curr_s = _curr(5)
    moved = D.temporal_accumulate(curr_d, curr_s, _motion(mx, my),
                                  state.view_z, state)
    dx, dy = int(mx), int(my)
    shifted = state._replace(**{
        k: jnp.roll(getattr(state, k), (dy, dx), axis=(0, 1))
        for k in ("diffuse", "specular", "fast_diffuse", "fast_specular",
                  "frames")})
    static = D.temporal_accumulate(curr_d, curr_s, _motion(0.0, 0.0),
                                   state.view_z, shifted)
    ys, xs = np.mgrid[0:H, 0:W]
    inside = ((xs - dx >= 0) & (xs - dx < W) & (ys - dy >= 0) & (ys - dy < H))
    for got, want in zip(moved, static):
        np.testing.assert_allclose(np.asarray(got)[inside],
                                   np.asarray(want)[inside], rtol=1e-5, atol=1e-6)
    frames = np.asarray(moved[4])
    assert (frames[~inside] == 0).all()
    np.testing.assert_allclose(np.asarray(moved[0])[~inside][..., 3],
                               np.asarray(curr_d)[~inside][..., 3],
                               rtol=1e-5, atol=1e-6)


def test_fractional_motion_is_bilinear():
    """A history that is linear in x is reprojected exactly by the
    bilinear fetch: frames(x) = x / 8 moved by 1.25 px reads (x - 1.25)/8."""
    ramp = jnp.tile(jnp.arange(W, dtype=jnp.float32)[None, :] / 8.0, (H, 1))
    state = _state(6)._replace(frames=ramp)
    curr_d, curr_s = _curr(7)
    frames = np.asarray(D.temporal_accumulate(
        curr_d, curr_s, _motion(1.25, 0.0), state.view_z, state)[4])
    xs = np.arange(W, dtype=np.float64)
    want = np.minimum((xs - 1.25) / 8.0 + 1.0, D.MAX_ACCUM_FRAMES)
    np.testing.assert_allclose(frames[:, 2:], np.tile(want[2:], (H, 1)),
                               rtol=1e-5)


def test_sky_and_depth_mismatch_reset_history():
    """History is dropped where the surface depth moved by more than 10%
    and on sky pixels: frames restart at 0 and the output is the current
    frame."""
    state = _state(8)
    curr_d, curr_s = _curr(9)
    view_z = np.full((H, W), 7.0, np.float32)
    view_z[: H // 2] *= 10.0
    view_z[H // 2:] = C.VIEWZ_SKY
    acc_d, acc_s, _fd, _fs, frames = D.temporal_accumulate(
        curr_d, curr_s, _motion(0.0, 0.0), jnp.asarray(view_z), state)
    assert (np.asarray(frames) == 0).all()
    np.testing.assert_allclose(np.asarray(acc_d)[..., 3],
                               np.asarray(curr_d)[..., 3], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(acc_s)[..., 3],
                               np.asarray(curr_s)[..., 3], rtol=1e-5, atol=1e-6)


def test_responsive_accumulation_caps_mirror_history():
    """Near-mirrors (roughness < 0.05) accumulate specular with the FAST
    frame cap (NRDDenoiser.cpp:864-865): alpha 1/(1 + 4) against
    1/(1 + 11) on rough pixels; diffuse is unaffected."""
    state = _state(10, frames=10)
    curr_d, curr_s = _curr(11)
    rough = np.full((H, W), 0.5, np.float32)
    rough[:, : W // 2] = 0.0
    _acc_d, acc_s, _fd, _fs, frames = D.temporal_accumulate(
        curr_d, curr_s, _motion(0.0, 0.0), state.view_z, state,
        roughness=jnp.asarray(rough))
    assert (np.asarray(frames) == 11.0).all()
    a = np.asarray(acc_s)[..., 3]
    hs = np.asarray(state.specular)[..., 3]
    cs = np.asarray(curr_s)[..., 3]
    ok = np.abs(cs - hs) > 0.1
    alpha = np.where(ok, (a - hs) / np.where(ok, cs - hs, 1.0), np.nan)
    mirror, rough_half = alpha[:, : W // 2], alpha[:, W // 2:]
    np.testing.assert_allclose(mirror[ok[:, : W // 2]], 1.0 / 5.0, atol=1e-4)
    np.testing.assert_allclose(rough_half[ok[:, W // 2:]], 1.0 / 12.0, atol=1e-4)


def test_hitdist_reconstruction_area3x3():
    """AREA_3X3 (NRDDenoiser.cpp:858): a zero-hitdist surface pixel takes
    the mean of its valid 3x3 neighbors; pixels with data are untouched;
    sky pixels stay zero."""
    h, w = 16, 16
    curr = np.zeros((8, h, w), np.float32)
    curr[3] = 5.0  # diffuse hitdist everywhere...
    curr[3, 4, 4] = 0.0  # ...except one hole
    curr[7] = 2.0
    curr[7, 8, 8] = 0.0
    view_z = np.full((h, w), 10.0, np.float32)
    view_z[0, :] = C.VIEWZ_SKY  # sky row
    curr[3, 0, :] = 0.0
    curr[7, 0, :] = 0.0
    out = np.asarray(D.reblur_prepass(
        jnp.asarray(curr), jnp.asarray(view_z),
        jnp.zeros((h, w), jnp.float32)))
    assert out[3, 4, 4] == pytest.approx(5.0, abs=1e-5)
    assert out[7, 8, 8] == pytest.approx(2.0, abs=1e-5)
    assert out[3, 10, 10] == pytest.approx(5.0, abs=1e-6)  # untouched
    assert (out[3, 0, :] == 0.0).all()  # sky stays empty
    assert out[3, 1, 5] == pytest.approx(5.0, abs=1e-6)


def test_spec_prepass_mirror_identity_rough_blur():
    """specularPrepassBlurRadius (NRDDenoiser.cpp:867-868): roughness 0
    leaves specular unchanged (minBlurRadius=0 mirror sharpness); rough
    pixels get a hot pixel knocked down and spread."""
    h, w = 32, 32
    rng = np.random.RandomState(31)
    curr = rng.rand(8, h, w).astype(np.float32) * 0.1
    curr[3] = 1.0
    curr[7] = 5.0  # plenty of hitdist -> full radius
    curr[4:7, 16, 16] = 10.0  # hot specular pixel
    view_z = np.full((h, w), 10.0, np.float32)

    out_mirror = np.asarray(D.reblur_prepass(
        jnp.asarray(curr), jnp.asarray(view_z), jnp.zeros((h, w), jnp.float32)))
    np.testing.assert_allclose(out_mirror[4:7], curr[4:7], atol=1e-5)

    out_rough = np.asarray(D.reblur_prepass(
        jnp.asarray(curr), jnp.asarray(view_z), jnp.ones((h, w), jnp.float32)))
    assert out_rough[4, 16, 16] < 5.0  # peak knocked down
    assert out_rough[4, 16, 19] > curr[4, 16, 19]  # energy spread outward


def test_spec_virtual_motion_static_noop_and_fetch():
    """Specular virtual-motion reprojection: motion_spec == motion is
    bit-identical to the surface-motion path; a distinct virtual field
    fetches the specular history where it points, diffuse unchanged."""
    state = _state(41)
    curr_d, curr_s = _curr(42)
    motion = _motion(2.0, 1.0)
    legacy = D.temporal_accumulate(curr_d, curr_s, motion, state.view_z, state)
    same = D.temporal_accumulate(curr_d, curr_s, motion, state.view_z, state,
                                 motion_spec=motion)
    for a, b in zip(legacy, same):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    mspec = _motion(-3.0, 4.0)
    virt = D.temporal_accumulate(curr_d, curr_s, motion, state.view_z, state,
                                 motion_spec=mspec)
    np.testing.assert_array_equal(np.asarray(virt[0]), np.asarray(legacy[0]))
    # away from the frame edges both fields stay inside: spec history comes
    # from the virtual location (frames still follow the surface motion)
    inner = (slice(4, H - 4), slice(4, W - 4))
    np.testing.assert_allclose(np.asarray(virt[1])[inner][..., 3],
                               _blend(state, curr_s, mspec, legacy[4])[inner],
                               rtol=1e-5, atol=1e-6)
    assert np.abs(np.asarray(virt[1]) - np.asarray(legacy[1])).max() > 1e-3


def _blend(state, curr_s, mspec, frames):
    """Specular hit-distance channel fetched at integer offset `mspec`,
    blended with alpha 1/(1 + frames)."""
    dx, dy = (int(v) for v in np.asarray(mspec)[0, 0])
    hist = np.roll(np.asarray(state.specular)[..., 3], (dy, dx), axis=(0, 1))
    alpha = 1.0 / (1.0 + np.asarray(frames))
    return hist + (np.asarray(curr_s)[..., 3] - hist) * alpha
