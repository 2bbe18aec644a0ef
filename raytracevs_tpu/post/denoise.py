"""Denoising: temporal accumulation + edge-aware spatial filtering.

Replaces the reference's NVIDIA NRD integration (Denoiser/NRDDenoiser.cpp:
REBLUR_DIFFUSE_SPECULAR + SIGMA_SHADOW) with an own implementation over the
same G-buffer contract:

- REBLUR-like temporal accumulation with motion-vector reprojection, a slow
  history (maxAccumulatedFrameNum 16) and a fast history (4) used for
  anti-lag clamping (NRDDenoiser.cpp:870-871), history reset on scene change
  via the frame-index reset (DXRPipeline.cpp:2854-2880),
- a-trous edge-stopping spatial passes guided by view-Z and oct-decoded
  normals over the demodulated diffuse / specular radiance,
- the custom shadow filter from src/Shader/ShadowDenoise.hlsl:39-131
  (exact object-ID match + relative-depth + normal^8 + Gaussian weights) —
  selected by useCustomShadowDenoiser (DXRPipeline.h:577).

All filters operate on [H,W,...] images; the denoiser state is an explicit
pytree double-buffered across frames by the engine.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as C

F32 = jnp.float32

MAX_ACCUM_FRAMES = 16.0  # NRDDenoiser.cpp:870
MAX_FAST_FRAMES = 4.0  # NRDDenoiser.cpp:871
ATROUS_PASSES = 3
DEPTH_SIGMA = 0.05
NORMAL_POWER = 8.0

# REBLUR fidelity features (NRDDenoiser.cpp:858-871). Default ON to match
# the reference's settings block; the env gates exist for A/B probing.
# - anti-firefly (enableAntiFirefly = true): luminance-clamp each pixel to
#   its 3x3 neighborhood max at the head of the blur chain, per signal.
# - hitdist/accumulation-guided blur radius (maxBlurRadius = 30,
#   minBlurRadius = 0): per-pixel radii shrink as history accumulates;
#   specular additionally scales with accumulated hit distance (contact
#   reflections stay sharp) and roughness (mirrors get no blur).
ANTI_FIREFLY = os.environ.get("RTVS_ANTI_FIREFLY", "1") == "1"
GUIDED_BLUR = os.environ.get("RTVS_GUIDED_BLUR", "1") == "1"
MAX_BLUR_RADIUS = 30.0  # NRDDenoiser.cpp:860
# - AREA_3X3 hit-distance reconstruction (NRDDenoiser.cpp:858): surface
#   pixels whose sample path carried no hit distance take the valid-mean
#   of their 3x3 neighborhood before accumulation.
HITDIST_RECON = os.environ.get("RTVS_HITDIST_RECON", "1") == "1"
# - responsive accumulation for near-mirrors (NRDDenoiser.cpp:864-865):
#   specular history at roughness < 0.05 is capped at the FAST frame
#   count, so mirror reflections never smear over 16 frames.
RESPONSIVE_ACCUM = os.environ.get("RTVS_RESPONSIVE_ACCUM", "1") == "1"
RESPONSIVE_ROUGHNESS = 0.05  # NRDDenoiser.cpp:864
# - specular pre-pass blur (specularPrepassBlurRadius = 10.0,
#   NRDDenoiser.cpp:867-868): the noisy current-frame specular is blurred
#   before it enters the history.
SPEC_PREPASS = os.environ.get("RTVS_SPEC_PREPASS", "1") == "1"
SPEC_PREPASS_RADIUS = 10.0  # NRDDenoiser.cpp:868
# - specular virtual-motion reprojection (the NRD-internal REBLUR
#   behavior): specular history is fetched where the REFLECTED image
#   point (Xv = X + V*hitDist*(1-roughness), computed at render time as
#   gbuffer.motion_spec) reprojects, with per-pixel fallback to the
#   surface-motion sample when the virtual position is invalid. With a
#   static camera motion_spec == motion and the output is bit-identical
#   to surface reprojection.
SPEC_VIRTUAL = os.environ.get("RTVS_SPEC_VIRTUAL", "1") == "1"
# halo rows the pre-steps reach (prepass ring 7 + recon 1); the sharded
# paths exchange this many current-frame rows when the features are on
PREPASS_HALO = 8


def _lum(rgb, axis=-1):
    r, g, b = jnp.moveaxis(rgb, axis, 0)[:3]
    return r * 0.2126 + g * 0.7152 + b * 0.0722


def anti_firefly(img6):
    """REBLUR enableAntiFirefly analog (NRDDenoiser.cpp:859): clamp each
    pixel's luminance to the max over its 8 neighbors (edge-clamped),
    separately for the diffuse (0:3) and specular (3:6) groups. Fireflies
    (isolated hot pixels from rare glass paths) are scaled down without
    shifting hue; ordinary pixels are untouched (their neighborhood max
    exceeds their own luminance)."""
    h, w = img6.shape[:2]
    p = jnp.pad(img6, [(1, 1), (1, 1), (0, 0)], mode="edge")

    def group(sl):
        lum = _lum(img6[..., sl])
        m = None
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                q = _lum(_shifted(p, 1, dy, dx, h, w)[..., sl])
                m = q if m is None else jnp.maximum(m, q)
        scale = jnp.minimum(1.0, m / jnp.maximum(lum, 1e-6))
        return img6[..., sl] * scale[..., None]

    return jnp.concatenate([group(slice(0, 3)), group(slice(3, 6))], axis=-1)


def reblur_prepass(curr, view_z, sqrt_rough):
    """REBLUR input conditioning before temporal accumulation.

    curr [8,H,W] channel-first (diffuse rgb+hitdist, specular
    rgb+hitdist); view_z / sqrt_rough [H,W]. Two steps, both pure static
    shifts (XLA-fused; no kernels needed):

    1) AREA_3X3 hit-distance reconstruction
       (nrd::HitDistanceReconstructionMode::AREA_3X3,
       NRDDenoiser.cpp:858): surface pixels with NO hit-distance data
       (ch 3 / ch 7 == 0) take the mean of their valid 3x3 neighbors —
       without it, spp-1 pixels whose sample carried no hit distance
       poison the accumulation-guided blur radii and the prepass radius.
       Neighbors clamp at the frame edge (texture-load semantics, like
       every other filter here — keeps the sharded halo path bit-exact).
    2) Specular pre-pass blur (specularPrepassBlurRadius = 10.0,
       NRDDenoiser.cpp:867-868): the noisy current-frame specular
       radiance is blurred with a static two-ring kernel (8 taps at
       d~3, 8 at d~7) whose per-pixel radius
       R = 10 * sqrt(roughness) * hd/(hd + 0.2 z) attenuates each tap
       by exp(-(d/R)^2). Mirrors (roughness 0) keep R = 0 == identity —
       sharp reflections are untouched (minBlurRadius = 0 parity) —
       while rough contact reflections get their spp-1 noise knocked
       down before it enters the history. Depth-guided (DEPTH_SIGMA) so
       radiance never bleeds across silhouettes.
    """
    if not (HITDIST_RECON or SPEC_PREPASS):
        return curr
    h, w = view_z.shape
    not_sky = view_z < C.VIEWZ_SKY * 0.99
    out = curr

    if HITDIST_RECON:
        new_hd = []
        for ch in (3, 7):
            hd = curr[ch]
            vf = ((hd > 0.0) & not_sky).astype(F32)
            hp = jnp.pad(hd * vf, 1, mode="edge")
            vp = jnp.pad(vf, 1, mode="edge")
            s = jnp.zeros_like(hd)
            cnt = jnp.zeros_like(hd)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dy == 0 and dx == 0:
                        continue
                    s = s + hp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                    cnt = cnt + vp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            recon = s / jnp.maximum(cnt, 1.0)
            need = (hd <= 0.0) & not_sky & (cnt > 0.0)
            new_hd.append(jnp.where(need, recon, hd))
        out = out.at[3].set(new_hd[0]).at[7].set(new_hd[1])

    if SPEC_PREPASS:
        hd = jnp.maximum(out[7], 0.0)
        zc = jnp.maximum(view_z, C.VIEWZ_MIN)
        hd_factor = hd / (hd + 0.2 * zc + 1e-6)
        radius = (SPEC_PREPASS_RADIUS
                  * jnp.clip(sqrt_rough, 0.0, 1.0) * hd_factor)
        r2 = jnp.square(jnp.maximum(radius, 1e-3))
        spec = out[4:7]
        p = 7
        sp = jnp.pad(spec, ((0, 0), (p, p), (p, p)), mode="edge")
        zp = jnp.pad(view_z, p, mode="edge")
        acc = spec
        wsum = jnp.ones_like(view_z)
        taps = [(0, 3), (0, -3), (3, 0), (-3, 0),
                (2, 2), (2, -2), (-2, 2), (-2, -2),
                (0, 7), (0, -7), (7, 0), (-7, 0),
                (5, 5), (5, -5), (-5, 5), (-5, -5)]
        for dy, dx in taps:
            d2 = float(dy * dy + dx * dx)
            q = sp[:, p + dy:p + dy + h, p + dx:p + dx + w]
            qz = zp[p + dy:p + dy + h, p + dx:p + dx + w]
            w_r = jnp.exp(-d2 / r2)
            w_z = jnp.exp(-jnp.abs(qz - view_z) / (DEPTH_SIGMA * zc))
            wt = w_r * w_z
            acc = acc + q * wt[None]
            wsum = wsum + wt
        out = out.at[4:7].set(acc / wsum[None])
    return out


def blur_radius_planes(frames, spec_hitdist, view_z, roughness):
    """Per-pixel blur radii in pixels (REBLUR maxBlurRadius=30,
    minBlurRadius=0 semantics): radius shrinks with accumulated history
    (fresh disocclusions blur wide, converged pixels stay sharp); the
    specular radius additionally scales with the accumulated hit distance
    relative to depth (short hitdist = contact reflection = sharp) and
    sqrt(roughness) (a perfect mirror gets zero blur — minBlurRadius=0).
    Returns (r_diffuse [H,W], r_specular [H,W])."""
    # REBLUR's accumulation speed: radius shrinks ~1/(1+N) (the same
    # 1/(1+frames) alpha the temporal accumulation uses), NOT 1/sqrt —
    # sqrt left converged pixels with a stationary ~7 px blur that
    # measurably smeared shadow boundaries on flat floors (no depth or
    # normal edge stops there; ScreenShot comparison r5: our mirror-
    # sphere shadow was one soft blob vs the reference's tight ellipse).
    # At the 16-frame cap the radius is ~1.8 px, matching REBLUR's
    # converged-history sharpness.
    base = MAX_BLUR_RADIUS / (1.0 + frames)
    hd = jnp.maximum(spec_hitdist, 0.0)
    hd_factor = hd / (hd + 0.2 * jnp.maximum(view_z, C.VIEWZ_MIN) + 1e-6)
    r_spec = base * jnp.sqrt(jnp.clip(roughness, 0.0, 1.0)) * hd_factor
    return base, r_spec


class DenoiserState(NamedTuple):
    diffuse: jnp.ndarray  # [H,W,4] slow history (radiance + hitdist)
    specular: jnp.ndarray  # [H,W,4]
    fast_diffuse: jnp.ndarray  # [H,W,3]
    fast_specular: jnp.ndarray  # [H,W,3]
    frames: jnp.ndarray  # [H,W] accumulated frame count
    view_z: jnp.ndarray  # [H,W] previous depth


def init_state(height: int, width: int) -> DenoiserState:
    return DenoiserState(
        diffuse=jnp.zeros((height, width, 4), F32),
        specular=jnp.zeros((height, width, 4), F32),
        fast_diffuse=jnp.zeros((height, width, 3), F32),
        fast_specular=jnp.zeros((height, width, 3), F32),
        frames=jnp.zeros((height, width), F32),
        view_z=jnp.full((height, width), C.VIEWZ_SKY, F32),
    )


def _decode_oct(nr):
    """DecodeUnitVector (NRDEncoding.hlsli:82-91). nr: [H,W,4]."""
    p = nr[..., :2] * 2.0 - 1.0
    z = 1.0 - jnp.abs(p[..., 0]) - jnp.abs(p[..., 1])
    t = jnp.clip(-z, 0.0, 1.0)
    x = p[..., 0] + jnp.where(p[..., 0] >= 0.0, -t, t)
    y = p[..., 1] + jnp.where(p[..., 1] >= 0.0, -t, t)
    n = jnp.stack([x, y, z], axis=-1)
    return n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def _bilinear(img, xf, yf):
    """Bilinear sample of img [H,W,C] at float coords (xf, yf) [H,W]."""
    h, w = img.shape[0], img.shape[1]
    x0 = jnp.floor(xf).astype(jnp.int32)
    y0 = jnp.floor(yf).astype(jnp.int32)
    fx = (xf - x0)[..., None]
    fy = (yf - y0)[..., None]

    flat = img.reshape(h * w, -1)

    def tap(yi, xi):
        yi = jnp.clip(yi, 0, h - 1)
        xi = jnp.clip(xi, 0, w - 1)
        return jnp.take(flat, yi * w + xi, axis=0)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def temporal_accumulate(curr_diffuse, curr_specular, motion, view_z,
                        state: DenoiserState, packed_ext=None, halo: int = 0,
                        row0=0, global_h: int = None, roughness=None,
                        motion_spec=None):
    """Motion-reprojected exponential accumulation with fast-history anti-lag.

    curr_*: [H,W,4]; motion [H,W,2] pixel-space (current - previous);
    view_z [H,W]. Returns (diffuse, specular [H,W,4], new_state fields).

    roughness [H,W] (optional) enables responsive accumulation for
    near-mirrors (NRDDenoiser.cpp:864-865): specular history at
    roughness < RESPONSIVE_ROUGHNESS accumulates with the FAST frame cap,
    so mirror reflections track the current frame instead of smearing
    over 16 frames. None (the default) keeps legacy behavior.

    Sharded mode (denoise_frame_sharded): `packed_ext` is the 16-channel
    history slab EXTENDED by `halo` exchanged neighbor rows on each side,
    `row0` is this shard's first global row, and `global_h` the full image
    height — reprojection bounds and gather clamping then reproduce the
    single-device result bit-exactly (halo must exceed the MV clamp + the
    bilinear +1 tap). Defaults reduce to the original whole-frame path.
    """
    h, w = view_z.shape
    if global_h is None:
        global_h = h
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0).astype(F32) + row0
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1).astype(F32)
    prev_x = xs - motion[..., 0]
    prev_y = ys - motion[..., 1]  # global row coordinate

    # One fused 16-channel bilinear sample instead of six separate ones:
    # each bilinear tap is an XLA gather over the whole frame, and shared
    # indices amortize them.
    if packed_ext is None:
        packed_ext = jnp.concatenate(
            [state.diffuse, state.specular, state.fast_diffuse,
             state.fast_specular, state.frames[..., None],
             state.view_z[..., None]],
            axis=-1,
        )
    hist = _bilinear(packed_ext, prev_x, prev_y - row0 + halo)
    hist_d = hist[..., 0:4]
    hist_s = hist[..., 4:8]
    fast_d = hist[..., 8:11]
    fast_s = hist[..., 11:14]
    hist_frames = hist[..., 14]
    hist_z = hist[..., 15]

    if SPEC_VIRTUAL and motion_spec is not None:
        # specular virtual-motion reprojection: fetch the spec channels
        # where the REFLECTED image point moved; per-pixel fallback to
        # the surface-motion sample where the virtual position is
        # out-of-frame or its motion untrusted
        pvx = xs - motion_spec[..., 0]
        pvy = ys - motion_spec[..., 1]
        spec_ext = jnp.concatenate(
            [packed_ext[..., 4:8], packed_ext[..., 11:14]], axis=-1)
        vh = _bilinear(spec_ext, pvx, pvy - row0 + halo)
        virt_in = ((pvx >= 0) & (pvx <= w - 1) & (pvy >= 0)
                   & (pvy <= global_h - 1))[..., None]
        hist_s = jnp.where(virt_in, vh[..., 0:4], hist_s)
        fast_s = jnp.where(virt_in, vh[..., 4:7], fast_s)

    in_bounds = ((prev_x >= 0) & (prev_x <= w - 1) & (prev_y >= 0)
                 & (prev_y <= global_h - 1))
    depth_ok = jnp.abs(hist_z - view_z) <= 0.1 * jnp.maximum(view_z, C.VIEWZ_MIN)
    not_sky = view_z < C.VIEWZ_SKY * 0.99
    valid = in_bounds & depth_ok & not_sky

    frames = jnp.where(valid, jnp.minimum(hist_frames + 1.0, MAX_ACCUM_FRAMES), 0.0)
    alpha = (1.0 / (1.0 + frames))[..., None]
    fast_frames = jnp.minimum(frames, MAX_FAST_FRAMES)
    fast_alpha = (1.0 / (1.0 + fast_frames))[..., None]

    alpha_s = alpha
    if RESPONSIVE_ACCUM and roughness is not None:
        frames_s = jnp.where(roughness < RESPONSIVE_ROUGHNESS,
                             fast_frames, frames)
        alpha_s = (1.0 / (1.0 + frames_s))[..., None]

    acc_d = hist_d + (curr_diffuse - hist_d) * alpha
    acc_s = hist_s + (curr_specular - hist_s) * alpha_s
    new_fast_d = fast_d + (curr_diffuse[..., :3] - fast_d) * fast_alpha
    new_fast_s = fast_s + (curr_specular[..., :3] - fast_s) * fast_alpha

    # Anti-lag: clamp the slow history toward the fast history (REBLUR-style)
    def clamp_to_fast(slow, fast):
        lo = fast * 0.5
        hi = fast * 2.0 + 1e-3
        return jnp.clip(slow, jnp.minimum(lo, hi), jnp.maximum(lo, hi))

    acc_d = acc_d.at[..., :3].set(clamp_to_fast(acc_d[..., :3], new_fast_d))
    acc_s = acc_s.at[..., :3].set(clamp_to_fast(acc_s[..., :3], new_fast_s))
    return acc_d, acc_s, new_fast_d, new_fast_s, frames


def _shifted(padded, pad, dy, dx, h, w):
    """Edge-clamped neighbor slice of an array padded by `pad` (mode=edge)."""
    return padded[pad + dy : pad + dy + h, pad + dx : pad + dx + w]


def _atrous_pass(img, view_z, normal, stride: int, guide=None):
    """One edge-stopping a-trous pass (edge-clamped borders). img [H,W,C].

    With `guide` ([H,W,2] per-pixel blur radii for the diffuse 0:3 and
    specular 3:6 groups, in pixels), each group's neighbor weights are
    attenuated by exp(-(stride/R)^2) of the CENTER pixel's radius: R >>
    stride leaves the pass unchanged, R -> 0 degenerates to identity
    (minBlurRadius=0 mirror sharpness)."""
    offsets = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
    kernel = {0: 1.0, 1: 2.0 / 3.0, 2: 1.0 / 6.0}
    im_h, im_w = view_z.shape
    spec = [(stride, stride), (stride, stride)]
    pimg = jnp.pad(img, spec + [(0, 0)], mode="edge")
    pz = jnp.pad(view_z, spec, mode="edge")
    pn = jnp.pad(normal, spec + [(0, 0)], mode="edge")
    if guide is not None:
        s2 = float(stride * stride)
        g_d = jnp.exp(-s2 / jnp.square(jnp.maximum(guide[..., 0], 1e-3)))
        g_s = jnp.exp(-s2 / jnp.square(jnp.maximum(guide[..., 1], 1e-3)))
        wsum_d = jnp.ones(view_z.shape, F32)
        wsum_s = jnp.ones(view_z.shape, F32)
    wsum = jnp.ones(view_z.shape, F32)
    acc = img
    for dy, dx in offsets:
        q = _shifted(pimg, stride, dy * stride, dx * stride, im_h, im_w)
        qz = _shifted(pz, stride, dy * stride, dx * stride, im_h, im_w)
        qn = _shifted(pn, stride, dy * stride, dx * stride, im_h, im_w)
        w_depth = jnp.exp(
            -jnp.abs(qz - view_z) / (DEPTH_SIGMA * jnp.maximum(view_z, C.VIEWZ_MIN))
        )
        w_norm = jnp.power(
            jnp.maximum(jnp.sum(qn * normal, axis=-1), 0.0), NORMAL_POWER
        )
        w_spatial = kernel[max(abs(dy), abs(dx))]
        w = w_depth * w_norm * w_spatial
        if guide is None:
            acc = acc + q * w[..., None]
            wsum = wsum + w
        else:
            w_d = w * g_d
            w_s = w * g_s
            acc = acc + jnp.concatenate(
                [q[..., 0:3] * w_d[..., None], q[..., 3:6] * w_s[..., None]],
                axis=-1)
            wsum_d = wsum_d + w_d
            wsum_s = wsum_s + w_s
    if guide is None:
        return acc / wsum[..., None]
    return jnp.concatenate(
        [acc[..., 0:3] / wsum_d[..., None], acc[..., 3:6] / wsum_s[..., None]],
        axis=-1)


def atrous(img, view_z, normal, passes: int = ATROUS_PASSES, guide=None,
           use_anti_firefly: bool = False):
    """Edge-stopping a-trous wavelet filter. img [H,W,C].

    Neighbors clamp at the frame border (texture-load semantics, like the
    reference's compute filters) — NOT wrap-around. `guide`/
    `use_anti_firefly` enable the REBLUR fidelity features (see
    blur_radius_planes / anti_firefly; img must then be the 6-channel
    diffuse+specular pack).
    """
    out = anti_firefly(img) if use_anti_firefly else img
    for p in range(passes):
        out = _atrous_pass(out, view_z, normal, 1 << p, guide=guide)
    return out


def shadow_denoise(shadow, obj_id, view_z, normal_roughness,
                   filter_radius: int = 2, depth_threshold: float = 0.1,
                   shadow_softness: float = 1.0):
    """Custom shadow filter (src/Shader/ShadowDenoise.hlsl:39-131).

    shadow [H,W,2] (penumbra, visibility); obj_id [H,W] i32 (-1 = sky).
    """
    normal = _decode_oct(normal_roughness)
    im_h, im_w = view_z.shape
    r = filter_radius
    spec = [(r, r), (r, r)]
    p_sh = jnp.pad(shadow, spec + [(0, 0)], mode="edge")
    p_id = jnp.pad(obj_id, spec, mode="edge")
    p_z = jnp.pad(view_z, spec, mode="edge")
    p_n = jnp.pad(normal, spec + [(0, 0)], mode="edge")
    wsum = jnp.zeros(view_z.shape, F32)
    vis_sum = jnp.zeros(view_z.shape, F32)
    pen_sum = jnp.zeros(view_z.shape, F32)
    for dy in range(-filter_radius, filter_radius + 1):
        for dx in range(-filter_radius, filter_radius + 1):
            q = _shifted(p_sh, r, dy, dx, im_h, im_w)
            q_id = _shifted(p_id, r, dy, dx, im_h, im_w)
            q_z = _shifted(p_z, r, dy, dx, im_h, im_w)
            q_n = _shifted(p_n, r, dy, dx, im_h, im_w)
            same = q_id == obj_id  # exact match (ShadowDenoise.hlsl:93)
            w_depth = jnp.exp(
                -jnp.abs(view_z - q_z) / jnp.maximum(depth_threshold * view_z, 0.001)
            )
            w_norm = jnp.power(jnp.maximum(jnp.sum(q_n * normal, axis=-1), 0.0), 8.0)
            d2 = float(dx * dx + dy * dy)
            w_spatial = jnp.exp(-d2 / (2.0 * shadow_softness * shadow_softness + 0.01))
            w = jnp.where(same, w_depth * w_norm * w_spatial, 0.0)
            vis_sum = vis_sum + q[..., 1] * w
            pen_sum = pen_sum + q[..., 0] * w
            wsum = wsum + w
    ok = wsum > 0.001
    out = jnp.stack(
        [
            jnp.where(ok, pen_sum / jnp.maximum(wsum, 1e-6), shadow[..., 0]),
            jnp.where(ok, vis_sum / jnp.maximum(wsum, 1e-6), shadow[..., 1]),
        ],
        axis=-1,
    )
    # Sky pixels pass through (ShadowDenoise.hlsl:56-60)
    return jnp.where((obj_id < 0)[..., None], shadow, out)


def denoise_frame(gbuffer, height: int, width: int, state: DenoiserState):
    """Full denoise: temporal + spatial on diffuse/specular, shadow filter.

    gbuffer fields are [N,...] lane arrays; reshaped to [H,W,...] here.
    Returns (diffuse3, specular3, shadow2 — all [N,..] lanes, new_state).
    """

    def img(a, c=None):
        return a.reshape(height, width, c) if c else a.reshape(height, width)

    diffuse = img(gbuffer.diffuse_hitdist, 4)
    specular = img(gbuffer.specular_hitdist, 4)
    motion = img(gbuffer.motion, 2)
    view_z = img(gbuffer.view_z)
    nr = img(gbuffer.normal_roughness, 4)
    shadow = img(gbuffer.shadow_data, 2)  # (penumbra, visibility)
    obj_id = img(gbuffer.obj_id)

    if HITDIST_RECON or SPEC_PREPASS:
        curr8 = reblur_prepass(
            jnp.concatenate([diffuse.transpose(2, 0, 1),
                             specular.transpose(2, 0, 1)], axis=0),
            view_z, nr[..., 3])
        diffuse = curr8[0:4].transpose(1, 2, 0)
        specular = curr8[4:8].transpose(1, 2, 0)
    acc_d, acc_s, fast_d, fast_s, frames = temporal_accumulate(
        diffuse, specular, motion, view_z, state,
        roughness=jnp.square(nr[..., 3]),
        motion_spec=(None if getattr(gbuffer, "motion_spec", None) is None
                     else img(gbuffer.motion_spec, 2)),
    )
    normal = _decode_oct(nr)
    # one fused filter pass: diffuse and specular share the edge-stopping
    # weights (depth + normal), so filtering them as 6 channels halves the
    # weight computation and the roll traffic
    guide = None
    if GUIDED_BLUR:
        r_d, r_s = blur_radius_planes(frames, acc_s[..., 3], view_z,
                                      jnp.square(nr[..., 3]))
        guide = jnp.stack([r_d, r_s], axis=-1)
    out_ds = atrous(jnp.concatenate([acc_d[..., :3], acc_s[..., :3]], axis=-1),
                    view_z, normal, guide=guide,
                    use_anti_firefly=ANTI_FIREFLY)
    out_d = out_ds[..., 0:3]
    out_s = out_ds[..., 3:6]
    out_shadow = shadow_denoise(shadow, obj_id, view_z, nr)

    new_state = DenoiserState(
        diffuse=acc_d,
        specular=acc_s,
        fast_diffuse=fast_d,
        fast_specular=fast_s,
        frames=frames,
        view_z=view_z,
    )
    n = height * width
    return (
        out_d.reshape(n, 3),
        out_s.reshape(n, 3),
        out_shadow.reshape(n, 2),
        new_state,
    )


# ---- multi-device: sharded denoise with halo-row exchange -------------------
#
# The denoiser is the full pipeline's only cross-pixel stage, so it is the
# only place image-row sharding needs a collective (SURVEY §2.5/§5.8): each
# shard exchanges boundary rows with its mesh neighbors
# (jax.lax.ppermute), filters its extended slab, and crops the halo — output
# bit-equal to the single-device denoiser.

# History halo: the reprojection gather reaches at most MV_CLAMP_PIXELS rows
# plus the bilinear +1 tap; 72 covers 64 + 1.
TEMPORAL_HALO = 72


# The a-trous passes exchange per-pass halos of their own stride (1, 2, 4):
# replicating the CURRENT pass input at the image boundary is exactly the
# whole-frame filter's jnp.pad(mode='edge') — a one-shot input halo is not
# (later passes would see replicated inputs where the whole-frame filter
# edge-pads earlier pass OUTPUTS). The shadow filter is single-pass, so one
# radius-2 halo suffices.
SHADOW_HALO = 2


def exchange_row_halo(img, halo: int, axis_name: str, n_shards: int,
                      axis: int = 0):
    """Return img extended along `axis` (the sharded row axis) from rows to
    halo+rows+halo, with neighbor rows fetched over the mesh
    (jax.lax.ppermute ring hops). Where the image boundary cuts the halo
    short, edge rows replicate — exactly the jnp.pad(mode='edge') the
    whole-frame filters use. axis=0 serves the lane pipeline's [rows,...]
    slabs; axis=1 channel-first [c,rows,W] planes.

    Works for halo > rows (multi-hop), which the tiny-shape multichip
    dryrun exercises.
    """
    rows = img.shape[axis]

    def slc(a, start, stop):
        return jax.lax.slice_in_dim(a, start, stop, axis=axis)

    if n_shards == 1:
        top = jnp.repeat(slc(img, 0, 1), halo, axis=axis)
        bot = jnp.repeat(slc(img, rows - 1, rows), halo, axis=axis)
        return jnp.concatenate([top, img, bot], axis=axis)
    hops = -(-halo // rows)
    i = jax.lax.axis_index(axis_name)

    # Full slabs from the k-th neighbor in each direction (zeros where the
    # neighbor does not exist; replaced by edge replication below).
    above = []  # k = hops..1: slab of shard i-k
    below = []  # k = 1..hops: slab of shard i+k
    for k in range(1, hops + 1):
        above.append(jax.lax.ppermute(
            img, axis_name, [(j, j + k) for j in range(n_shards - k)]))
        below.append(jax.lax.ppermute(
            img, axis_name, [(j + k, j) for j in range(n_shards - k)]))

    # Own slab appended/prepended so boundary shards can clamp into their
    # own edge rows — the per-shard equivalent of jnp.pad(mode='edge') at
    # the global image boundary.
    above_full = jnp.concatenate(above[::-1] + [img], axis=axis)
    below_full = jnp.concatenate([img] + below, axis=axis)
    ridx = jnp.arange(hops * rows)
    # above_full rows = global slabs i-hops..i; valid from (hops-i)*rows on
    vstart = jnp.maximum(hops - i, 0) * rows
    ext_above = jnp.take(above_full, jnp.maximum(ridx, vstart), axis=axis)
    # below_full rows = global slabs i..i+hops; valid through the last
    # existing neighbor (own slab is always valid)
    vend = (jnp.minimum(n_shards - 1 - i, hops) + 1) * rows - 1
    ext_below = jnp.take(below_full, jnp.minimum(rows + ridx, vend), axis=axis)
    return jnp.concatenate(
        [slc(ext_above, hops * rows - halo, hops * rows), img,
         slc(ext_below, 0, halo)], axis=axis)


def denoise_frame_sharded(gbuffer, rows: int, width: int, state: DenoiserState,
                          axis_name: str, n_shards: int, global_h: int):
    """Per-shard denoise_frame (call under shard_map with rows sharded).

    gbuffer fields and `state` hold THIS shard's row slab; returns the same
    (diffuse3, specular3, shadow2, new_state) contract, bit-equal to
    denoise_frame over the assembled frame. Two collectives per frame: a
    TEMPORAL_HALO exchange of the packed history and a SPATIAL_HALO
    exchange of the filter inputs.
    """
    def img(a, c=None):
        return a.reshape(rows, width, c) if c else a.reshape(rows, width)

    diffuse = img(gbuffer.diffuse_hitdist, 4)
    specular = img(gbuffer.specular_hitdist, 4)
    motion = img(gbuffer.motion, 2)
    view_z = img(gbuffer.view_z)
    nr = img(gbuffer.normal_roughness, 4)
    shadow = img(gbuffer.shadow_data, 2)
    obj_id = img(gbuffer.obj_id)
    row0 = jax.lax.axis_index(axis_name) * rows

    packed = jnp.concatenate(
        [state.diffuse, state.specular, state.fast_diffuse, state.fast_specular,
         state.frames[..., None], state.view_z[..., None]],
        axis=-1,
    )
    packed_ext = exchange_row_halo(packed, TEMPORAL_HALO, axis_name, n_shards)
    if HITDIST_RECON or SPEC_PREPASS:
        pp = jnp.concatenate(
            [diffuse, specular, view_z[..., None], nr[..., 3:4]], axis=-1)
        ppe = exchange_row_halo(pp, PREPASS_HALO, axis_name, n_shards)
        c8 = reblur_prepass(ppe[..., 0:8].transpose(2, 0, 1), ppe[..., 8],
                            ppe[..., 9])[:, PREPASS_HALO:PREPASS_HALO + rows]
        diffuse = c8[0:4].transpose(1, 2, 0)
        specular = c8[4:8].transpose(1, 2, 0)
    acc_d, acc_s, fast_d, fast_s, frames = temporal_accumulate(
        diffuse, specular, motion, view_z, state, packed_ext=packed_ext,
        halo=TEMPORAL_HALO, row0=row0, global_h=global_h,
        roughness=jnp.square(nr[..., 3]),
        motion_spec=(None if getattr(gbuffer, "motion_spec", None) is None
                     else img(gbuffer.motion_spec, 2)),
    )

    normal = _decode_oct(nr)
    # a-trous with a per-pass halo exchange: pass p extends its own INPUT
    # by `stride` neighbor rows, filters, and crops — bit-equal to the
    # whole-frame filter (see SHADOW_HALO note above). z, normals, and the
    # REBLUR guide radii ride along as extra channels so each pass is one
    # collective; pass 0 exchanges one extra row so the anti-firefly
    # clamp's 3x3 reach stays bit-equal to the whole-frame filter.
    guide = None
    if GUIDED_BLUR:
        r_d, r_s = blur_radius_planes(frames, acc_s[..., 3], view_z,
                                      jnp.square(nr[..., 3]))
        guide = jnp.stack([r_d, r_s], axis=-1)
    out_ds = jnp.concatenate([acc_d[..., :3], acc_s[..., :3]], axis=-1)
    for p in range(ATROUS_PASSES):
        stride = 1 << p
        extra = 1 if (p == 0 and ANTI_FIREFLY) else 0
        chans = [out_ds, view_z[..., None], normal]
        if guide is not None:
            chans.append(guide)
        sp = jnp.concatenate(chans, axis=-1)
        spe = exchange_row_halo(sp, stride + extra, axis_name, n_shards)
        if extra:
            ff = anti_firefly(spe[..., 0:6])
            spe = jnp.concatenate([ff, spe[..., 6:]], axis=-1)[1:-1]
        g = spe[..., 10:12] if guide is not None else None
        out_ds = _atrous_pass(
            spe[..., 0:6], spe[..., 6], spe[..., 7:10], stride, guide=g
        )[stride:stride + rows]

    # obj_id survives the f32 round trip exactly (packed ids < 2**24)
    sh = jnp.concatenate(
        [shadow, obj_id.astype(F32)[..., None], view_z[..., None], nr],
        axis=-1,
    )
    she = exchange_row_halo(sh, SHADOW_HALO, axis_name, n_shards)
    out_shadow = shadow_denoise(
        she[..., 0:2], she[..., 2].astype(jnp.int32), she[..., 3],
        she[..., 4:8],
    )[SHADOW_HALO:SHADOW_HALO + rows]

    new_state = DenoiserState(
        diffuse=acc_d, specular=acc_s, fast_diffuse=fast_d,
        fast_specular=fast_s, frames=frames, view_z=view_z,
    )
    n = rows * width
    return (
        out_ds[..., 0:3].reshape(n, 3),
        out_ds[..., 3:6].reshape(n, 3),
        out_shadow.reshape(n, 2),
        new_state,
    )
