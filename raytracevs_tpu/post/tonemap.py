"""Tone mapping and gamma (src/Shader/Composite.hlsl:63-100, 456-486)."""
from __future__ import annotations

import jax.numpy as jnp

from .. import constants as C

F32 = jnp.float32


def reinhard(color):
    """ReinhardToneMap (Composite.hlsl:68-71)."""
    return color / (1.0 + color)


def aces_film(x):
    """ACESFilm approximation (Composite.hlsl:75-83)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def linear_to_srgb(color):
    """Exact sRGB OETF (Composite.hlsl:86-94)."""
    lo = 12.92 * color
    hi = 1.055 * jnp.power(jnp.maximum(color, 1e-12), 1.0 / 2.4) - 0.055
    return jnp.where(color < 0.0031308, lo, hi)


def apply_gamma(color, gamma):
    """Custom power gamma (Composite.hlsl:97-100)."""
    return jnp.power(jnp.maximum(color, 0.0), 1.0 / gamma)


def tonemap_and_gamma(color, exposure, tone_map_operator, gamma):
    """Exposure -> tonemap -> gamma, matching CSMain (Composite.hlsl:456-486).

    tone_map_operator: traced i32 (0 Reinhard, 1 ACES, 2 None).
    Gamma == 2.2 (within tolerance) uses the exact sRGB curve.
    """
    x = color * exposure
    mapped = jnp.where(
        (tone_map_operator < 1)[..., None] if jnp.ndim(tone_map_operator) else tone_map_operator < 1,
        reinhard(x),
        jnp.where(tone_map_operator < 2, aces_film(x), x),
    )
    mapped = jnp.clip(mapped, 0.0, 1.0)
    is_srgb = jnp.abs(gamma - C.GAMMA_SRGB_STANDARD) < C.GAMMA_SRGB_TOLERANCE
    return jnp.where(is_srgb, linear_to_srgb(mapped), apply_gamma(mapped, gamma))


def to_rgba8(color01):
    """[...,3] in [0,1] -> [...,4] uint8 RGBA (RenderTarget readback format)."""
    rgb = jnp.clip(color01 * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)
    alpha = jnp.full(rgb.shape[:-1] + (1,), 255, jnp.uint8)
    return jnp.concatenate([rgb, alpha], axis=-1)

