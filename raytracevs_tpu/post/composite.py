"""Composite pass (src/Shader/Composite.hlsl:170-509).

Combines (optionally denoised) diffuse/specular with albedo remodulation,
material-class dispatch on albedo.alpha (sky / specular-dominant / diffuse),
distance-based NRD bypass, exposure, tonemap, gamma. When the denoiser is
off this reduces to the raw path the reference also takes
(UseDenoisedShadow == 0, Composite.hlsl:434-450).
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from .. import constants as C
from . import tonemap

F32 = jnp.float32


def composite(
    gbuffer,
    raw_specular,
    exposure,
    tone_map_operator,
    gamma,
    denoised_diffuse: Optional[jnp.ndarray] = None,
    denoised_specular: Optional[jnp.ndarray] = None,
    use_denoised: bool = False,
    nrd_bypass_distance=8.0,
    nrd_bypass_blend=2.0,
):
    """Returns display-ready color in [0,1], shape [N,3]."""
    albedo = gbuffer.albedo[:, :3]
    material_alpha = gbuffer.albedo[:, 3]
    is_sky = material_alpha < 0.25
    is_specular_dom = (material_alpha >= 0.25) & (material_alpha < 0.75)
    # P2-2 smoothstep only for the semi-specular band (Composite.hlsl:405)
    t = jnp.clip((material_alpha - 0.7) / (0.9 - 0.7), 0.0, 1.0)
    specular_weight = t * t * (3.0 - 2.0 * t)

    diffuse_in = gbuffer.diffuse_hitdist[:, :3]
    raw_diffuse = diffuse_in * albedo
    raw_color = raw_diffuse + raw_specular

    if use_denoised and denoised_diffuse is not None:
        view_z = gbuffer.view_z
        nrd_color = denoised_diffuse * albedo + denoised_specular
        blend_f = jnp.clip((view_z - nrd_bypass_distance) / nrd_bypass_blend, 0.0, 1.0)
        near = view_z < nrd_bypass_distance + nrd_bypass_blend
        diffuse_color = jnp.where(
            near[:, None], nrd_color + (raw_color - nrd_color) * blend_f[:, None], raw_color
        )
    else:
        diffuse_color = raw_color

    surf = raw_specular + (diffuse_color - raw_specular) * specular_weight[:, None]
    input_color = jnp.where(
        is_sky[:, None], diffuse_in, jnp.where(is_specular_dom[:, None], raw_specular, surf)
    )
    return tonemap.tonemap_and_gamma(input_color, exposure, tone_map_operator, gamma)

