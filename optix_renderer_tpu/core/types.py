"""SoA pytree types shared across the framework.

The reference's per-thread structs (``cuda_include/common.cuh``) become
structure-of-arrays pytrees: every field is a batched jnp array with a
leading ray/pixel dimension, so the whole renderer stays shape-static and
vectorizes.  ``LaunchParams`` (common.cuh:80-121) is
split: per-frame state -> :class:`RenderState`; static scene data lives in
``scene.device.DeviceScene``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

pytree = partial(dataclasses.dataclass, frozen=True)


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@pytree
class Ray:
    """Batched rays: origin/direction (N, 3) float32."""

    origin: jnp.ndarray
    direction: jnp.ndarray

    def at(self, t: jnp.ndarray) -> jnp.ndarray:
        return self.origin + t[..., None] * self.direction


@_register
@pytree
class Hit:
    """Raw traversal output, before attribute interpolation.

    tri_id == -1 encodes a miss (the reference's miss program,
    hit_miss.cuh:52-63, becomes a mask over these lanes).
    """

    t: jnp.ndarray  # (N,) float32 hit distance (inf on miss)
    tri_id: jnp.ndarray  # (N,) int32 global triangle id, -1 on miss
    bary_u: jnp.ndarray  # (N,) float32
    bary_v: jnp.ndarray  # (N,) float32


@_register
@pytree
class SurfaceInteraction:
    """SoA equivalent of ``SurfaceInteraction`` (common.cuh:163-183).

    ``to_local``/``to_world`` frames are derived on demand via
    ``core.math.orthonormal_basis`` rather than stored (they are cheap to
    recompute and storing 18 floats/ray wastes HBM bandwidth).
    """

    hit: jnp.ndarray  # (N,) bool
    p: jnp.ndarray  # (N, 3) world-space hit point
    uv: jnp.ndarray  # (N, 2) wrapped texture coords
    n_geom: jnp.ndarray  # (N, 3) interpolated (shading) normal, 0 on miss
    diffuse: jnp.ndarray  # (N, 3) base color (miss lanes: miss const color)
    alpha: jnp.ndarray  # (N,) roughness, clamped [0.01, 1]
    emit: jnp.ndarray  # (N, 3)
    is_light: jnp.ndarray  # (N,) bool
    material_id: jnp.ndarray  # (N,) int32 (0 on miss / lights)
    area: jnp.ndarray  # (N,) triangle area


@_register
@pytree
class Camera:
    """Pinhole camera basis (common.cuh:113-118 semantics).

    ``dir_00`` points at the lower-left corner; a pixel's ray direction is
    ``normalize(dir_00 + u * dir_du + v * dir_dv)`` with u, v in [0, 1)
    (deviceCode.cu:68-73).
    """

    pos: jnp.ndarray  # (3,)
    dir_00: jnp.ndarray  # (3,)
    dir_du: jnp.ndarray  # (3,)
    dir_dv: jnp.ndarray  # (3,)


@_register
@pytree
class GBuffers:
    """Per-frame auxiliary outputs (deviceCode.cu:163-168)."""

    position: jnp.ndarray  # (H, W, 3)
    normal: jnp.ndarray  # (H, W, 3)
    albedo: jnp.ndarray  # (H, W, 3)
    alpha: jnp.ndarray  # (H, W)
    uv: jnp.ndarray  # (H, W, 2)
    material_id: jnp.ndarray  # (H, W) float32 (stored as color in the reference)


@_register
@pytree
class RenderState:
    """Progressive-rendering state threaded through jitted frame steps.

    Equivalent of the mutable half of ``LaunchParams``: the accumulation
    buffer + accumId (deviceCode.cu:158-174) and the camera.  Checkpoint /
    resume is saving and restoring this pytree (SURVEY.md §5).
    """

    accum: jnp.ndarray  # (H, W, 3) running radiance sum
    accum_id: jnp.ndarray  # () int32, number of completed frames
    camera: Camera
