"""Vectorized device math.

Batched equivalents of the reference's CUDA device helpers
(``cuda_include/utils.cuh``), re-designed as batched jnp functions: every
function operates on arrays whose leading dimensions are ray/pixel batch
dimensions and whose trailing dimension holds vector components.  All math
is float32 (the reference computes in fp32 on device).

Conventions
-----------
* a "vec3 batch" has shape ``(..., 3)``
* a "3x3 frame" is stored row-major with shape ``(..., 3, 3)``; row ``i``
  of ``to_local`` is basis vector ``i`` (matching the reference's
  ``vec3f mat[3]`` + ``apply_mat`` row-dot convention,
  ``cuda_include/utils.cuh:69-74``).
"""

from __future__ import annotations

import jax.numpy as jnp

PI = 3.14159265358979323846  # reference: include/common.h:4 (double literal, used as fp32)
EPS = 1e-5  # reference: cuda_include/frostbite.cuh:8


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched vec3 dot product -> (...,)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def normalize(a: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Normalize along the last axis.

    With ``eps == 0`` this matches CUDA ``normalize`` (1/sqrt(dot)), which
    produces inf/nan for zero vectors exactly like the reference would.
    Pass a small eps to guard degenerate batches where the result is
    masked out downstream.
    """
    n2 = dot(a, a)
    inv = jnp.where(n2 > eps, jnp.sqrt(jnp.maximum(n2, 1e-38)), 1.0)
    return a / inv[..., None] if eps > 0.0 else a * (1.0 / jnp.sqrt(n2))[..., None]


def apply_mat(mat: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Row-dot matrix application: result_i = dot(mat[i], v).

    Equivalent of ``apply_mat`` (cuda_include/utils.cuh:69-74).
    mat: (..., 3, 3) row-major, v: (..., 3) -> (..., 3).

    Expanded elementwise rather than as a dot, so no backend may compute
    it in reduced precision (a float32 dot can run in TF32 on the GPU).
    """
    return jnp.sum(mat * v[..., None, :], axis=-1)


def matrix_transpose(mat: jnp.ndarray) -> jnp.ndarray:
    return jnp.swapaxes(mat, -1, -2)


def matrix_inverse_3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Closed-form (adjugate) 3x3 inverse, batched.

    Replaces the reference's Gauss-Jordan elimination
    (cuda_include/utils.cuh:76-138) — the pivoting sequential loop is a
    poor fit for a vector machine; the cofactor form is branchless and
    numerically adequate for the well-conditioned LTC matrices it is used
    on (fp32, |det| bounded away from 0 by the LUT construction).
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = f * g - d * i
    co02 = d * h - e * g
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / det
    row0 = jnp.stack([co00, c * h - b * i, b * f - c * e], axis=-1)
    row1 = jnp.stack([co01, a * i - c * g, c * d - a * f], axis=-1)
    row2 = jnp.stack([co02, b * g - a * h, a * e - b * d], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]


def orthonormal_basis(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Build (to_local, to_world) frames from normals, batched.

    Pixar/Frisvad-style branchless ONB matching ``orthonormalBasis``
    (cuda_include/utils.cuh:167-190): rows of ``to_local`` are (c1, c2, n)
    with the singular case at n.z < -0.999999.  ``to_world`` is the
    transpose (the frame is orthonormal).

    n: (..., 3) -> (to_local (..., 3, 3), to_world (..., 3, 3))
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    singular = nz < -0.999999
    # regular branch (guard denominator so the untaken lane stays finite)
    a = 1.0 / jnp.where(singular, 1.0, 1.0 + nz)
    b = -nx * ny * a
    c1 = jnp.stack([1.0 - nx * nx * a, b, -nx], axis=-1)
    c2 = jnp.stack([b, 1.0 - ny * ny * a, -ny], axis=-1)
    c1 = normalize(c1, eps=1e-30)
    c2 = normalize(c2, eps=1e-30)
    sing1 = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0], c1.dtype), c1.shape)
    sing2 = jnp.broadcast_to(jnp.asarray([-1.0, 0.0, 0.0], c2.dtype), c2.shape)
    c1 = jnp.where(singular[..., None], sing1, c1)
    c2 = jnp.where(singular[..., None], sing2, c2)
    to_local = jnp.stack([c1, c2, n], axis=-2)
    return to_local, matrix_transpose(to_local)


def sample_point_on_triangle(
    v1: jnp.ndarray, v2: jnp.ndarray, v3: jnp.ndarray, u1: jnp.ndarray, u2: jnp.ndarray
) -> jnp.ndarray:
    """sqrt-warp uniform triangle sampling (cuda_include/utils.cuh:193-199)."""
    su1 = jnp.sqrt(u1)[..., None]
    u2e = u2[..., None]
    return (1.0 - su1) * v1 + su1 * ((1.0 - u2e) * v2 + u2e * v3)


def spherical_theta(p: jnp.ndarray) -> jnp.ndarray:
    """acos(z) (cuda_include/utils.cuh:201-204)."""
    return jnp.arccos(jnp.clip(p[..., 2], -1.0, 1.0))


def balance_heuristic(nf: float, f_pdf: jnp.ndarray, ng: float, g_pdf: jnp.ndarray) -> jnp.ndarray:
    """MIS balance heuristic (cuda_include/utils.cuh:206-209)."""
    return (nf * f_pdf) / (nf * f_pdf + ng * g_pdf)


def power_heuristic(nf: float, f_pdf: jnp.ndarray, ng: float, g_pdf: jnp.ndarray) -> jnp.ndarray:
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / (f * f + g * g)


def check_positive(v: jnp.ndarray) -> jnp.ndarray:
    """Clamp components to >= 0 (cuda_include/utils.cuh:218-226)."""
    return jnp.maximum(v, 0.0)


def concentric_sample_disk(u1: jnp.ndarray, u2: jnp.ndarray) -> jnp.ndarray:
    """PBRT concentric disk mapping (cuda_include/utils.cuh:41-60), branchless."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    degenerate = (ox == 0.0) & (oy == 0.0)
    x_major = jnp.abs(ox) > jnp.abs(oy)
    safe_ox = jnp.where(ox == 0.0, 1.0, ox)
    safe_oy = jnp.where(oy == 0.0, 1.0, oy)
    r = jnp.where(x_major, ox, oy)
    theta = jnp.where(
        x_major,
        (PI / 4.0) * (oy / safe_ox),
        (PI / 2.0) - (PI / 4.0) * (ox / safe_oy),
    )
    pt = r[..., None] * jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
    return jnp.where(degenerate[..., None], 0.0, pt)


def cosine_sample_hemisphere_concentric(u1: jnp.ndarray, u2: jnp.ndarray) -> jnp.ndarray:
    """Cosine hemisphere via concentric disk (cuda_include/utils.cuh:62-67)."""
    d = concentric_sample_disk(u1, u2)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - d[..., 0] ** 2 - d[..., 1] ** 2))
    return normalize(jnp.stack([d[..., 0], d[..., 1], z], axis=-1), eps=1e-30)


def uniform_sample_hemisphere(u1: jnp.ndarray, u2: jnp.ndarray) -> jnp.ndarray:
    """Uniform hemisphere sampling (cuda_include/utils.cuh:31-39)."""
    z = u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u2
    return normalize(jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1), eps=1e-30)


def triangle_area(v1: jnp.ndarray, v2: jnp.ndarray, v3: jnp.ndarray) -> jnp.ndarray:
    """0.5 * |cross(v1-v2, v3-v2)| (cuda_include/hit_miss.cuh:24-27)."""
    return 0.5 * length(cross(v1 - v2, v3 - v2))
