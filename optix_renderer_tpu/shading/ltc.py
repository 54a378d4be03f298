"""LTC analytic area-light integration.

Vectorized re-design of ``cuda_include/ltc/ltc_utils.cuh``: the per-pixel
loop over lights (deviceCode.cu:50-53) becomes a (rays x lights) batch —
the whole polygon pipeline (translate, transform, clip, edge-integrate)
runs as elementwise arithmetic with no control flow (the clip is the
gather table in ``polygon_clip``).  On the GPU the same pipeline runs as
one fused kernel (``shading.ltc_pallas``); the jnp version is the
reference and the lowering for every other platform.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from ..core import math as cm
from .ltc_tables import LTC_ISO_1, LTC_ISO_2, LTC_ISO_3
from .polygon_clip import clip_polygon

# numpy module constants (not jnp) — see engine.renderer on hoisting
_LTC1 = LTC_ISO_1
_LTC2 = LTC_ISO_2
_LTC3 = LTC_ISO_3
# all three 8x8 RGBA LUTs flattened into one (64, 12) matrix: the bilinear
# corner fetch becomes one exact-precision one-hot matmul
_LTC_PACKED = np.concatenate(
    [np.asarray(LTC_ISO_1).reshape(64, 4),
     np.asarray(LTC_ISO_2).reshape(64, 4),
     np.asarray(LTC_ISO_3).reshape(64, 4)],
    axis=1,
).astype(np.float32)


def _rows64(idx: jnp.ndarray) -> jnp.ndarray:
    """Fetch packed LUT rows (..., 12) by flat texel index via one-hot."""
    onehot = (idx[..., None] == jnp.arange(64, dtype=jnp.int32)).astype(jnp.float32)
    flat = jax.lax.dot_general(
        onehot.reshape(-1, 64), jnp.asarray(_LTC_PACKED),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return flat.reshape(idx.shape + (12,))


def _bilinear_8x8_packed(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """CUDA tex2D LINEAR+CLAMP over the three packed LUTs at once
    (viewer.hpp:322-327 semantics; texel centers at (i + 0.5) / 8).
    Returns (..., 12) = rows of LTC1|LTC2|LTC3."""
    fx = x * 8.0 - 0.5
    fy = y * 8.0 - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    xi0 = jnp.clip(x0.astype(jnp.int32), 0, 7)
    xi1 = jnp.clip(x0.astype(jnp.int32) + 1, 0, 7)
    yi0 = jnp.clip(y0.astype(jnp.int32), 0, 7)
    yi1 = jnp.clip(y0.astype(jnp.int32) + 1, 0, 7)
    t00 = _rows64(yi0 * 8 + xi0)
    t01 = _rows64(yi0 * 8 + xi1)
    t10 = _rows64(yi1 * 8 + xi0)
    t11 = _rows64(yi1 * 8 + xi1)
    return (t00 * (1 - tx) + t01 * tx) * (1 - ty) + (t10 * (1 - tx) + t11 * tx) * ty


def fetch_ltc_mat(alpha: jnp.ndarray, theta: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(ltc_mat (..., 3, 3) row-major, amplitude (...,)) — ltc_utils.cuh:10-23."""
    x = theta * jnp.float32(0.99 / (0.5 * cm.PI))
    rows = _bilinear_8x8_packed(x, alpha)
    mat = jnp.stack([rows[..., 0:3], rows[..., 4:7], rows[..., 8:11]], axis=-2)
    return mat, rows[..., 11]


def integrate_edge_vec(v1: jnp.ndarray, v2: jnp.ndarray) -> jnp.ndarray:
    """Cubic-fit arc integral (ltc_utils.cuh:26-44); batched (..., 3)."""
    x = cm.dot(v1, v2)
    y = jnp.abs(x)
    a = 0.8543985 + (0.4965155 + 0.0145206 * y) * y
    b = 3.4175940 + (4.1616724 + y) * y
    v = a / b
    neg = 0.5 / jnp.sqrt(jnp.maximum(1.0 - x * x, 1e-7)) - v
    theta_sintheta = jnp.where(x > 0.0, v, neg)
    return jnp.cross(v1, v2) * theta_sintheta[..., None]


def _masked_polygon_integral(verts: jnp.ndarray, vc: jnp.ndarray) -> jnp.ndarray:
    """|sum of edge integrals| over the first vc vertices with wraparound
    (the vc-switch bodies in ltc_utils.cuh:80-123, unrolled + masked)."""
    total = jnp.zeros(verts.shape[:-2], verts.dtype)
    for j in range(5):
        vj = verts[..., j, :]
        # next vertex is static slot j+1, except the closing edge back to
        # slot 0 — a select between two static slices, never a gather
        wrap = (j == vc - 1)[..., None]
        vn = jnp.where(wrap, verts[..., 0, :], verts[..., min(j + 1, 4), :])
        contrib = integrate_edge_vec(vj, vn)[..., 2]
        total = total + jnp.where(j < vc, contrib, 0.0)
    return jnp.abs(total)


def _integrate_edge_z(ax, ay, az, bx, by, bz):
    """z-component of ``integrate_edge_vec`` (the only one the polygon
    integral reads), componentwise: cross_z(a, b) * theta/sin(theta)."""
    x = ax * bx + ay * by + az * bz
    y = jnp.abs(x)
    a = 0.8543985 + (0.4965155 + 0.0145206 * y) * y
    b = 3.4175940 + (4.1616724 + y) * y
    v = a / b
    neg = 0.5 / jnp.sqrt(jnp.maximum(1.0 - x * x, 1e-7)) - v
    theta_sintheta = jnp.where(x > 0.0, v, neg)
    return (ax * by - ay * bx) * theta_sintheta


def _masked_polygon_integral_c(px, py, pz, vc):
    """Componentwise :func:`_masked_polygon_integral` over slot lists."""
    total = jnp.zeros_like(px[0])
    for j in range(5):
        wrap = j == vc - 1
        k = min(j + 1, 4)
        nx = jnp.where(wrap, px[0], px[k])
        ny = jnp.where(wrap, py[0], py[k])
        nz = jnp.where(wrap, pz[0], pz[k])
        contrib = _integrate_edge_z(px[j], py[j], pz[j], nx, ny, nz)
        total = total + jnp.where(j < vc, contrib, 0.0)
    return jnp.abs(total)


def _matmul33(a, b):  # (R, 3, 3) @ (R, 3, 3), componentwise
    return jnp.stack([
        jnp.stack([
            a[:, i, 0] * b[:, 0, k] + a[:, i, 1] * b[:, 1, k]
            + a[:, i, 2] * b[:, 2, k]
            for k in range(3)
        ], axis=-1)
        for i in range(3)
    ], axis=-2)


def _norm3c(x, y, z, eps=1e-30):
    """Componentwise ``cm.normalize(..., eps)`` -> (x, y, z) tuple."""
    n2 = x * x + y * y + z * z
    inv = jnp.where(n2 > eps, jnp.sqrt(jnp.maximum(n2, 1e-38)), 1.0)
    return x / inv, y / inv, z / inv


def integrate_over_polygon(
    p: jnp.ndarray,  # (R, 3) shading points
    diffuse: jnp.ndarray,  # (R, 3)
    to_local: jnp.ndarray,  # (R, 3, 3)
    iso_frame: jnp.ndarray,  # (R, 3, 3)
    ltc_mat_inv: jnp.ndarray,  # (R, 3, 3)
    amplitude: jnp.ndarray,  # (R,)
    light_v1: jnp.ndarray,  # (L, 3)
    light_v2: jnp.ndarray,
    light_v3: jnp.ndarray,
    light_normal: jnp.ndarray,  # (L, 3)
    light_emit: jnp.ndarray,  # (L, 3)
) -> jnp.ndarray:
    """Summed LTC radiance over all lights (ltc_utils.cuh:47-127), (R, 3).

    The fused kernel on the GPU, :func:`polygon_sum_xla` elsewhere (a
    lowering-time platform choice: one traced program for every backend).
    """
    # fused per-ray matrices: the reference chains to_local -> normalize
    # -> iso -> normalize (-> ltc_inv -> normalize).  normalize is
    # scale-invariant under matrix application, so the intermediate
    # normalizes are mathematically redundant — ONE fused (R, 3, 3)
    # matmul per clip input (R-sized, 1/L the cost of an (L, R) pass)
    # replaces each chain, with a single normalize at the end.
    mat_a = _matmul33(iso_frame, to_local)
    mat_b = _matmul33(ltc_mat_inv, mat_a)
    lights = (light_v1, light_v2, light_v3, light_normal, light_emit)
    return jax.lax.platform_dependent(
        p, diffuse, mat_a, mat_b, amplitude, lights,
        cuda=polygon_sum_kernel, default=polygon_sum_xla)


def polygon_sum_kernel(p, diffuse, mat_a, mat_b, amplitude, lights):
    """:func:`polygon_sum_xla` as one fused Pallas kernel."""
    from . import ltc_pallas

    R = p.shape[0]
    return ltc_pallas.ltc_integrate_pallas(
        p, diffuse, mat_a.reshape(R, 9), mat_b.reshape(R, 9), amplitude,
        ltc_pallas.pack_lights(*lights))


def polygon_sum_xla(p, diffuse, mat_a, mat_b, amplitude, lights):
    """Summed LTC radiance after frame fusion, in plain jnp: the reference
    the kernel is checked against.

    ``mat_a`` = iso @ to_local and ``mat_b`` = ltc_inv @ mat_a, (R, 3, 3);
    ``lights`` = (v1, v2, v3, normal, emit), each (L, 3).  Every
    intermediate is a SEPARATE flat (L*R,) array per vector component, so
    the arrays stay dense whatever the light count; the per-light/per-ray
    broadcasts become ``repeat``/``tile`` that XLA fuses into consumers.
    """
    from .polygon_clip import clip_polygon_c

    light_v1, light_v2, light_v3, light_normal, light_emit = lights
    R = p.shape[0]
    L = light_v1.shape[0]

    def per_ray(v):  # (R,) -> (L*R,), light-major
        return jnp.tile(v, L)

    def per_light(v):  # (L,) -> (L*R,), light-major
        return jnp.repeat(v, R, total_repeat_length=L * R)

    px, py, pz = (per_ray(p[:, a]) for a in range(3))

    def translate(lv):  # (L, 3) light corner -> normalized (L*R,) comps
        return _norm3c(
            per_light(lv[:, 0]) - px,
            per_light(lv[:, 1]) - py,
            per_light(lv[:, 2]) - pz,
        )

    l1 = translate(light_v1)
    l2 = translate(light_v2)
    l3 = translate(light_v3)

    cgx, cgy, cgz = _norm3c(
        l1[0] + l2[0] + l3[0], l1[1] + l2[1] + l3[1], l1[2] + l2[2] + l3[2]
    )
    lnx, lny, lnz = (per_light(light_normal[:, a]) for a in range(3))
    facing = -(cgx * lnx + cgy * lny + cgz * lnz) >= 0.0  # backface :62-64

    def xform(m, v):  # m: (R, 3, 3) per-ray matrix, v: (L*R,) comps
        x, y, z = v
        mr = lambda i, j: per_ray(m[:, i, j])
        return _norm3c(
            mr(0, 0) * x + mr(0, 1) * y + mr(0, 2) * z,
            mr(1, 0) * x + mr(1, 1) * y + mr(1, 2) * z,
            mr(2, 0) * x + mr(2, 1) * y + mr(2, 2) * z,
        )

    a1, a2, a3 = xform(mat_a, l1), xform(mat_a, l2), xform(mat_a, l3)

    # first clip: the cosine (diffuse) polygon (slots [v1 v2 v3 v1 v1])
    slots = lambda a, b, c: [a, b, c, a, a]
    vc0 = jnp.full(l1[0].shape, 3, jnp.int32)
    dx, dy, dz, dvc = clip_polygon_c(
        slots(a1[0], a2[0], a3[0]), slots(a1[1], a2[1], a3[1]),
        slots(a1[2], a2[2], a3[2]), vc0, tri_input=True,
    )
    diffuse_shading = _masked_polygon_integral_c(dx, dy, dz, dvc)  # (L, R)

    # second clip: LTC-transformed *original* triangle, but with the first
    # clip's vertex count — exactly the reference's (quirky) sequence
    # ltc_utils.cuh:94-101.
    t1, t2, t3 = xform(mat_b, l1), xform(mat_b, l2), xform(mat_b, l3)
    gx, gy, gz, lvc = clip_polygon_c(
        slots(t1[0], t2[0], t3[0]), slots(t1[1], t2[1], t3[1]),
        slots(t1[2], t2[2], t3[2]), dvc, tri_input=True,
    )
    ggx_shading = _masked_polygon_integral_c(gx, gy, gz, lvc)  # (L, R)

    diffuse_shading = jnp.where(facing, diffuse_shading, 0.0)
    ggx_shading = jnp.where(facing, ggx_shading, 0.0)
    amp = per_ray(amplitude)  # (L*R,)
    out = []
    for a in range(3):
        e = per_light(light_emit[:, a])  # (L*R,)
        ch = (per_ray(diffuse[:, a]) * diffuse_shading + amp * ggx_shading) * e
        out.append(jnp.sum(ch.reshape(L, R), axis=0))  # (R,)
    return jnp.stack(out, axis=-1)


def iso_frame_from_wo_local(wo_local: jnp.ndarray) -> jnp.ndarray:
    """Isotropic frame aligning wo into the xz-plane (deviceCode.cu:42-48).

    Rows: [normalize(wo.xy, 0), normalize(cross(z, row0)), z].  Degenerate
    head-on view (wo.xy ~ 0) falls back to the x axis (the reference would
    produce NaN there; this keeps the limit value).
    """
    xy = wo_local[..., :2]
    n2 = jnp.sum(xy * xy, axis=-1, keepdims=True)
    safe = n2 > 1e-24
    r0xy = jnp.where(safe, xy / jnp.sqrt(jnp.where(safe, n2, 1.0)), jnp.asarray([1.0, 0.0]))
    row0 = jnp.concatenate([r0xy, jnp.zeros_like(r0xy[..., :1])], axis=-1)
    row2 = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], wo_local.dtype), row0.shape)
    row1 = cm.normalize(jnp.cross(row2, row0), eps=1e-30)
    return jnp.stack([row0, row1, row2], axis=-2)
