"""Fused Pallas kernel (Triton route) for the LTC polygon pipeline.

The XLA lowering of :func:`optix_renderer_tpu.shading.ltc.integrate_over_polygon`
is elementwise arithmetic plus two one-hot case-table matmuls, and it
materializes dozens of (L*R,) intermediates (and two (128, L*R) one-hot
operands) in device memory; the matmuls also break XLA's fusion.  This
kernel runs the whole per-light pipeline of ``ltc_utils.cuh:47-127`` --
translate, isotropic/LTC transform, the 23-case hemisphere clip
(``polygon_utils.cuh:33-120``) and the edge integrals -- on a 1-D block of
rays in registers: per ray it reads 25 floats (p, diffuse, amplitude, the
two fused frame matrices) and writes 3, with no intermediate traffic.

The arithmetic is operation-for-operation the same as the XLA path
(``shading.ltc`` / ``shading.polygon_clip``); the only structural change is
how the clip case table is fetched: instead of a one-hot matmul over the
packed (128, 16) table, the (op, a, b) actions of each *reachable* case are
resolved at trace time into a chain of per-case selects over the
precomputed slot values (the five possible edge intersections are computed
once per clip).  Cases outside the table yield vc = 0 exactly like the
table's default rows, and slot values for vc = 0 lanes are never read by
the masked edge integral.

Lights are visited by an in-kernel loop that reads each light's row as
scalars, so the light count is only a loop bound.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .polygon_clip import _CASES, _COPY

BLOCK_RAYS = 256  # rays per program (a power of two, as Triton requires)
_NUM_WARPS = 4

# per-ray input channel layout of the packed (N_IN_PAD, R) operand
_IN_P = 0        # 0:3   shading point
_IN_DIFF = 3     # 3:6   diffuse albedo
_IN_AMP = 6      # 6     LTC amplitude
_IN_MA = 7       # 7:16  row-major iso @ to_local (diffuse-clip frame)
_IN_MB = 16      # 16:25 row-major ltc_inv @ iso @ to_local (GGX frame)
N_IN = 25
_N_IN_PAD = 32   # channel axis padded to a power of two
_N_OUT_PAD = 4   # rgb + one pad channel

# light row layout of the (Lpad, 16) operand
_L_V1, _L_V2, _L_V3, _L_N, _L_EMIT = 0, 3, 6, 9, 12

# cases reachable when the input is a triangle with vcount == 3
# (mask = 3 | 8*z0 | 16*z1 | 32*z2)
_TRI_CASES = (3, 11, 19, 35, 27, 51, 43, 59)
_ALL_CASES = tuple(sorted(_CASES))


def _norm3(x, y, z, eps=1e-30):
    """Componentwise normalize, formula-identical to ltc._norm3c."""
    n2 = x * x + y * y + z * z
    inv = jnp.where(n2 > eps, jnp.sqrt(jnp.maximum(n2, 1e-38)), 1.0)
    return x / inv, y / inv, z / inv


def _iz0(lx, ly, lz, rx, ry, rz):
    """polygon_clip._iz0_c verbatim (z of the result is identically 0)."""
    den = lz - rz
    lerp = lz / jnp.where(jnp.abs(den) < 1e-30, 1.0, den)
    x = lerp * rx + (-lerp * lx + lx)
    y = lerp * ry + (-lerp * ly + ly)
    n = jnp.sqrt(jnp.maximum(x * x + y * y, 1e-30))
    return x / n, y / n


def _clip(vx, vy, vz, vcount, cases):
    """23-case hemisphere clip on 5 slot-component lists.

    Static-select edition of polygon_clip.clip_polygon_c: the reachable
    ``cases`` are resolved at trace time; each output slot chains one
    vector select per case picking either an input slot or one of the
    (at most five) precomputed z=0 edge intersections.
    """
    zero_i = vcount * 0
    bits = (
        jnp.where(vz[0] > 0.0, 8, zero_i)
        | jnp.where(vz[1] > 0.0, 16, zero_i)
        | jnp.where(vz[2] > 0.0, 32, zero_i)
        | jnp.where((vz[3] > 0.0) & (vcount == 4), 64, zero_i)
    )
    mask = vcount + bits  # bounded by construction: vcount in {0,3,4}

    # the edge intersections any selected case can need, computed once
    pairs = set()
    for c in cases:
        _vc, slots = _CASES[c]
        for op, a, b in slots:
            if op != _COPY:
                pairs.add((a, b))
    iz = {
        (a, b): _iz0(vx[a], vy[a], vz[a], vx[b], vy[b], vz[b])
        for a, b in sorted(pairs)
    }

    is_case = {c: mask == c for c in cases}
    vc = zero_i
    for c in cases:
        vc = jnp.where(is_case[c], _CASES[c][0], vc)

    zero_f = vx[0] * 0.0
    ox, oy, oz = [], [], []
    for o in range(5):
        x, y, z = zero_f, zero_f, zero_f
        for c in cases:
            op, a, b = _CASES[c][1][o]
            if op == _COPY:
                cx, cy, cz = vx[a], vy[a], vz[a]
            else:
                cx, cy = iz[(a, b)]
                cz = zero_f
            x = jnp.where(is_case[c], cx, x)
            y = jnp.where(is_case[c], cy, y)
            z = jnp.where(is_case[c], cz, z)
        ox.append(x)
        oy.append(y)
        oz.append(z)
    return ox, oy, oz, vc


def _integrate_edge_z(ax, ay, az, bx, by, bz):
    """ltc._integrate_edge_z verbatim."""
    x = ax * bx + ay * by + az * bz
    y = jnp.abs(x)
    a = 0.8543985 + (0.4965155 + 0.0145206 * y) * y
    b = 3.4175940 + (4.1616724 + y) * y
    v = a / b
    neg = 0.5 / jnp.sqrt(jnp.maximum(1.0 - x * x, 1e-7)) - v
    theta_sintheta = jnp.where(x > 0.0, v, neg)
    return (ax * by - ay * bx) * theta_sintheta


def _poly_integral(px, py, pz, vc):
    """ltc._masked_polygon_integral_c verbatim."""
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


def _ltc_kernel(n_lights: int, inp_ref, lgt_ref, out_ref):
    """One block of rays x all lights; writes rgb rows 0-2 of out_ref."""
    c = lambda i: inp_ref[i, :]  # (BLOCK_RAYS,)
    px, py, pz = c(_IN_P), c(_IN_P + 1), c(_IN_P + 2)
    amp = c(_IN_AMP)
    ma = [c(_IN_MA + k) for k in range(9)]
    mb = [c(_IN_MB + k) for k in range(9)]
    diff = [c(_IN_DIFF + ch) for ch in range(3)]

    def xform(m, v):
        x, y, z = v
        return _norm3(
            m[0] * x + m[1] * y + m[2] * z,
            m[3] * x + m[4] * y + m[5] * z,
            m[6] * x + m[7] * y + m[8] * z,
        )

    def light(l, acc):
        lf = lambda j: lgt_ref[l, j]  # scalar, broadcasts over the block
        l1 = _norm3(lf(_L_V1) - px, lf(_L_V1 + 1) - py, lf(_L_V1 + 2) - pz)
        l2 = _norm3(lf(_L_V2) - px, lf(_L_V2 + 1) - py, lf(_L_V2 + 2) - pz)
        l3 = _norm3(lf(_L_V3) - px, lf(_L_V3 + 1) - py, lf(_L_V3 + 2) - pz)
        cg = _norm3(l1[0] + l2[0] + l3[0], l1[1] + l2[1] + l3[1],
                    l1[2] + l2[2] + l3[2])
        facing = -(cg[0] * lf(_L_N) + cg[1] * lf(_L_N + 1)
                   + cg[2] * lf(_L_N + 2)) >= 0.0  # ltc_utils.cuh:62-64

        a1, a2, a3 = xform(ma, l1), xform(ma, l2), xform(ma, l3)
        vc0 = jnp.full(px.shape, 3, jnp.int32)
        slots = lambda v1, v2, v3, k: [v1[k], v2[k], v3[k], v1[k], v1[k]]
        dx, dy, dz, dvc = _clip(
            slots(a1, a2, a3, 0), slots(a1, a2, a3, 1), slots(a1, a2, a3, 2),
            vc0, _TRI_CASES)
        diffuse_shading = _poly_integral(dx, dy, dz, dvc)

        # second clip: LTC-transformed ORIGINAL triangle with the first
        # clip's vertex count -- the reference's sequence (ltc_utils.cuh:94-101)
        t1, t2, t3 = xform(mb, l1), xform(mb, l2), xform(mb, l3)
        gx, gy, gz, gvc = _clip(
            slots(t1, t2, t3, 0), slots(t1, t2, t3, 1), slots(t1, t2, t3, 2),
            dvc, _ALL_CASES)
        ggx_shading = _poly_integral(gx, gy, gz, gvc)

        d = jnp.where(facing, diffuse_shading, 0.0)
        g = jnp.where(facing, ggx_shading, 0.0)
        return tuple(acc[ch] + (diff[ch] * d + amp * g) * lf(_L_EMIT + ch)
                     for ch in range(3))

    zero = jnp.zeros_like(px)
    acc = jax.lax.fori_loop(0, n_lights, light, (zero, zero, zero))
    for ch in range(3):
        out_ref[ch, :] = acc[ch]


@functools.partial(jax.jit, static_argnames=("interpret",))
def ltc_integrate_pallas(
    p: jnp.ndarray,            # (R, 3)
    diffuse: jnp.ndarray,      # (R, 3)
    mat_a: jnp.ndarray,        # (R, 9) row-major iso @ to_local
    mat_b: jnp.ndarray,        # (R, 9) row-major ltc_inv @ iso @ to_local
    amplitude: jnp.ndarray,    # (R,)
    lights: jnp.ndarray,       # (L, 16) rows [v1 v2 v3 normal emit pad]
    interpret: bool = False,
) -> jnp.ndarray:
    """Summed LTC radiance over all lights, (R, 3) -- the fused-kernel
    equivalent of ltc.integrate_over_polygon after frame fusion."""
    n = p.shape[0]
    L = lights.shape[0]
    if L == 0:
        return jnp.zeros((n, 3), jnp.float32)
    n_pad = pl.cdiv(n, BLOCK_RAYS) * BLOCK_RAYS
    inp = jnp.concatenate(
        [p, diffuse, amplitude[:, None], mat_a, mat_b,
         jnp.zeros((n, _N_IN_PAD - N_IN), jnp.float32)], axis=1)
    inp = jnp.pad(inp, ((0, n_pad - n), (0, 0))).T  # (32, n_pad)
    # light rows padded to a power of two; the kernel loops over L only
    lights = jnp.pad(lights, ((0, pl.next_power_of_2(L) - L), (0, 0)))

    out = pl.pallas_call(
        functools.partial(_ltc_kernel, L),
        grid=(n_pad // BLOCK_RAYS,),
        in_specs=[
            pl.BlockSpec((_N_IN_PAD, BLOCK_RAYS), lambda i: (0, i)),
            pl.BlockSpec(lights.shape, lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((_N_OUT_PAD, BLOCK_RAYS), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((_N_OUT_PAD, n_pad), jnp.float32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="ltc_polygon",
    )(inp, lights)
    return out[:3, :n].T


def pack_lights(light_v1, light_v2, light_v3, light_normal, light_emit):
    """(L, 16) kernel operand from the DeviceScene light arrays."""
    L = light_v1.shape[0]
    pad = jnp.zeros((L, 1), jnp.float32)
    return jnp.concatenate(
        [light_v1, light_v2, light_v3, light_normal, light_emit, pad], axis=1
    )
