"""Branchless polygon clipping to the upper hemisphere (z >= 0).

Vectorized re-design of ``clipPolygon`` (cuda_include/ltc/polygon_utils.cuh:33-120):
the reference encodes (vertex_count, per-vertex z>0) into a bitmask and
switches over 23 precomputed cases.  Here each case's *final* vertex values
are resolved statically (the reference's in-place assignment sequences are
unrolled, including the ones that read already-overwritten slots, e.g.
case 51's ``v[4] = v[0]`` after ``v[0] = iz0(v0,v1)``) into a dense
(128-case) gather table, so the whole clip is table lookups + selects —
no control flow at all.

Output contract matches the reference: vertex count in {0, 3, 4, 5}; for
vc < 5 the first output vertex is repeated at index vc; untouched slots
pass the input through.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# per-output-slot op: COPY input[a]  or  IZ0(input[a], input[b])
_COPY, _IZ0 = 0, 1


def _case(vc, *slots):
    """slots: five (op, a, b) entries (b ignored for COPY)."""
    return vc, slots


def _c(a):  # copy input slot a
    return (_COPY, a, 0)


def _z(a, b):  # iz0(input a, input b)
    return (_IZ0, a, b)


def _keep(i):  # slot keeps its input value
    return (_COPY, i, 0)


# Transcription of polygon_utils.cuh:46-118 with assignment order resolved.
_CASES = {
    # --- triangles (vertex_count == 3, bits 3..5 = z0,z1,z2 > 0) ---
    3: _case(0, _keep(0), _keep(1), _keep(2), _keep(3), _keep(4)),
    59: _case(3, _c(0), _c(1), _c(2), _c(0), _keep(4)),
    11: _case(3, _c(0), _z(0, 1), _z(2, 0), _c(0), _keep(4)),
    19: _case(3, _z(0, 1), _c(1), _z(1, 2), _z(0, 1), _keep(4)),  # v[3]=v[0] reads new v0
    35: _case(3, _z(2, 0), _z(1, 2), _c(2), _z(2, 0), _keep(4)),
    27: _case(4, _c(0), _c(1), _z(1, 2), _z(2, 0), _c(0)),
    51: _case(4, _z(0, 1), _c(1), _c(2), _z(2, 0), _z(0, 1)),  # v[4]=v[0] reads new v0
    43: _case(4, _c(0), _z(0, 1), _z(1, 2), _c(2), _c(0)),
    # --- quads (vertex_count == 4, bits 3..6 = z0..z3 > 0) ---
    4: _case(0, _keep(0), _keep(1), _keep(2), _keep(3), _keep(4)),
    124: _case(4, _c(0), _c(1), _c(2), _c(3), _c(0)),
    12: _case(3, _c(0), _z(0, 1), _z(3, 0), _c(0), _keep(4)),
    20: _case(3, _z(0, 1), _c(1), _z(1, 2), _z(0, 1), _keep(4)),
    36: _case(3, _z(2, 3), _z(1, 2), _c(2), _z(2, 3), _keep(4)),
    68: _case(3, _c(3), _z(3, 0), _z(2, 3), _c(3), _keep(4)),  # v[3] untouched == v3 == out0
    28: _case(4, _c(0), _c(1), _z(1, 2), _z(3, 0), _c(0)),
    52: _case(4, _z(0, 1), _c(1), _c(2), _z(2, 3), _z(0, 1)),
    100: _case(4, _z(3, 0), _z(1, 2), _c(2), _c(3), _z(3, 0)),
    76: _case(4, _c(0), _z(0, 1), _z(2, 3), _c(3), _c(0)),
    60: _case(5, _c(0), _c(1), _c(2), _z(2, 3), _z(3, 0)),
    116: _case(5, _z(0, 1), _c(1), _c(2), _c(3), _z(3, 0)),
    108: _case(5, _z(0, 1), _z(1, 2), _c(2), _c(3), _c(0)),
    92: _case(5, _c(0), _c(1), _z(1, 2), _z(2, 3), _c(3)),
}

_VC = np.zeros(128, np.int32)
_OP = np.zeros((128, 5), np.int32)
_A = np.tile(np.arange(5, dtype=np.int32), (128, 1))  # default: keep slot
_B = np.zeros((128, 5), np.int32)
for _mask, (_vc, _slots) in _CASES.items():
    _VC[_mask] = _vc
    for _j, (_op, _a, _b) in enumerate(_slots):
        _OP[_mask, _j] = _op
        _A[_mask, _j] = _a
        _B[_mask, _j] = _b

# numpy module constants (not jnp): device-resident module constants
# become hoisted executable inputs in this jax build (see engine.renderer).
VC_TABLE = _VC
OP_TABLE = _OP
A_TABLE = _A
B_TABLE = _B
# packed (128, 16) f32 row per case [vc | op*5 | a*5 | b*5] — fetched with
# ONE one-hot matmul instead of four per-lane gathers
CASE_TABLE = np.concatenate(
    [_VC[:, None], _OP, _A, _B], axis=1
).astype(np.float32)
# transposed (16, 128) for the componentwise core: the matmul output is
# (16, N) with the BATCH on the minor axis
CASE_TABLE_T = CASE_TABLE.T.copy()


def iz0(lhs: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """Normalized intersection of segment lhs->rhs with plane z=0
    (polygon_utils.cuh:7-22). Batched over (..., 3)."""
    lz = lhs[..., 2]
    rz = rhs[..., 2]
    den = lz - rz
    lerp = lz / jnp.where(jnp.abs(den) < 1e-30, 1.0, den)
    lerp = lerp[..., None]
    xy = lerp * rhs[..., :2] + (-lerp * lhs[..., :2] + lhs[..., :2])
    n = jnp.sqrt(jnp.maximum(jnp.sum(xy * xy, axis=-1, keepdims=True), 1e-30))
    xy = xy / n
    return jnp.concatenate([xy, jnp.zeros_like(lz)[..., None]], axis=-1)


def _iz0_c(lx, ly, lz, rx, ry, rz):
    """Componentwise ``iz0``: z of the result is identically 0."""
    den = lz - rz
    lerp = lz / jnp.where(jnp.abs(den) < 1e-30, 1.0, den)
    x = lerp * rx + (-lerp * lx + lx)
    y = lerp * ry + (-lerp * ly + ly)
    n = jnp.sqrt(jnp.maximum(x * x + y * y, 1e-30))
    return x / n, y / n


def clip_polygon_c(vx, vy, vz, vcount, tri_input: bool = False):
    """Componentwise clip core: the layout of the hot paths.

    ``vx``/``vy``/``vz`` are length-5 lists of same-shape batch arrays
    (one per vertex slot, components separate, so every array is a dense
    batch with no small trailing axis).
    Returns ``(ox, oy, oz, vc)`` with the same list-of-5 structure.
    Contract identical to :func:`clip_polygon`.

    ``tri_input=True`` asserts slots 3 and 4 equal slot 0 (the reference
    callers' [v1 v2 v3 v1 v1] convention, ltc_utils.cuh:77/100), which
    halves the per-slot select chains — the LTC hot path.
    """
    b = vcount * 0  # broadcast helper in the batch shape/dtype
    bits = (
        jnp.where(vz[0] > 0.0, 8, b)
        | jnp.where(vz[1] > 0.0, 16, b)
        | jnp.where((vz[2] > 0.0), 32, b)
        | jnp.where((vz[3] > 0.0) & (vcount == 4), 64, b)
    )
    mask = jnp.clip(vcount + bits, 0, 127)

    # case-row fetch: one one-hot matmul.  bf16 is EXACT here (0/1
    # one-hot x integer table values < 128).  The (128, N) one-hot and
    # (16, N) output keep the BATCH on the minor axis.
    flat = mask.reshape(-1)
    onehot = (jnp.arange(128, dtype=jnp.int32)[:, None] == flat[None, :]).astype(jnp.bfloat16)
    rows = jax.lax.dot_general(
        jnp.asarray(CASE_TABLE_T, jnp.bfloat16), onehot,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (16, N)
    r = lambda j: rows[j].astype(jnp.int32).reshape(mask.shape)
    vc = r(0)

    def sel5(idx):  # select vertex slot idx (per lane) -> components
        x, y, z = vx[0], vy[0], vz[0]
        for k in range(1, 3 if tri_input else 5):
            m = idx == k
            x = jnp.where(m, vx[k], x)
            y = jnp.where(m, vy[k], y)
            z = jnp.where(m, vz[k], z)
        return x, y, z

    ox, oy, oz = [], [], []
    for o in range(5):
        op, a, bb = r(1 + o), r(6 + o), r(11 + o)
        ax, ay, az = sel5(a)
        bx, by, bz = sel5(bb)
        zx, zy = _iz0_c(ax, ay, az, bx, by, bz)
        is_iz = op == _IZ0
        ox.append(jnp.where(is_iz, zx, ax))
        oy.append(jnp.where(is_iz, zy, ay))
        oz.append(jnp.where(is_iz, 0.0, az))
    return ox, oy, oz, vc


def clip_polygon(verts: jnp.ndarray, vcount: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Clip polygons to z >= 0.

    verts: (..., 5, 3) with the convention verts[vcount..] = verts[0] for
    inputs below 5 vertices (as the reference's callers arrange,
    ltc_utils.cuh:77/100). vcount: (...,) int32 in {0, 3, 4}.
    Returns (clipped (..., 5, 3), new_count (...,)).

    Thin pack/unpack wrapper over :func:`clip_polygon_c` (the layout the
    hot paths use), so the oracle tests validate the real core.
    """
    vx = [verts[..., j, 0] for j in range(5)]
    vy = [verts[..., j, 1] for j in range(5)]
    vz = [verts[..., j, 2] for j in range(5)]
    ox, oy, oz, vc = clip_polygon_c(vx, vy, vz, vcount)
    out = jnp.stack(
        [jnp.stack([ox[j], oy[j], oz[j]], axis=-1) for j in range(5)], axis=-2
    )
    return out, vc
