"""Fused LTC Pallas kernel (shading.ltc_pallas) vs the XLA pipeline.

The kernel repeats the arithmetic of ltc.integrate_over_polygon operation-
for-operation, so outputs match to float noise — except on clip-case
boundary lanes (a transformed vertex z within an ulp of 0 can resolve to a
different clip case between the two compilations).  The test therefore
checks near-exact agreement on the vast majority of lanes plus a tight
mean error, rather than a uniform elementwise bound.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optix_renderer_tpu.core import math as cm
from optix_renderer_tpu.shading import ltc
from optix_renderer_tpu.shading.ltc_pallas import (
    ltc_integrate_pallas,
    pack_lights,
)
from optix_renderer_tpu.shading.polygon_clip import clip_polygon_c
from optix_renderer_tpu.shading.ltc_pallas import _clip, _ALL_CASES, _TRI_CASES


def _random_inputs(seed, R=1500, L=3):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(R, 3)).astype(np.float32) * 2.0
    n = rng.normal(size=(R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    wo = rng.normal(size=(R, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    diffuse = rng.uniform(0, 1, size=(R, 3)).astype(np.float32)
    alpha = rng.uniform(0.01, 1, size=(R,)).astype(np.float32)

    to_local, _ = cm.orthonormal_basis(jnp.asarray(n))
    wo_local = cm.normalize(cm.apply_mat(to_local, jnp.asarray(wo)), eps=1e-30)
    theta = cm.spherical_theta(wo_local)
    ltc_mat, amplitude = ltc.fetch_ltc_mat(jnp.asarray(alpha), theta)
    ltc_mat_inv = cm.matrix_inverse_3x3(ltc_mat)
    iso = ltc.iso_frame_from_wo_local(wo_local)

    lv1 = rng.normal(size=(L, 3)).astype(np.float32) * 3 + np.array([0, 4, 0], np.float32)
    lv2 = lv1 + rng.normal(size=(L, 3)).astype(np.float32)
    lv3 = lv1 + rng.normal(size=(L, 3)).astype(np.float32)
    lnorm = np.cross(lv2 - lv1, lv3 - lv1)
    lnorm = (lnorm / np.linalg.norm(lnorm, axis=1, keepdims=True)).astype(np.float32)
    lemit = rng.uniform(0, 5, size=(L, 3)).astype(np.float32)
    return (p, diffuse, to_local, iso, ltc_mat_inv, amplitude,
            lv1, lv2, lv3, lnorm, lemit)


def test_static_select_clip_matches_table_clip():
    """_clip (trace-time case resolution) is bit-identical to the one-hot
    table clip (polygon_clip.clip_polygon_c) on live slots + vc."""
    rng = np.random.default_rng(1)
    N = 5000
    v = rng.normal(size=(3, 3, N)).astype(np.float32)
    j = lambda a: jnp.asarray(a)
    vx = [j(v[0, 0]), j(v[1, 0]), j(v[2, 0]), j(v[0, 0]), j(v[0, 0])]
    vy = [j(v[0, 1]), j(v[1, 1]), j(v[2, 1]), j(v[0, 1]), j(v[0, 1])]
    vz = [j(v[0, 2]), j(v[1, 2]), j(v[2, 2]), j(v[0, 2]), j(v[0, 2])]
    for vals, cases in ((np.full(N, 3), _TRI_CASES),
                        (rng.choice([0, 3, 4], size=N), _ALL_CASES)):
        vc_in = jnp.asarray(vals.astype(np.int32))
        rx, ry, rz, rvc = clip_polygon_c(vx, vy, vz, vc_in, tri_input=True)
        kx, ky, kz, kvc = _clip(vx, vy, vz, vc_in, cases)
        assert bool(jnp.all(rvc == kvc))
        for s in range(5):
            live = s < rvc
            for a, b in ((rx[s], kx[s]), (ry[s], ky[s]), (rz[s], kz[s])):
                assert float(jnp.where(live, jnp.abs(a - b), 0.0).max()) == 0.0


@pytest.mark.parametrize("seed,L", [(0, 1), (1, 3), (2, 7)])
def test_ltc_kernel_matches_xla_pipeline(seed, L):
    (p, diffuse, to_local, iso, ltc_mat_inv, amplitude,
     lv1, lv2, lv3, lnorm, lemit) = _random_inputs(seed, L=L)
    R = p.shape[0]

    ref = ltc.integrate_over_polygon(
        jnp.asarray(p), jnp.asarray(diffuse), to_local, iso, ltc_mat_inv,
        amplitude, jnp.asarray(lv1), jnp.asarray(lv2), jnp.asarray(lv3),
        jnp.asarray(lnorm), jnp.asarray(lemit))

    mat_a = ltc._matmul33(iso, to_local)
    mat_b = ltc._matmul33(ltc_mat_inv, mat_a)
    lights = pack_lights(jnp.asarray(lv1), jnp.asarray(lv2), jnp.asarray(lv3),
                         jnp.asarray(lnorm), jnp.asarray(lemit))
    out = ltc_integrate_pallas(
        jnp.asarray(p), jnp.asarray(diffuse), mat_a.reshape(R, 9),
        mat_b.reshape(R, 9), amplitude, lights, interpret=True)

    ref = np.asarray(ref)
    out = np.asarray(out)
    assert np.all(np.isfinite(out))
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-3)
    # boundary-case lanes may flip a clip case between compilations; they
    # must be rare and small
    assert (rel > 1e-3).mean() < 0.01, f"too many divergent lanes: {(rel > 1e-3).mean()}"
    assert np.quantile(rel, 0.99) < 1e-3
    assert np.abs(out - ref).max() < 5e-2


def test_ltc_kernel_empty_lights():
    (p, diffuse, to_local, iso, ltc_mat_inv, amplitude,
     *_rest) = _random_inputs(3, L=1)
    R = p.shape[0]
    mat_a = ltc._matmul33(iso, to_local)
    mat_b = ltc._matmul33(ltc_mat_inv, mat_a)
    out = ltc_integrate_pallas(
        jnp.asarray(p), jnp.asarray(diffuse), mat_a.reshape(R, 9),
        mat_b.reshape(R, 9), amplitude, jnp.zeros((0, 16), jnp.float32),
        interpret=True)
    assert out.shape == (R, 3)
    assert float(jnp.abs(out).max()) == 0.0


@pytest.mark.parametrize("R,L", [(1, 1), (257, 5), (600, 2)])
def test_kernel_wrapper_padding(R, L):
    """Ray counts off the block size and light counts off a power of two
    pad inside the wrapper and come back at the caller's shape."""
    (p, diffuse, to_local, iso, ltc_mat_inv, amplitude,
     lv1, lv2, lv3, lnorm, lemit) = _random_inputs(10 + R, R=R, L=L)
    mat_a = ltc._matmul33(iso, to_local)
    mat_b = ltc._matmul33(ltc_mat_inv, mat_a)
    lights = tuple(jnp.asarray(a) for a in (lv1, lv2, lv3, lnorm, lemit))
    args = (jnp.asarray(p), jnp.asarray(diffuse), mat_a, mat_b, amplitude)
    out = ltc_integrate_pallas(*args[:2], mat_a.reshape(R, 9),
                               mat_b.reshape(R, 9), amplitude,
                               pack_lights(*lights), interpret=True)
    assert out.shape == (R, 3)
    ref = np.asarray(ltc.polygon_sum_xla(*args, lights))
    # same tolerance rule as test_ltc_kernel_matches_xla_pipeline
    rel = np.abs(np.asarray(out) - ref) / np.maximum(np.abs(ref), 1e-3)
    assert (rel > 1e-3).mean() < 0.01
    assert np.abs(np.asarray(out) - ref).max() < 5e-2


def test_integrate_over_polygon_takes_plain_path_off_gpu():
    """The platform choice: on a CPU lowering integrate_over_polygon is
    exactly the jnp reference (the kernel is lowered for CUDA only)."""
    (p, diffuse, to_local, iso, ltc_mat_inv, amplitude,
     lv1, lv2, lv3, lnorm, lemit) = _random_inputs(5, R=300, L=3)
    lights = tuple(jnp.asarray(a) for a in (lv1, lv2, lv3, lnorm, lemit))
    got = jax.jit(ltc.integrate_over_polygon)(
        jnp.asarray(p), jnp.asarray(diffuse), to_local, iso, ltc_mat_inv,
        amplitude, *lights)
    mat_a = ltc._matmul33(iso, to_local)
    mat_b = ltc._matmul33(ltc_mat_inv, mat_a)
    want = jax.jit(ltc.polygon_sum_xla)(
        jnp.asarray(p), jnp.asarray(diffuse), mat_a, mat_b, amplitude, lights)
    # two compilations of the same arithmetic differ by float reordering,
    # which the edge integral amplifies near |cos| -> 1 on a few lanes
    rel = np.abs(np.asarray(got) - np.asarray(want)) / np.maximum(np.abs(np.asarray(want)), 1e-3)
    assert (rel > 1e-4).mean() < 0.01
    assert np.quantile(rel, 0.99) < 1e-4
    hlo = jax.jit(ltc.integrate_over_polygon).lower(
        jnp.asarray(p), jnp.asarray(diffuse), to_local, iso, ltc_mat_inv,
        amplitude, *lights).as_text()
    assert "triton" not in hlo.lower()


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_pipeline():
    """The Triton lowering itself (not interpret mode) against the jnp
    reference, both compiled for the card."""
    (p, diffuse, to_local, iso, ltc_mat_inv, amplitude,
     lv1, lv2, lv3, lnorm, lemit) = _random_inputs(4, R=4096, L=3)
    mat_a = ltc._matmul33(iso, to_local)
    mat_b = ltc._matmul33(ltc_mat_inv, mat_a)
    lights = tuple(jnp.asarray(a) for a in (lv1, lv2, lv3, lnorm, lemit))
    args = (jnp.asarray(p), jnp.asarray(diffuse), mat_a, mat_b, amplitude, lights)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(ltc.polygon_sum_xla)(*args))
    out = np.asarray(jax.jit(ltc.polygon_sum_kernel)(*args))
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-3)
    assert np.all(np.isfinite(out))
    assert (rel > 1e-3).mean() < 0.01
