"""Pallas (Triton route) intersection kernels vs the jnp oracle.

Interpret mode validates the kernel logic ray-for-ray on the CPU; the
``gpu``-marked test compiles the real Triton lowering on the card.
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from optix_renderer_tpu.accel import pallas_trace as pt
from optix_renderer_tpu.accel.traverse import intersect_brute
from optix_renderer_tpu.core.types import Ray


@pytest.fixture(scope="module")
def random_case():
    rng = np.random.default_rng(7)
    T, N = 53, 700  # ragged on purpose (pads tris to 64, rays to 768)
    tris = (rng.normal(size=(T, 3, 3)) * 2).astype(np.float32)
    o = (rng.normal(size=(N, 3)) * 3).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = Ray(origin=jnp.asarray(o), direction=jnp.asarray(d))
    v0 = tris[:, 0]
    tab = pt.pack_tri_table(v0, tris[:, 1] - v0, tris[:, 2] - v0, np.arange(T))
    return tris, rays, tab


def test_closest_matches_oracle(random_case):
    tris, rays, tab = random_case
    got = pt.trace_closest_tiles(tab, rays, interpret=True)
    want = intersect_brute(jnp.asarray(tris), rays)
    assert (np.asarray(got.tri_id) == np.asarray(want.tri_id)).all()
    m = np.asarray(want.tri_id) >= 0
    assert m.sum() > 50  # the case must actually exercise hits
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(want.t)[m], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.bary_u)[m], np.asarray(want.bary_u)[m], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.bary_v)[m], np.asarray(want.bary_v)[m], rtol=1e-3, atol=1e-4)


def test_any_matches_oracle_per_ray_tmax(random_case):
    tris, rays, tab = random_case
    rng = np.random.default_rng(8)
    tmax = rng.uniform(0.5, 6.0, size=rays.origin.shape[0]).astype(np.float32)
    got = pt.trace_any_tiles(tab, rays, t_max=jnp.asarray(tmax), interpret=True)
    want = intersect_brute(jnp.asarray(tris), rays, t_max=jnp.asarray(tmax))
    assert (np.asarray(got) == (np.asarray(want.tri_id) >= 0)).all()


def test_miss_lanes(random_case):
    """Rays pointed away from everything: tri_id == -1, not occluded."""
    tris, _, tab = random_case
    n = 130
    o = np.full((n, 3), 100.0, np.float32)
    d = np.tile(np.asarray([1.0, 0.0, 0.0], np.float32), (n, 1))
    rays = Ray(origin=jnp.asarray(o), direction=jnp.asarray(d))
    got = pt.trace_closest_tiles(tab, rays, interpret=True)
    assert (np.asarray(got.tri_id) == -1).all()
    assert not np.asarray(pt.trace_any_tiles(tab, rays, interpret=True)).any()


@pytest.mark.gpu
def test_compiled_kernels_match_oracle(random_case):
    """The Triton lowering itself (not interpret mode) on the card."""
    tris, rays, tab = random_case
    got = pt.trace_closest_tiles(tab, rays)
    want = intersect_brute(jnp.asarray(tris), rays)
    assert (np.asarray(got.tri_id) == np.asarray(want.tri_id)).all()
    m = np.asarray(want.tri_id) >= 0
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(want.t)[m], rtol=1e-5)
    occ = pt.trace_any_tiles(tab, rays)
    assert (np.asarray(occ) == m).all()


def test_t_min_respected(random_case):
    """Per-ray t_min (the packed ray row 7) bounds hits from below."""
    tris, rays, tab = random_case
    n = rays.origin.shape[0]
    t_min = jnp.asarray(np.random.default_rng(3).uniform(0.0, 4.0, n).astype(np.float32))
    got = pt.trace_closest_tiles(tab, rays, t_min=t_min, interpret=True)
    want = intersect_brute(jnp.asarray(tris), rays, t_min=t_min)
    assert (np.asarray(got.tri_id) == np.asarray(want.tri_id)).all()
    occ = pt.trace_any_tiles(tab, rays, t_min=t_min, interpret=True)
    assert (np.asarray(occ) == (np.asarray(want.tri_id) >= 0)).all()


@pytest.mark.parametrize("query", ["closest", "any"])
def test_brute_tier_platform_choice(query):
    """The brute tier lowers to the Triton kernel for CUDA and to the jnp
    loop for the CPU, from one traced program."""
    from optix_renderer_tpu.accel import traverse
    from optix_renderer_tpu.accel.build import build_bvh

    rng = np.random.default_rng(1)
    bvh = build_bvh(rng.random((40, 3, 3)).astype(np.float32))
    o = rng.random((300, 3)).astype(np.float32) - 2.0
    d = np.tile(np.float32([1.0, 1.0, 1.0]) / np.sqrt(3.0), (300, 1))
    rays = Ray(origin=jnp.asarray(o), direction=jnp.asarray(d))
    fn = traverse.trace_closest_brute if query == "closest" else traverse.trace_any_brute
    ref = (traverse.trace_closest_brute_jnp if query == "closest"
           else traverse.trace_any_brute_jnp)
    f = jax.jit(fn)
    got, want = f(bvh, rays), ref(bvh, rays)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert "triton" not in f.lower(bvh, rays).as_text().lower()
    cuda = f.trace(bvh, rays).lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" in cuda.lower()
