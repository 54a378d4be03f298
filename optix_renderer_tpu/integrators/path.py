"""Multi-bounce path tracer with full MIS (BASELINE config 2).

Implements the *intended* estimator of ``cuda_include/path/path.cuh`` —
next-event estimation + BSDF sampling combined with the balance heuristic
(the committed kernel is short-circuited to a debug output and its NEE half
is commented out; SURVEY §2.9 quirks 1/4/5/7/8 are fixed, and the frame
convention follows deviceCode.cu:82 rather than path.cuh:162's swapped
matrices).

Design: the bounce loop is a ``lax.fori_loop`` over a static depth with
an ``alive`` mask — every lane takes part in the NEE shadow trace and the
BSDF bounce trace each iteration, keeping shapes static; lanes that cannot
contribute are traced with t_max = 0, which the walk tier skips.  Ray
compaction/sorting is a later perf layer; the estimator is already fully
vectorized.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as cm
from ..core import rng as rnglib
from ..core.types import Ray, SurfaceInteraction
from ..scene.device import DeviceScene
from ..shading import material
from ..shading.bsdf import EPS, cos_theta


def pdf_area_to_solid_angle(pdf, dist2, cos_t):
    """pdfA2W (path.cuh:24-33)."""
    abs_cos = jnp.abs(cos_t)
    return jnp.where(abs_cos < 1e-8, 0.0, pdf * dist2 / jnp.where(abs_cos < 1e-8, 1.0, abs_cos))


def _clamp_dot(a, b):
    """clampDot(a, b, zero=false) = max(dot, EPS) (frostbite.cuh:13-16)."""
    return jnp.maximum(cm.dot(a, b), EPS)


_ONEHOT_MAX_LIGHTS = 512


def gather_light_attrs(ds: DeviceScene, lidx: jnp.ndarray):
    """Per-lane TriLight attribute fetch (sampleLight, path.cuh:6-14).

    Small light lists use one exact-precision one-hot matmul over a packed
    (L, 16) attribute matrix instead of six per-lane dynamic gathers.
    Returns (v1, v2, v3, normal, emit, area).
    """
    L = ds.num_lights
    if L > _ONEHOT_MAX_LIGHTS:
        return (
            ds.light_v1[lidx], ds.light_v2[lidx], ds.light_v3[lidx],
            ds.light_normal[lidx], ds.light_emit[lidx], ds.light_area[lidx],
        )
    pack = jnp.concatenate(
        [ds.light_v1, ds.light_v2, ds.light_v3, ds.light_normal,
         ds.light_emit, ds.light_area[:, None]],
        axis=1,
    )  # (L, 16)
    onehot = (lidx[:, None] == jnp.arange(L, dtype=jnp.int32)[None, :]).astype(jnp.float32)
    rows = jnp.dot(
        onehot, pack,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12], rows[:, 12:15], rows[:, 15]


def path_color(
    ds: DeviceScene,
    bvh,
    rays: Ray,
    si: SurfaceInteraction,
    rng_state: jnp.ndarray,
    max_depth: int = 10,
    ray_eps: float = 1e-3,
):
    """Radiance for each primary ray; returns (color (N, 3), rng_state,
    alive_counts (max_depth, 3)).  alive_counts columns per
    bounce: [0] lanes alive (observability), [1] NEE shadow rays actually
    traced (lanes whose contribution is not provably zero), [2] bounce
    closest rays actually traced (valid BSDF samples) — honest ray
    accounting for the Mrays metric instead of 2x the alive count.

    Outer PATH-mode wrapping (deviceCode.cu:146-153): miss lanes get the
    background, direct light hits get raw emission; everything else is the
    path estimate (floored at EPS per channel, path.cuh:254-256).
    """
    from ..accel.traverse import trace_any
    from ..engine.shade import trace_closest_si

    n = rays.origin.shape[0]
    num_lights = ds.num_lights

    # initial state: first-hit surface; V points back toward the camera
    v0 = cm.normalize(rays.origin - si.p, eps=1e-30)
    init = dict(
        alive_counts=jnp.zeros((max_depth, 3), jnp.int32),
        color=jnp.zeros((n, 3), jnp.float32),
        tp=jnp.ones((n, 3), jnp.float32),
        alive=si.hit & ~si.is_light,
        p=si.p,
        n=si.n_geom,
        diffuse=si.diffuse,
        alpha=si.alpha,
        v=v0,
        rng=rng_state,
    )

    def bounce(d, s):
        alive = s["alive"]
        to_local, to_world = cm.orthonormal_basis(s["n"])
        wo_local = cm.normalize(cm.apply_mat(to_local, s["v"]), eps=1e-30)

        rng = s["rng"]
        rng, l_u1, l_u2 = rnglib.lcg_randomf2(rng)  # rand1 (path.cuh:165)
        rng, b_u1, b_u2 = rnglib.lcg_randomf2(rng)  # rand2 (path.cuh:166)
        rng, l_pick = rnglib.lcg_randomf(rng)  # light index (path.cuh:169)

        light_idx = jnp.clip((l_pick * num_lights).astype(jnp.int32), 0, num_lights - 1)

        # ---- NEE / light sampling (path.cuh:176-205, intended) ----------
        # Shadow rays are *visibility* queries toward the sampled light
        # point (trace_any with per-ray t_max), not closest-hit traces: the
        # sampled light's own emission/normal are already known, so the
        # full SurfaceInteraction gather the round-1 implementation paid
        # per bounce is unnecessary (and any-hit traversal early-outs).
        lv1, lv2, lv3, lnormal, lemit, larea = gather_light_attrs(ds, light_idx)
        light_pdf_a = 1.0 / (larea * num_lights)  # sampleLightPdf
        lp = cm.sample_point_on_triangle(lv1, lv2, lv3, l_u1, l_u2)
        shadow_origin = s["p"] + s["n"] * ray_eps
        to_light = lp - shadow_origin
        dist2 = jnp.sum(to_light * to_light, axis=-1)
        dist = jnp.sqrt(dist2)
        ldir = to_light / jnp.maximum(dist, 1e-30)[:, None]

        light_pdf_w = pdf_area_to_solid_angle(light_pdf_a, dist2, cm.dot(-ldir, lnormal))
        wi_local_nee = cm.normalize(cm.apply_mat(to_local, ldir), eps=1e-30)
        brdf_pdf_nee = material.pdf(wi_local_nee, wo_local, s["diffuse"], s["alpha"])
        brdf_nee = material.evaluate(wi_local_nee, wo_local, s["diffuse"], s["alpha"])
        mis_nee = cm.balance_heuristic(1, light_pdf_w, 1, brdf_pdf_nee)

        shadow_ray = Ray(origin=shadow_origin, direction=ldir)
        # Lanes whose NEE contribution is provably zero need no visibility
        # query: dead lanes, zero light pdf, and light samples below the
        # BSDF hemisphere (both lobes return 0 outside same_hemisphere,
        # shading/bsdf.py:78,88).  Their t_max = 0 makes the walk tier
        # skip them.  Exact: ``occluded`` is consumed only by nee_ok,
        # which is false for these lanes either way.
        shadow_needed = (
            alive & (light_pdf_w > 0.0) & jnp.any(brdf_nee != 0.0, axis=-1)
        )
        occluded = trace_any(
            bvh, shadow_ray,
            t_max=jnp.where(shadow_needed, dist * (1.0 - 1e-3), 0.0),
        )
        nee_ok = shadow_needed & ~occluded
        nee = (
            mis_nee[:, None]
            * lemit
            * s["tp"]
            * brdf_nee
            * (_clamp_dot(s["n"], ldir) / jnp.where(light_pdf_w == 0.0, 1.0, light_pdf_w))[:, None]
        )
        color = s["color"] + jnp.where(nee_ok[:, None], cm.check_positive(nee), 0.0)

        # ---- BSDF sampling (path.cuh:207-245, intended) ------------------
        wi_local, bsdf_pdf, valid = material.sample_direction(
            wo_local, b_u1, b_u2, s["diffuse"], s["alpha"]
        )
        cos_i = cos_theta(wi_local)
        sample_ok = alive & valid & (bsdf_pdf > 0.0) & (cos_i > 0.0)

        brdf = material.evaluate(wi_local, wo_local, s["diffuse"], s["alpha"])
        dir_world = cm.normalize(cm.apply_mat(to_world, wi_local), eps=1e-30)
        bounce_ray = Ray(origin=s["p"] + s["n"] * ray_eps, direction=dir_world)
        # lanes that cannot contribute (dead, or an invalid BSDF sample)
        # are marked inactive: they return miss and the walk skips them
        bounce_si = trace_closest_si(ds, bvh, bounce_ray, active=sample_ok)

        hit_light = sample_ok & bounce_si.hit & bounce_si.is_light
        d2 = jnp.sum((bounce_si.p - s["p"]) ** 2, axis=-1)
        lpdf_a = 1.0 / (jnp.maximum(bounce_si.area, 1e-20) * num_lights)
        # area->solid-angle with the cosine at the LIGHT surface, matching
        # the NEE arm's conversion — the balance-heuristic weights for a
        # strategy pair must use the same pdfs or they don't sum to 1.
        # (The reference's dead code used cos_i here, path.cuh:233.)
        lpdf_w = pdf_area_to_solid_angle(lpdf_a, d2, cm.dot(-dir_world, bounce_si.n_geom))
        mis_b = cm.balance_heuristic(1, bsdf_pdf, 1, lpdf_w)
        safe_pdf = jnp.where(bsdf_pdf == 0.0, 1.0, bsdf_pdf)
        emit_term = (
            mis_b[:, None] * bounce_si.emit * s["tp"] * brdf * (cos_i / safe_pdf)[:, None]
        )
        color = color + jnp.where(hit_light[:, None], cm.check_positive(emit_term), 0.0)

        # ---- advance (path.cuh:240, 249-252 with real alpha, quirk #8) ---
        continue_path = sample_ok & bounce_si.hit & ~bounce_si.is_light
        new_tp = s["tp"] * brdf * (cos_i / safe_pdf)[:, None]
        c = continue_path[:, None]
        i32sum = lambda m: jnp.sum(m.astype(jnp.int32))
        alive_counts = s["alive_counts"].at[d].set(
            jnp.stack([i32sum(alive), i32sum(shadow_needed), i32sum(sample_ok)])
        )
        return dict(
            alive_counts=alive_counts,
            color=color,
            tp=jnp.where(c, new_tp, s["tp"]),
            alive=continue_path,
            p=jnp.where(c, bounce_si.p, s["p"]),
            n=jnp.where(c, bounce_si.n_geom, s["n"]),
            diffuse=jnp.where(c, bounce_si.diffuse, s["diffuse"]),
            alpha=jnp.where(continue_path, bounce_si.alpha, s["alpha"]),
            v=jnp.where(c, -dir_world, s["v"]),
            rng=rng,
        )

    # Bounce loop: static fori_loop over max_depth with per-lane alive
    # masks.  Cornell-like closed scenes keep >15% of lanes alive through
    # depth 8, so an all-dead early exit rarely fires where it would
    # matter; compaction is an open question (ROADMAP S4).
    out = jax.lax.fori_loop(0, max_depth, bounce, init)

    # EPS floor on the estimate (path.cuh:254-256), then the outer mode
    # wrapping (deviceCode.cu:146-153)
    estimate = jnp.maximum(out["color"], EPS)
    color = jnp.where(si.is_light[:, None], si.emit, estimate)
    color = jnp.where(si.hit[:, None], color, ds.miss_color[None, :])
    return color, out["rng"], out["alive_counts"]
