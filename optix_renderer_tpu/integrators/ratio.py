"""LTC x stochastic ratio estimator (BASELINE config 3).

Implements the *intended* pipeline of ``cuda_include/ratio/ratio.cuh`` +
deviceCode.cu:117-144 (the committed kernel zeroes the BRDF so its
stochastic buffers are black — SURVEY §2.9 quirk #2): per pixel,

* the analytic LTC direct color (the main accumulated output), and
* 4-sample averaged single-bounce stochastic direct lighting, once WITH
  visibility ("sto_direct") and once WITHOUT ("sto_no_vis"), stored as
  grayscale means.

The final ratio image ``ltc * D / N`` is assembled on device by
``postprocess.ratio_combine`` after denoising (the reference does this
offline in ltc_ratio_estimator.py:4-10).

Deviations from the committed quirks, documented:

* the solid-angle pdf for both estimators uses the *sampled* light's
  geometry (the reference reuses the shadow-hit surface's normal even
  when the ray hit a wall, ratio.cuh:51, which makes the unshadowed
  estimator depend on occluders);
* the shadowed estimator credits the *sampled* light's emission gated by
  true visibility of the sampled point (trace_any to the sample), not the
  emission of whichever light the closest-hit shadow ray struck
  (ratio.cuh:61) — with multiple lights of different emission the
  reference's estimator mixes pdfs and emissions of different lights.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import math as cm
from ..core import rng as rnglib
from ..core.types import Ray, SurfaceInteraction
from ..scene.device import DeviceScene
from ..shading import material
from .ltc_direct import ltc_direct
from .path import _clamp_dot, gather_light_attrs, pdf_area_to_solid_angle


def _stochastic_direct_sample(ds, si, wo_local, to_local, rng, ray_eps):
    """One light sample -> (unshadowed rgb, shadow ray dir, dist, rng).

    The visibility trace is NOT issued here: the caller batches all
    n_samples shadow rays into one (n_samples*N,) any-hit call.
    """
    num_lights = ds.num_lights
    rng, u1, u2 = rnglib.lcg_randomf2(rng)  # rand1 (ratio.cuh:29)
    rng, _, _ = rnglib.lcg_randomf2(rng)  # rand2 drawn but unused (ratio.cuh:30)
    rng, pick = rnglib.lcg_randomf(rng)  # light index (ratio.cuh:33)
    lidx = jnp.clip((pick * num_lights).astype(jnp.int32), 0, num_lights - 1)

    lv1, lv2, lv3, lnormal, lemit, larea = gather_light_attrs(ds, lidx)
    light_pdf_a = 1.0 / (larea * num_lights)
    lp = cm.sample_point_on_triangle(lv1, lv2, lv3, u1, u2)
    shadow_origin = si.p + si.n_geom * ray_eps
    to_light = lp - shadow_origin
    dist2 = jnp.sum(to_light * to_light, axis=-1)
    dist = jnp.sqrt(dist2)
    ldir = to_light / jnp.maximum(dist, 1e-30)[:, None]

    # solid-angle pdf from the sampled light's own normal (see docstring)
    light_pdf_w = pdf_area_to_solid_angle(light_pdf_a, dist2, cm.dot(-ldir, lnormal))

    wi_local = cm.normalize(cm.apply_mat(to_local, ldir), eps=1e-30)
    brdf = material.evaluate(wi_local, wo_local, si.diffuse, si.alpha)

    weight = _clamp_dot(si.n_geom, ldir) / jnp.where(light_pdf_w == 0.0, 1.0, light_pdf_w)
    contrib = lemit * brdf * weight[:, None]
    contrib = jnp.where((light_pdf_w > 0.0)[:, None], cm.check_positive(contrib), 0.0)

    return contrib, ldir, dist, rng


def ratio_color(
    ds: DeviceScene,
    bvh,
    rays: Ray,
    si: SurfaceInteraction,
    rng_state: jnp.ndarray,
    n_samples: int = 4,
    ray_eps: float = 1e-3,
):
    """RATIO-mode frame (deviceCode.cu:117-144).

    Returns (accumulated color = LTC, rng, aux buffers {ltc, sto_direct,
    sto_no_vis} each (N, k)).
    """
    from ..accel.traverse import trace_any

    ltc_color = ltc_direct(ds, rays, si)

    wo = cm.normalize(rays.origin - si.p, eps=1e-30)
    to_local, _ = cm.orthonormal_basis(si.n_geom)
    wo_local = cm.normalize(cm.apply_mat(to_local, wo), eps=1e-30)

    n = rays.origin.shape[0]
    rng = rng_state
    contribs, dirs, dists = [], [], []
    for _ in range(n_samples):  # 4-sample average (deviceCode.cu:128-136)
        c, ldir, dist, rng = _stochastic_direct_sample(
            ds, si, wo_local, to_local, rng, ray_eps
        )
        contribs.append(c)
        dirs.append(ldir)
        dists.append(dist)

    # one batched (n_samples*N,) visibility trace (see _stochastic_direct_sample)
    shadow_origin = si.p + si.n_geom * ray_eps
    all_rays = Ray(
        origin=jnp.tile(shadow_origin, (n_samples, 1)),
        direction=jnp.concatenate(dirs, axis=0),
    )
    all_dist = jnp.concatenate(dists, axis=0)
    occ_all = trace_any(bvh, all_rays, t_max=all_dist * (1.0 - 1e-3))
    occ = occ_all.reshape(n_samples, n)

    no_vis = sum(contribs) / n_samples
    direct = sum(
        jnp.where(occ[k][:, None], 0.0, contribs[k]) for k in range(n_samples)
    ) / n_samples

    # grayscale means (deviceCode.cu:140-143)
    g_direct = jnp.mean(direct, axis=-1, keepdims=True)
    g_no_vis = jnp.mean(no_vis, axis=-1, keepdims=True)

    # lights write raw emission into all three buffers (deviceCode.cu:118-124)
    is_l = si.is_light[:, None]
    hit = si.hit[:, None]
    ltc_buf = jnp.where(is_l, si.emit, ltc_color)
    ltc_buf = jnp.where(hit, ltc_buf, ds.miss_color[None, :])
    emit_gray = jnp.mean(si.emit, axis=-1, keepdims=True)
    sto_d = jnp.where(hit, jnp.where(is_l, emit_gray, g_direct), 0.0)
    sto_n = jnp.where(hit, jnp.where(is_l, emit_gray, g_no_vis), 0.0)

    aux = {"ltc": ltc_buf, "sto_direct": sto_d, "sto_no_vis": sto_n}
    return ltc_buf, rng, aux
