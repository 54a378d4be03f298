"""G-buffer-guided edge-avoiding denoiser (à-trous bilateral).

The reference's denoise stage exists only as a fully-commented OptiX-HDR
stub (include/viewer.hpp:847-962) plus an empty
``cuda_include/denoise/bilateral.cuh`` — yet its ratio pipeline *assumes*
denoised buffers (ltc_ratio_estimator.py:5-6 reads stodirectDenoise.exr).
This implements the real component: an edge-avoiding à-trous wavelet
filter (Dammertz et al. 2010) guided by the normal/position g-buffers,
as pure fused jnp (shifts + weighted sums).
"""

from __future__ import annotations

import jax.numpy as jnp

# 5-tap B3-spline, separably applied as 25 2-D taps
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _shift2d(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift with edge clamping; channel-FIRST layout (C, H, W).

    Channel-first keeps each plane a dense (H, W) array instead of a
    small trailing channel axis.
    """
    if dy != 0:
        x = jnp.roll(x, dy, axis=-2)
        if dy > 0:
            x = x.at[..., :dy, :].set(x[..., dy : dy + 1, :])
        else:
            x = x.at[..., dy:, :].set(x[..., dy - 1 : dy, :])
    if dx != 0:
        x = jnp.roll(x, dx, axis=-1)
        if dx > 0:
            x = x.at[..., :dx].set(x[..., dx : dx + 1])
        else:
            x = x.at[..., dx:].set(x[..., dx - 1 : dx])
    return x


def atrous_denoise(
    color: jnp.ndarray,  # (H, W, C) noisy buffer
    normal: jnp.ndarray,  # (H, W, 3) g-buffer
    position: jnp.ndarray,  # (H, W, 3) g-buffer
    iterations: int = 4,
    sigma_color: float | None = None,
    sigma_normal: float = 0.25,
    sigma_position: float = 0.05,
) -> jnp.ndarray:
    """Edge-avoiding à-trous filtering.

    sigma_position is relative to the scene diagonal (position differences
    are normalized by the buffer's extent, so the default works across
    scene scales).  sigma_color defaults to None (no color edge-stopping):
    the inputs here are high-variance MC buffers where a color term only
    blocks the smoothing — edges are protected by the normal/position
    g-buffers instead; pass a value for low-noise inputs.
    """
    pos_scale = jnp.maximum(
        jnp.max(position.reshape(-1, 3), axis=0) - jnp.min(position.reshape(-1, 3), axis=0),
        1e-6,
    ).max()
    # channel-first internally (see _shift2d)
    out = jnp.moveaxis(color, -1, 0)  # (C, H, W)
    nrm = jnp.moveaxis(normal, -1, 0)  # (3, H, W)
    pos = jnp.moveaxis(position, -1, 0) / pos_scale
    for it in range(iterations):
        step = 1 << it
        accum = jnp.zeros_like(out)
        wsum = jnp.zeros(out.shape[1:], out.dtype)  # (H, W)
        sc = None if sigma_color is None else sigma_color * (2.0**-it)
        for iy, wy in enumerate(_B3):
            for ix, wx in enumerate(_B3):
                dy = (iy - 2) * step
                dx = (ix - 2) * step
                c_q = _shift2d(out, dy, dx)
                n_q = _shift2d(nrm, dy, dx)
                p_q = _shift2d(pos, dy, dx)
                d_n = jnp.sum((nrm - n_q) ** 2, axis=0)  # (H, W)
                d_p = jnp.sum((pos - p_q) ** 2, axis=0)
                w = (
                    (wy * wx)
                    * jnp.exp(-d_n / (sigma_normal * sigma_normal))
                    * jnp.exp(-d_p / (sigma_position * sigma_position))
                )
                if sc is not None:
                    d_c = jnp.sum((out - c_q) ** 2, axis=0)
                    w = w * jnp.exp(-d_c / (sc * sc))
                accum = accum + w[None] * c_q
                wsum = wsum + w
        out = accum / jnp.maximum(wsum, 1e-10)[None]
    return jnp.moveaxis(out, 0, -1)


def ratio_combine(
    ltc: jnp.ndarray,  # (H, W, 3) analytic LTC direct
    sto_direct: jnp.ndarray,  # (H, W, 1) shadowed stochastic (denoised)
    sto_no_vis: jnp.ndarray,  # (H, W, 1) unshadowed stochastic (denoised)
    eps: float = 1e-4,
) -> jnp.ndarray:
    """final = ltc * D / N (ltc_ratio_estimator.py:4-10), on device.

    Where the unshadowed estimate is ~0 (no light reaches the point even
    without occlusion) the ratio is defined as 0.
    """
    ratio = jnp.where(sto_no_vis > eps, sto_direct / jnp.maximum(sto_no_vis, eps), 0.0)
    return ltc * ratio
