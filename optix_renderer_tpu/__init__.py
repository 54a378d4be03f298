"""optix_renderer_tpu — a physically-based rendering framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
OptiX/OWL renderer ``dhawal1939/optix_renderer`` (see SURVEY.md):

- JSON scene description + OBJ/MTL/texture loading (``scene/``)
- host-built LBVH with a vectorized wavefront traversal replacing
  hardware RT cores (``accel/``)
- Frostbite-style GGX+Lambert BSDF with VNDF sampling (``shading/``)
- LTC analytic area-light direct lighting, LTC x stochastic ratio
  estimator, and a full-MIS multi-bounce path tracer (``integrators/``)
- progressive accumulation, g-buffers, camera model, render loop
  (``engine/``)
- image-tile sharding across a device mesh (``parallel/``)
- bilateral/a-trous denoiser, tonemap, image IO (``postprocess/``)

The steady-state trace->shade->sample->accumulate loop runs entirely on
device under ``jax.jit``; scene build (OBJ load, BVH construction, light
setup) happens on host.
"""

__version__ = "0.1.0"
