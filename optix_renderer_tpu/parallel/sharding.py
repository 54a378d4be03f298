"""Image-tile data parallelism over a device mesh.

The reference is strictly single-GPU (``owlContextCreate(nullptr, 1)``,
viewer.hpp:177); scaling is added here (SURVEY.md §2.4):

* a 1-D ``Mesh`` over the devices with axis ``"tiles"`` (the cards of one
  host are joined all to all, so the mesh follows the algorithm alone);
* the accumulation buffer (and g-buffers) are sharded by image rows;
* scene arrays and the BVH are replicated — rendering is embarrassingly
  parallel, so the steady-state loop has **zero** cross-chip
  communication (collectives appear only if the caller gathers the image
  to the host, which jax does lazily on ``np.asarray``);
* inside ``shard_map`` each chip computes its absolute row offset from
  ``lax.axis_index`` and renders its tile with *absolute* pixel ids, so
  RNG streams match the single-chip renderer **bit-exactly** (SURVEY §4:
  tile-sharded render must be bit-identical to single-chip).

The alternative axis — sharding spp instead of tiles, combining with a
``psum`` over the accumulators — is implemented below as
``make_spp_sharded_frame_fn`` (each chip renders the full frame with a disjoint
sample-id slice; one collective at the end).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.types import RenderState
from ..engine.modes import RendererType
from ..engine.renderer import render_tile


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the first n devices; axis name 'tiles'."""
    devices = list(devices or jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, axis_names=("tiles",))


def shard_render_state(state: RenderState, mesh: Mesh) -> RenderState:
    """Place accum row-sharded, camera/accum_id replicated."""
    acc_sharding = NamedSharding(mesh, P("tiles", None, None))
    rep = NamedSharding(mesh, P())
    return RenderState(
        accum=jax.device_put(state.accum, acc_sharding),
        accum_id=jax.device_put(state.accum_id, rep),
        camera=jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), state.camera),
    )


def replicate(tree, mesh: Mesh):
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), tree)


def make_spp_sharded_frame_fn(
    mesh: Mesh,
    mode: RendererType,
    width: int,
    height: int,
    path_depth: int = 10,
    ratio_samples: int = 4,
):
    """spp-parallel rendering: every chip renders the FULL image for a
    different accumulation id and a ``psum`` combines the frames
    (the alternative axis SURVEY §2.4 names; the one place the steady
    state uses a collective).

    One sharded step advances accumulation by ``n_devices`` frames; the
    result matches ``n_devices`` sequential single-chip frames up to
    summation order (RNG streams are keyed by (accum_id, pixel), so each
    chip computes exactly one of the sequential frames).

    Returns ``frame(state, ds, bvh) -> (state', gbuffers, aux)`` where the
    g-buffers/aux carry a leading device axis (one entry per frame id).
    """
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]

    def body(accum, accum_id, camera, ds, bvh):
        my_id = jax.lax.axis_index(axis)
        color, gb, aux = render_tile(
            camera,
            accum_id + my_id,
            ds,
            bvh,
            0,
            mode=mode,
            width=width,
            height=height,
            rows=height,
            path_depth=path_depth,
            ratio_samples=ratio_samples,
        )
        combined = jax.lax.psum(color.reshape(height, width, 3), axis)
        return accum + combined, gb, aux

    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=(P(), P(axis), P(axis)),
        check_vma=False,
    )

    @functools.partial(jax.jit, donate_argnums=(0,))
    def frame(state: RenderState, ds, bvh):
        accum, gb, aux = mapped(state.accum, state.accum_id, state.camera, ds, bvh)
        new_state = RenderState(
            accum=accum, accum_id=state.accum_id + n_dev, camera=state.camera
        )
        return new_state, gb, aux

    return frame


def make_sharded_frame_fn(
    mesh: Mesh,
    mode: RendererType,
    width: int,
    height: int,
    path_depth: int = 10,
    ratio_samples: int = 4,
):
    """jitted ``frame(state, ds, bvh) -> (state', gbuffers, aux)`` running
    one tile per chip. Output shardings match inputs (accum/gbuffers row-
    sharded), so progressive accumulation never leaves the chips."""
    n_tiles = mesh.devices.size
    assert height % n_tiles == 0, f"height {height} must divide into {n_tiles} tiles"
    rows = height // n_tiles

    def tile_body(accum, accum_id, camera, ds, bvh):
        row_offset = jax.lax.axis_index("tiles") * rows
        color, gb, aux = render_tile(
            camera,
            accum_id,
            ds,
            bvh,
            row_offset,
            mode=mode,
            width=width,
            height=height,
            rows=rows,
            path_depth=path_depth,
            ratio_samples=ratio_samples,
        )
        return accum + color.reshape(rows, width, 3), gb, aux

    # check_vma=False: the traversal while_loop carries mix replicated
    # inits with tile-varying ray state; the VMA checker would demand
    # explicit pcasts on every carry. The map is purely data-parallel
    # (no collectives), so the replication check adds nothing here.
    tile_mapped = jax.shard_map(
        tile_body,
        mesh=mesh,
        in_specs=(P("tiles", None, None), P(), P(), P(), P()),
        out_specs=(P("tiles", None, None), P("tiles"), P("tiles")),
        check_vma=False,
    )

    @functools.partial(jax.jit, donate_argnums=(0,))
    def frame(state: RenderState, ds, bvh):
        accum, gb, aux = tile_mapped(state.accum, state.accum_id, state.camera, ds, bvh)
        new_state = RenderState(
            accum=accum, accum_id=state.accum_id + 1, camera=state.camera
        )
        return new_state, gb, aux

    return frame
