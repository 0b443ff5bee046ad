"""Ray-axis sharding over a device mesh.

Rays are embarrassingly parallel except at one point: the flux reduction
onto the shared vertical grid inside the RHS (the reference's single
ray→grid transpose, ``lib/libprop.py:653-663``).  We shard the ray axis
with ``shard_map``; each shard scatters its local pseudo-momentum flux
(O(n_cell) floats) and a single ``psum`` per RHS evaluation — 3 per RK3
step — produces the replicated profile, after which every shard
computes the identical mean-flow update (kept replicated by construction).

The mean-flow state, background, and config are replicated; per-shard ray
buffers keep static shapes, so ``capacity`` must be divisible by the mesh
size.  Numerical note: cross-shard ``psum`` ordering differs from the
single-shard reduction order, so sharded results match unsharded to
roundoff (tested at 1e-12 in float64), not bitwise.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ModelConfig, RunConfig
from ..state import Background, MeanState, RayState, RayStatics, State
from ..models.integrate import simulate, step


RAY_AXIS = "rays"


def make_mesh(n_devices: Optional[int] = None, axis: str = RAY_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return jax.make_mesh((len(devs),), (axis,), devices=devs)


def ray_sharding_specs(axis: str = RAY_AXIS):
    """PartitionSpecs for (State, RayStatics): ray fields split along
    ``axis``, mean-flow fields replicated."""
    ray = P(axis)
    rep = P()
    state_spec = State(
        RayState(*([ray] * len(RayState._fields))),
        MeanState(rep, rep),
    )
    statics_spec = RayStatics(ray, ray, ray, ray)
    return state_spec, statics_spec


def shard_state(mesh: Mesh, state: State, statics: RayStatics, axis: str = RAY_AXIS):
    """Place (state, statics) on the mesh with ray-axis sharding."""
    n = state.rays.dens.shape[0]
    n_dev = mesh.devices.size
    if n % n_dev:
        raise ValueError(
            f"ray capacity {n} is not divisible by the mesh size {n_dev}; "
            f"pad with msgwam_tpu.pad_rays to a multiple first"
        )
    state_spec, statics_spec = ray_sharding_specs(axis)
    put = lambda x, s: jax.device_put(x, NamedSharding(mesh, s))
    state = jax.tree.map(put, state, state_spec)
    statics = jax.tree.map(put, statics, statics_spec)
    return state, statics


def sharded_step_fn(
    mesh: Mesh,
    bg: Background,
    cfg: ModelConfig,
    dt: float,
    axis: str = RAY_AXIS,
) -> Callable:
    """A jitted single-step function sharded over the ray axis:
    ``f(state, statics) -> (state, statics)``."""
    state_spec, statics_spec = ray_sharding_specs(axis)

    def body(state, statics):
        state, statics, _ = step(dt, state, statics, bg, cfg, axis_name=axis)
        return state, statics

    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(state_spec, statics_spec),
        out_specs=(state_spec, statics_spec),
    )
    return jax.jit(mapped)


def sharded_simulate(
    mesh: Mesh,
    state: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    run: RunConfig,
    observe: Optional[Callable] = None,
    observe_spec=None,
    source=None,
    axis: str = RAY_AXIS,
):
    """Run :func:`msgwam_tpu.models.integrate.simulate` sharded over the ray
    axis.  ``observe`` defaults to recording the (replicated) mean-flow
    profile per saved step; a custom ``observe`` needs a matching
    ``observe_spec`` PartitionSpec pytree for its output.
    """
    fn = build_sharded_simulate_fn(
        mesh, cfg, run, observe=observe, observe_spec=observe_spec, axis=axis
    )
    state, statics = shard_state(mesh, state, statics, axis)
    if source is None:
        return fn(state, statics, bg)
    return fn(state, statics, bg, source)


def _default_observe(s, st, aux):
    return s.mean


def full_history_observe(s, st, aux):
    """``observe`` matching :func:`simulate`'s default history tuple
    ``(state, active, dens_prop)`` — use with
    :func:`full_history_observe_spec` to get the unsharded driver's
    history structure out of a sharded run."""
    return (s, st.active, aux.dens_prop)


def full_history_observe_spec(axis: str = RAY_AXIS):
    """PartitionSpec pytree for :func:`full_history_observe`.  History
    entries carry a leading time axis (``simulate`` stacks the observed
    frames), so per-ray buffers are ``(n_frames, capacity)`` sharded on
    axis 1; mean-flow profiles are replicated."""
    ray = P(None, axis)
    state_spec = State(
        RayState(*([ray] * len(RayState._fields))),
        MeanState(P(), P()),
    )
    return (state_spec, ray, ray)


@functools.lru_cache(maxsize=64)
def build_sharded_simulate_fn(
    mesh: Mesh,
    cfg: ModelConfig,
    run: RunConfig,
    observe: Optional[Callable] = None,
    observe_spec=None,
    axis: str = RAY_AXIS,
) -> Callable:
    """Build (and cache) the jitted sharded runner
    ``f(state, statics, bg[, source]) -> (final, statics, history)``.
    Cached on its (hashable) arguments so repeated calls reuse the
    compiled program; ``observe`` must be a top-level function."""
    state_spec, statics_spec = ray_sharding_specs(axis)
    if observe is None:
        observe = _default_observe
        observe_spec = MeanState(P(), P())
    elif observe_spec is None:
        raise ValueError("custom observe requires observe_spec")
    bg_spec = Background(P(), P(), P(), P())
    source_spec = (
        RayState(*([state_spec.rays[0]] * len(RayState._fields))),
        statics_spec,
    )

    def body(state, statics, bg, source=None):
        return simulate(
            state, statics, bg, cfg, run,
            observe=observe, source=source, axis_name=axis,
        )

    def run_plain(state, statics, bg):
        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(state_spec, statics_spec, bg_spec),
            out_specs=(state_spec, statics_spec, observe_spec),
        )(state, statics, bg)

    def run_src(state, statics, bg, source):
        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(state_spec, statics_spec, bg_spec, source_spec),
            out_specs=(state_spec, statics_spec, observe_spec),
        )(state, statics, bg, source)

    def dispatch(state, statics, bg, source=None):
        if source is None:
            return jax.jit(run_plain)(state, statics, bg)
        return jax.jit(run_src)(state, statics, bg, source)

    return dispatch
