"""Ensemble fan-out (BASELINE config 5): many independent simulations —
stochastic-source members, parameter sweeps — vmapped over a leading
``ensemble`` axis and sharded across the mesh.

Members never communicate, so this is pure data parallelism: ``vmap`` the
single-member ``simulate`` and let GSPMD place one slice of the batch per
device (the modern replacement for the reference-era ``pmap`` suggestion in
BASELINE.json).  Combine with :mod:`.sharding` by using a 2-D mesh
``('ensemble', 'rays')`` — not needed until single-member state outgrows a
chip, which at ~10 floats/ray means ~10^8 rays.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ModelConfig, RunConfig
from ..state import Background, RayStatics, State
from ..models.integrate import simulate


ENSEMBLE_AXIS = "ensemble"


def stack_ensemble(members):
    """Stack a list of (state, statics) members into batched pytrees with a
    leading ensemble axis."""
    states = [m[0] for m in members]
    statics = [m[1] for m in members]
    return (
        jax.tree.map(lambda *xs: jnp.stack(xs), *states),
        jax.tree.map(lambda *xs: jnp.stack(xs), *statics),
    )


def ensemble_simulate(
    states: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    run: RunConfig,
    mesh: Optional[Mesh] = None,
    observe: Optional[Callable] = None,
    axis: str = ENSEMBLE_AXIS,
    sequential: bool = False,
    sources=None,
    wind_fn=None,
    t0: float = 0.0,
):
    """Run a batch of simulations (leading ensemble axis on every leaf of
    ``states``/``statics``), sharded over ``mesh`` if given.

    ``sequential=True`` runs members one after another (``lax.map``) instead
    of batching them — the right choice when members outnumber devices and
    each member is large: batching (vmap) the dense projection can defeat
    XLA's fusion of the weight construction into the contraction, while
    sequential members each run at single-member speed.

    ``sources`` (a stacked per-member ``(RayState, RayStatics)`` template
    pair) enables relaunch per member; ``wind_fn``/``t0`` prescribe a
    member-shared transient background, as in :func:`simulate`.
    """
    fn = build_ensemble_fn(
        cfg, run, mesh=mesh, observe=observe, axis=axis,
        sequential=sequential, with_source=sources is not None,
        wind_fn=wind_fn, t0=t0,
    )
    if mesh is not None:
        shard = NamedSharding(mesh, P(axis))
        states = jax.tree.map(lambda x: jax.device_put(x, shard), states)
        statics = jax.tree.map(lambda x: jax.device_put(x, shard), statics)
        if sources is not None:
            sources = jax.tree.map(
                lambda x: jax.device_put(x, shard), sources)
    if sources is None:
        return fn(states, statics, bg)
    return fn(states, statics, sources, bg)


def _default_observe(s, st, aux):
    return s.mean


@functools.lru_cache(maxsize=64)
def build_ensemble_fn(
    cfg: ModelConfig,
    run: RunConfig,
    mesh: Optional[Mesh] = None,
    observe: Optional[Callable] = None,
    axis: str = ENSEMBLE_AXIS,
    sequential: bool = False,
    with_source: bool = False,
    wind_fn: Optional[Callable] = None,
    t0: float = 0.0,
) -> Callable:
    """Build (and cache) the jitted ensemble runner
    ``f(states, statics[, sources], bg) -> (final, statics, history)``.

    Cached on (cfg, run, mesh, observe, axis, sequential, with_source,
    wind_fn, t0), so repeated calls — and :func:`ensemble_simulate` —
    reuse the compiled program.  ``observe`` AND ``wind_fn`` must be the
    SAME callable object across calls (top-level functions, not inline
    lambdas) to hit the cache — a fresh lambda per call is a cache miss
    and a full recompile; close sweep parameters over a single top-level
    def, or pass them through ``functools.partial`` of one shared
    function object reused across the sweep.  ``with_source=True`` adds a
    stacked per-member relaunch template argument, mapped member-wise
    into ``simulate(source=...)``.
    """
    obs = observe or _default_observe
    if with_source:
        member = lambda s, st, src, bg: simulate(
            s, st, bg, cfg, run, observe=obs, source=src,
            wind_fn=wind_fn, t0=t0)
        in_axes = (0, 0, 0, None)
    else:
        member = lambda s, st, bg: simulate(s, st, bg, cfg, run,
                                            observe=obs, wind_fn=wind_fn,
                                            t0=t0)
        in_axes = (0, 0, None)

    if sequential:
        if with_source:
            f = lambda ss, stst, srcs, bg: jax.lax.map(
                lambda x: member(*x, bg), (ss, stst, srcs)
            )
        else:
            f = lambda ss, stst, bg: jax.lax.map(
                lambda x: member(*x, bg), (ss, stst)
            )
        return jax.jit(f)

    f = jax.vmap(member, in_axes=in_axes)
    if mesh is None:
        return jax.jit(f)

    # shard_map over the member axis: each device runs a plain vmap over its
    # local members; no cross-member communication exists, so in/out specs
    # are all P(axis) and the background is replicated.  The output spec
    # depends on shapes, so the jitted shard_map is built lazily per input
    # shape (memoized; bounded LRU so parameter sweeps over many shapes
    # don't accumulate compiled programs) — and the eval_shape runs on plain
    # ShapeDtypeStructs so sharded avals never reach the vmap trace.
    compiled = OrderedDict()
    max_cached_shapes = 8

    def runner(*args):
        # args = (states, statics[, sources], bg): everything but the
        # trailing background shards P(axis)
        leaves = jax.tree.leaves(args)
        key = tuple((l.shape, str(l.dtype)) for l in leaves)
        if key in compiled:
            compiled.move_to_end(key)
        else:
            if len(compiled) >= max_cached_shapes:
                compiled.popitem(last=False)
            shapes = jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), args
            )
            out_shape = jax.eval_shape(f, *shapes)
            out_spec = jax.tree.map(lambda _: P(axis), out_shape)
            in_specs = tuple(
                jax.tree.map(lambda _: P(axis), a) for a in args[:-1]
            ) + (jax.tree.map(lambda _: P(), args[-1]),)
            compiled[key] = jax.jit(jax.shard_map(
                f, mesh=mesh,
                in_specs=in_specs, out_specs=out_spec,
            ))
        return compiled[key](*args)

    return runner
