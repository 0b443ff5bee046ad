"""Time integration: Williamson low-storage RK3 + the step/scan driver.

The RK3 stage arithmetic mirrors ``lib/libprop.py:680-700`` exactly (the
reference's object-dtype elementwise updates become pytree maps), including
the reference behavior of passing the *full* dt to every stage's RHS
(``lib/libprop.py:693-697`` — only online saturation consumes it; SURVEY.md
quirk 6).

The per-step driver logic of ``raytracer.py:157-191`` — pack, RK3, unpack,
*offline* saturation with finite-difference rates — becomes :func:`step`,
and the whole time loop becomes one ``jax.lax.scan`` (:func:`simulate`) with
configurable history decimation, fully on-device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import ModelConfig, RunConfig
from ..state import Background, RayStatics, State, tree_axpy
from ..ops.projection import required_span
from ..ops.saturation import saturate_direct
from .rhs import rhs as rhs_default
from . import sources as _sources


def _is_concrete(x) -> bool:
    return not isinstance(x, jax.core.Tracer)


def validate_inputs(state: State, statics: RayStatics, bg: Background,
                    cfg: ModelConfig) -> None:
    """Host-side sanity checks run once per ``simulate`` trace.

    * **dtype discipline**: the state/background float dtype must match
      ``cfg.dtype`` — an f32 state under a ``dtype="float64"`` config (or
      vice versa) previously ran silently with mixed semantics.
    * **projection span**: ``d(dr)/dt`` is structurally zero in this model
      (``cg_r`` is height-independent), so the widest ray volume is known at
      run start; the xla (segment-sum) backend silently truncates any ray
      overlapping more than ``cfg.max_span`` cells, which loses flux deposit
      (ADVICE round 1).  Raises when the configured source needs more span.
      Only checked when values are concrete (skipped for traced args).
    """
    import numpy as np

    # Accuracy guard (north-star bar: flux deposit error < 1e-6): plain f32
    # accumulation through the dense mxu projection exceeds the bar at
    # ~1e5 rays and above; the compensated and f64 modes stay at ~1e-7.
    # Warn rather than fail: the looser mode remains a deliberate choice.
    if (cfg.dtype == "float32" and cfg.projection_backend == "mxu"
            and cfg.flux_accum == "native"
            and state.rays.dens.shape[0] >= 65536):
        import warnings

        warnings.warn(
            f"flux_accum='native' at {state.rays.dens.shape[0]} f32 rays "
            f"exceeds the 1e-6 deposit-error target; use "
            f"flux_accum='compensated' for accurate fast runs",
            stacklevel=2,
        )

    want = np.dtype(cfg.dtype)
    for name, arr in (("state.rays.dens", state.rays.dens),
                      ("state.mean.u", state.mean.u),
                      ("background.rhobar", bg.rhobar)):
        got = jnp.asarray(arr).dtype
        if got != want:
            raise TypeError(
                f"{name} has dtype {got} but cfg.dtype={cfg.dtype!r}; "
                f"build the state/background with the configured dtype or "
                f"set cfg.replace(dtype={str(got)!r})"
            )

    if cfg.projection_backend == "xla" and _is_concrete(state.rays.dr) \
            and _is_concrete(bg.faces) and _is_concrete(statics.active):
        act = np.asarray(statics.active)
        if act.any():
            dz = float(bg.faces[1] - bg.faces[0])
            dr_max = float(np.max(np.asarray(state.rays.dr)[act]))
            need = required_span(dr_max, dz)
            if need > cfg.max_span:
                raise ValueError(
                    f"cfg.max_span={cfg.max_span} but the widest active ray "
                    f"volume (dr={dr_max:g} m, dz={dz:g} m) spans {need} "
                    f"cells; the xla projection backend would silently drop "
                    f"part of its flux deposit.  Raise cfg.max_span to "
                    f">= {need} (or use the dense 'mxu' backend, which has "
                    f"no span bound)."
                )


def williamson_rk3(f: Callable, y, dt):
    """Generic 3-stage Williamson low-storage RK3 over any pytree ``y``
    (coefficients per ``lib/libprop.py:693-698``):

        q = dt f(y);             y += q/3
        q = dt f(y) − 5/9 q;     y += 15/16 q
        q = dt f(y) − 153/128 q; y += 8/15 q
    """
    q = jax.tree.map(lambda t: dt * t, f(y))
    # stage 1 adds qq/3 via *division* exactly like lib/libprop.py:694
    y = jax.tree.map(lambda qq, v: v + qq / 3.0, q, y)
    q = jax.tree.map(lambda t, qq: dt * t - 5.0 / 9.0 * qq, f(y), q)
    y = tree_axpy(15.0 / 16.0, q, y)
    q = jax.tree.map(lambda t, qq: dt * t - 153.0 / 128.0 * qq, f(y), q)
    y = tree_axpy(8.0 / 15.0, q, y)
    return y


def forward_euler(f: Callable, y, dt):
    """First-order forward Euler over any pytree (build-side alternative
    integrator; the reference only has RK3)."""
    return jax.tree.map(lambda t, v: v + dt * t, f(y), y)


def rk4(f: Callable, y, dt):
    """Classic 4th-order Runge-Kutta over any pytree (build-side
    alternative; more accurate, 4 RHS evaluations per step)."""
    k1 = f(y)
    k2 = f(jax.tree.map(lambda t, v: v + 0.5 * dt * t, k1, y))
    k3 = f(jax.tree.map(lambda t, v: v + 0.5 * dt * t, k2, y))
    k4 = f(jax.tree.map(lambda t, v: v + dt * t, k3, y))
    return jax.tree.map(
        lambda a, b, c, d, v: v + dt / 6.0 * (a + 2.0 * b + 2.0 * c + d),
        k1, k2, k3, k4, y,
    )


INTEGRATORS = {
    "rk3": williamson_rk3,
    "rk4": rk4,
    "euler": forward_euler,
}


def rk3_step(
    dt,
    state: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    axis_name: Optional[str] = None,
    rhs: Callable = rhs_default,
) -> State:
    """One integrator step of the coupled system (``cfg.integrator``
    selects rk3/rk4/euler; default is the reference's Williamson RK3).
    Like the reference, the full ``dt`` is passed to every stage's RHS
    (``lib/libprop.py:693-697`` — only online saturation consumes it;
    SURVEY.md quirk 6)."""
    integ = INTEGRATORS[cfg.integrator]
    return integ(lambda s: rhs(dt, s, statics, bg, cfg, axis_name), state, dt)


class StepAux(NamedTuple):
    """Per-step side-channel: the *propagated* (pre-offline-saturation)
    density, mirroring ``int_dens_prop`` (``raytracer.py:126,178``)."""

    dens_prop: jax.Array


def step(
    dt,
    state: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    axis_name: Optional[str] = None,
    rhs: Callable = rhs_default,
):
    """One full model step: RK3, then (when ``saturate_online`` is off) the
    driver-side *offline* direct saturation of ``raytracer.py:182-188``,
    then optional culling/relaunch (build-side; mask ops only).

    Returns ``(new_state, new_statics, aux)``.
    """
    prev = state
    state = rk3_step(dt, state, statics, bg, cfg, axis_name, rhs)
    aux = StepAux(dens_prop=state.rays.dens)

    if not cfg.saturate_online:
        rays, prev_rays = state.rays, prev.rays
        # FD rates across the step (raytracer.py:184-187).  Reference quirk
        # 2: the height rate is divided by 1, not dt (raytracer.py:184).
        r_div = 1.0 if cfg.faithful_offline_rates else dt
        dens = saturate_direct(
            dt,
            rays.dens,
            prev_rays.r,
            (rays.r - prev_rays.r) / r_div,
            prev_rays.dr,
            (rays.dr - prev_rays.dr) / dt,
            rays.k,
            rays.l,
            prev_rays.m,
            (rays.m - prev_rays.m) / dt,
            statics.dkk,
            statics.dll,
            statics.rr_mm_area,
            bg.centers,
            bg.rhobar,
            cfg.bvf,
            cfg.kappa,
            cfg.phi0,
            faithful=cfg.faithful_saturation,
            active=statics.active,
            interp_backend=cfg.interp_backend,
        )
        state = state._replace(rays=rays._replace(dens=dens))

    if cfg.cull:
        state, statics = _sources.cull(state, statics, bg, cfg)

    return state, statics, aux


def simulate(
    state: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    run: RunConfig,
    observe: Optional[Callable] = None,
    source=None,
    relaunch_every: int = 1,
    axis_name: Optional[str] = None,
    rhs: Callable = rhs_default,
    wind_fn: Optional[Callable] = None,
    t0: float = 0.0,
    include_t0: bool = False,
    source_key: Optional[jax.Array] = None,
    validate: bool = True,
    remat=False,
):
    """Run ``run.n_steps`` steps as one ``lax.scan``, recording an
    observation every ``run.save_every`` steps.

    ``observe(state, statics, aux) -> pytree`` selects what is stacked into
    the history (default: the full state + activity mask + dens_prop —
    equivalent to the reference's full in-RAM history,
    ``raytracer.py:124-150``; pass a slimmer observable for big runs).

    ``source`` enables relaunch of culled slots every ``relaunch_every``
    steps.  It is either a fixed ``(RayState, RayStatics)`` template from
    :mod:`msgwam_tpu.models.sources`, or a callable ``source(key) ->
    (RayState, RayStatics)`` drawing a *fresh stochastic template per
    relaunch* (pass ``source_key``; time-varying launch spectra, BASELINE
    config 4).

    ``include_t0`` prepends the initial state as history frame 0, exactly
    like the reference's history buffers (``raytracer.py:139-150`` stores
    the initial condition before the loop); every history leaf then has
    leading axis ``n_steps // save_every + 1``.

    ``remat=True`` wraps each ``save_every``-step block in
    ``jax.checkpoint``: ``jax.grad`` through the run then stores only the
    per-block carries (``n_steps/save_every`` state snapshots) and replays
    each block's forward during the backward sweep.  Without it the scan
    saves the full per-step residuals — at 1e6 rays that is ~50 MB/step,
    an OOM a few hundred steps in.  Choose ``save_every ~ sqrt(n_steps)``
    for the classic sqrt-memory schedule; forward-only runs pay nothing.

    ``remat="full"`` additionally checkpoints every *step* inside the
    block: the replayed block then stores only per-step state snapshots
    (~60 MB each at 1e6 rays) instead of each step's full RHS residuals,
    which hold several ``(n, n_cell)`` matrices per RK3 stage.  Peak
    adjoint memory becomes ``(n_steps/save_every + save_every)`` state
    snapshots plus one step's residuals, at the cost of one more forward
    replay per step in the backward sweep.  Required for 1e6-ray adjoints.

    ``wind_fn(t) -> (u, v)`` prescribes a transient imposed background
    (e.g. :func:`msgwam_tpu.models.backgrounds.tidal_shear`): the mean wind
    is overwritten at each step's start time; combine with
    ``cfg.prognostic_mean=False`` so the wind tendencies vanish and XLA
    drops the unused flux work (BASELINE configs 1 and 4).

    Returns ``(final_state, final_statics, history)`` where every history
    leaf has leading axis ``n_steps // save_every``.
    """
    if observe is None:
        observe = lambda s, st, aux: (s, st.active, aux.dens_prop)
    if run.n_steps % run.save_every != 0:
        raise ValueError("n_steps must be divisible by save_every")
    if validate:
        validate_inputs(state, statics, bg, cfg)
    n_outer = run.n_steps // run.save_every

    keyed_source = callable(source)
    if keyed_source and source_key is None:
        raise ValueError("a callable source requires source_key")
    if source_key is None:
        source_key = jnp.zeros((2,), dtype=jnp.uint32)  # unused placeholder

    def inner(carry, i):
        st, stat, key = carry
        if wind_fn is not None:
            t = t0 + i.astype(bg.centers.dtype) * run.dt
            u, v = wind_fn(t)
            st = st._replace(
                mean=st.mean._replace(
                    u=jnp.broadcast_to(u, st.mean.u.shape).astype(st.mean.u.dtype),
                    v=jnp.broadcast_to(v, st.mean.v.shape).astype(st.mean.v.dtype),
                )
            )
        st, stat, aux = step(run.dt, st, stat, bg, cfg, axis_name, rhs)
        if cfg.relaunch and source is not None:
            if keyed_source:
                key, sub = jax.random.split(key)
                template = source(sub)
            else:
                template = source

            if relaunch_every > 1:
                st, stat = jax.lax.cond(
                    (i % relaunch_every) == 0,
                    lambda: _sources.relaunch(st, stat, template),
                    lambda: (st, stat),
                )
            else:
                st, stat = _sources.relaunch(st, stat, template)
        return (st, stat, key), aux

    if remat == "full":
        inner = jax.checkpoint(inner)

    def run_block(carry, block):
        # only the last step's aux leaves the block: the per-step stack
        # would otherwise be materialized (and, under remat, saved) even
        # though observe() sees one frame per outer step
        carry, aux = jax.lax.scan(inner, carry, block)
        aux_last = jax.tree.map(lambda x: x[-1], aux)
        return carry, aux_last

    if remat:
        run_block = jax.checkpoint(run_block)

    def outer(carry, block):
        carry, aux_last = run_block(carry, block)
        st, stat, _ = carry
        return carry, observe(st, stat, aux_last)

    obs0 = None
    if include_t0:
        # history frame 0 = the initial condition (raytracer.py:139-150);
        # dens_prop at t=0 is the initial density itself (raytracer.py:126)
        obs0 = observe(state, statics, StepAux(dens_prop=state.rays.dens))

    steps = jnp.arange(run.n_steps).reshape(n_outer, run.save_every)
    (state, statics, _), history = jax.lax.scan(
        outer, (state, statics, source_key), steps
    )
    if include_t0:
        history = jax.tree.map(
            lambda h0, h: jnp.concatenate([h0[None].astype(h.dtype), h]),
            obs0, history,
        )
    return state, statics, history
