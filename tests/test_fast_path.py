"""The f32 fast path against the f64 parity path, feature by feature.

The fast path is the scan path with the dense ``mxu`` backends and
Kahan-compensated deposit accumulation in float32 (the ``fast`` preset);
the parity path is the same scan with the ``xla`` (segment-sum) and
``gather`` (np.interp-exact) backends in float64.  Each case drives one
user-facing behaviour through both on identical inputs (the f32 inputs
upcast) and bounds the rel-to-max difference.

Tolerances: over a few steps the two paths differ by float32 rounding
(measured ~3e-7 rel-to-max on every field on the CPU), so the short-run
bound is 1e-5: thirty times that, and far below what a wrong deposit, a
wrong interpolation or a dropped lifecycle event would give.  Over a
long horizon the saturation clamps amplify rounding chaotically, so that
case bounds the fast path by three times the difference float32
arithmetic alone makes (the parity backends run in float32) — a fixed
bound would test chaos, not the code.  The deposit case holds the
north-star bar: 1e-6 against f64.

This is the CPU twin of ``chip_smoke.py``'s fast-versus-parity phase.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import msgwam_tpu as mt
from msgwam_tpu.models.backgrounds import tidal_shear
from msgwam_tpu.parallel import ensemble_simulate, stack_ensemble

N_RAY = 2000
N_STEPS = 6
TOL = 1e-5
M_MAX = np.pi / 1500.0  # low enough that critical-level culls fire early

FAST = mt.REFERENCE_RUN_CONFIG.replace(
    saturate_online=True, dtype="float32",
    projection_backend="mxu", interp_backend="mxu",
    flux_accum="compensated", prognostic_mean=False,
)


def parity(cfg):
    return cfg.replace(dtype="float64", projection_backend="xla",
                       interp_backend="gather", flux_accum="native")


def to64(tree):
    return jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float64)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def setup(cfg=FAST, n=N_RAY, amp=0.003, z_launch=2000.0, key=None):
    gc = mt.GridConfig()
    centers = gc.centers()
    uu = np.asarray(mt.velocities_sine_homogeneous(
        jnp.asarray(centers, jnp.float32), cfg)).astype(np.float32)
    vv = np.zeros_like(uu)
    bg = mt.make_background(gc, cfg, uu, vv, dtype=jnp.float32)
    rays, statics = mt.gaussian_spectrum_source(
        cfg, bg, n, z_launch=z_launch, dz_launch=500.0,
        amplitude_alpha=amp, key=key, dtype=jnp.float32)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.asarray(vv)))
    return bg, state, statics


def both(go, cfg, bg, state, statics):
    """``go(cfg, bg, state, statics, conv)`` on the fast path, then on the
    parity path with every input upcast (``conv`` converts any further
    inputs the same way)."""
    fast = go(cfg, bg, state, statics, lambda t: t)
    slow = go(parity(cfg), to64(bg), to64(state), to64(statics), to64)
    return fast, slow


def compare_state(fast, slow, fields=("dens", "r", "m"), tol=TOL, u0=None):
    out = [(f, getattr(fast.rays, f), getattr(slow.rays, f), tol)
           for f in fields]
    if u0 is not None:
        # the wind increment: the flux-driven part of the mean wind
        out.append(("du", np.asarray(fast.mean.u, np.float64) - u0,
                    np.asarray(slow.mean.u) - u0, tol))
    return out


def _run(n_steps=N_STEPS, save_every=None):
    return mt.RunConfig(dt=120.0, n_steps=n_steps,
                        save_every=save_every or n_steps)


def tidal(cfg, scale=1.0, period=43200.0, dtype=jnp.float32):
    cj = jnp.asarray(mt.GridConfig().centers(), dtype)
    return lambda t: (scale * tidal_shear(cj, t, cfg, period=period),
                      jnp.zeros_like(cj))


# --- cases: each returns [(label, fast, parity, tol), ...] -----------------

def case_cull_only():
    cfg = FAST.replace(cull=True, m_max=M_MAX)
    bg, state, statics = setup(cfg)
    (f, sf, _), (s, ss, _) = both(
        lambda c, b, st, stt, cv: mt.simulate(st, stt, b, c, _run()),
        cfg, bg, state, statics)
    assert np.asarray(sf.active).sum() < N_RAY, "culls must fire"
    np.testing.assert_array_equal(np.asarray(sf.active), np.asarray(ss.active))
    return compare_state(f, s)


def case_relaunch_tidal():
    cfg = FAST.replace(cull=True, relaunch=True, m_max=M_MAX)
    bg, state, statics = setup(cfg)
    src = (state.rays, statics)
    wf = tidal(cfg)
    (f, sf, hf), (s, ss, hs) = both(
        lambda c, b, st, stt, cv: mt.simulate(
            st, stt, b, c, _run(), source=cv(src),
            wind_fn=lambda t: cv(wf(t))),
        cfg, bg, state, statics)
    np.testing.assert_array_equal(np.asarray(sf.active), np.asarray(ss.active))
    np.testing.assert_array_equal(np.asarray(hf[1][-1]), np.asarray(hs[1][-1]))
    return compare_state(f, s) + [("dens_prop", hf[2][-1], hs[2][-1], TOL)]


def case_keyed_source():
    cfg = FAST.replace(cull=True, relaunch=True, m_max=M_MAX)
    bg, state, statics = setup(cfg)
    rays0, statics0 = state.rays, statics

    def src_fn(key):
        f = jax.random.uniform(key, (), jnp.float32, 0.5, 1.5)
        return rays0._replace(dens=rays0.dens * f), statics0

    def go(c, b, st, stt, cv, key=jax.random.PRNGKey(7)):
        return mt.simulate(st, stt, b, c, _run(save_every=1),
                           source=lambda k: cv(src_fn(k)), source_key=key)

    (f, sf, _), (s, ss, _) = both(go, cfg, bg, state, statics)
    assert np.asarray(sf.active).sum() == N_RAY, "relaunch refills slots"
    np.testing.assert_array_equal(np.asarray(sf.active), np.asarray(ss.active))
    # a different key gives a different trajectory: the draws are live
    other = go(cfg, bg, state, statics, lambda t: t, jax.random.PRNGKey(8))[0]
    assert rel(other.rays.dens, f.rays.dens) > 1e-3
    return compare_state(f, s)


def case_prescribed_wind_prognostic_mean():
    cfg = FAST.replace(cull=True, m_max=M_MAX, prognostic_mean=True)
    bg, state, statics = setup(cfg)
    # each path evaluates the imposed wind at its own precision
    winds = {"float32": tidal(cfg), "float64": tidal(cfg, dtype=jnp.float64)}
    (f, sf, _), (s, ss, _) = both(
        lambda c, b, st, stt, cv: mt.simulate(
            st, stt, b, c, _run(), wind_fn=winds[str(b.centers.dtype)]),
        cfg, bg, state, statics)
    np.testing.assert_array_equal(np.asarray(sf.active), np.asarray(ss.active))
    # one step's flux-driven increment on top of the imposed wind lies
    # below float32 resolution of the wind here: compare the wind itself
    return compare_state(f, s) + [("u", f.mean.u, s.mean.u, TOL)]


def case_scalar_wind_fn():
    bg, state, statics = setup()
    n_cell = state.mean.u.shape[0]
    scalar = lambda t: (0.5 + 0.0 * t, jnp.float32(0.0))
    column = lambda t: (jnp.full(n_cell, 0.5, jnp.float32) + 0.0 * t,
                        jnp.zeros(n_cell, jnp.float32))
    go = lambda wf: lambda c, b, st, stt, cv: mt.simulate(
        st, stt, b, c, _run(), wind_fn=lambda t: cv(wf(t)))
    (f, _, _), (s, _, _) = both(go(scalar), FAST, bg, state, statics)
    (fc, _, _) = go(column)(FAST, bg, state, statics, lambda t: t)
    # a scalar wind broadcasts to the whole column, bit for bit
    np.testing.assert_array_equal(np.asarray(f.rays.m), np.asarray(fc.rays.m))
    return compare_state(f, s) + [("u", f.mean.u, s.mean.u, TOL)]


def case_offline_saturation_dens_prop():
    out = []
    for faithful in (True, False):
        cfg = FAST.replace(saturate_online=False, prognostic_mean=True,
                           faithful_offline_rates=faithful)
        bg, state, statics = setup(cfg, amp=0.01)
        # amplify so the offline clamp fires within the short run
        state = state._replace(rays=state.rays._replace(
            dens=state.rays.dens * 50.0))
        (f, _, hf), (s, _, hs) = both(
            lambda c, b, st, stt, cv: mt.simulate(st, stt, b, c, _run()),
            cfg, bg, state, statics)
        if faithful:  # the reference's default: the clamp must fire
            assert not np.array_equal(np.asarray(hf[2][-1]),
                                      np.asarray(f.rays.dens)), "clamp fires"
        u0 = np.asarray(state.mean.u, np.float64)
        out += compare_state(f, s, u0=u0)
        out.append((f"dens_prop faithful={faithful}", hf[2][-1], hs[2][-1],
                    TOL))
    return out


def case_observe():
    bg, state, statics = setup(FAST.replace(prognostic_mean=True))
    cfg = FAST.replace(prognostic_mean=True)
    run = _run(save_every=2)
    obs = lambda s, st, aux: (s.mean.u, jnp.sum(aux.dens_prop * st.active),
                              jnp.max(s.rays.r * st.active))

    def go(c, b, st, stt, cv):
        return (mt.simulate(st, stt, b, c, run, observe=obs)[2],
                mt.simulate(st, stt, b, c, run)[2])

    (hf, full), (hs, _) = both(go, cfg, bg, state, statics)
    # the observation is the same reduction of the full default history
    h_state, h_act, h_prop = full
    np.testing.assert_array_equal(np.asarray(hf[0]), np.asarray(h_state.mean.u))
    np.testing.assert_allclose(
        np.asarray(hf[1]), np.asarray(jnp.sum(h_prop * h_act, axis=1)),
        rtol=1e-6)
    return [(f"observe[{i}]", a, b, TOL) for i, (a, b) in
            enumerate(zip(hf[1:], hs[1:]))]


def case_t0_continuity():
    cfg = FAST.replace(cull=True, relaunch=True, m_max=M_MAX)
    bg, state, statics = setup(cfg)
    src = (state.rays, statics)
    wf = tidal(cfg)

    def go(c, b, st, stt, cv):
        sim = jax.jit(lambda s_, t_, n, t0: mt.simulate(
            s_, t_, b, c, _run(n), source=cv(src),
            wind_fn=lambda t: cv(wf(t)), t0=t0), static_argnums=2)
        straight = sim(st, stt, N_STEPS, 0.0)[0]
        half = N_STEPS // 2
        a, sa, _ = sim(st, stt, half, 0.0)
        chunked = sim(a, sa, half, half * 120.0)[0]
        return straight, chunked

    (f, fc), (s, _) = both(go, cfg, bg, state, statics)
    # chunks continue the tidal phase: the split run IS the straight run
    for field in ("dens", "r", "m"):
        np.testing.assert_array_equal(np.asarray(getattr(f.rays, field)),
                                      np.asarray(getattr(fc.rays, field)))
    return compare_state(f, s)


def case_long_horizon():
    cfg = FAST.replace(prognostic_mean=True)
    bg, state, statics = setup(cfg, n=1000)
    run = _run(100)
    go = lambda c, b, st, stt, cv: mt.simulate(st, stt, b, c, run)[0]
    f, s = both(go, cfg, bg, state, statics)
    # what float32 arithmetic alone costs: the parity backends in float32
    f32 = go(parity(cfg).replace(dtype="float32"), bg, state, statics, None)
    u0 = np.asarray(state.mean.u, np.float64)
    du = lambda x: np.asarray(x.mean.u, np.float64) - u0
    out = []
    for name, get in (("dens", lambda x: x.rays.dens),
                      ("r", lambda x: x.rays.r), ("m", lambda x: x.rays.m),
                      ("du", du)):
        spread = rel(get(f32), get(s))
        out.append((name, get(f), get(s), 3.0 * max(spread, TOL)))
    return out


def case_capacity_padding():
    cfg = FAST.replace(prognostic_mean=True)
    bg, state, statics = setup(cfg, n=900)
    rays_p, statics_p = mt.pad_rays(state.rays, statics, 1024)
    padded = mt.State(rays_p, state.mean)
    go = lambda c, b, st, stt, cv: mt.simulate(st, stt, b, c, _run())[0]
    f, s = both(go, cfg, bg, padded, statics_p)
    plain = go(cfg, bg, state, statics, None)
    # inactive slots change nothing
    assert rel(f.mean.u, plain.mean.u) < 1e-6
    assert rel(f.rays.dens[:900], plain.rays.dens) < 1e-6
    return compare_state(f, s, u0=np.asarray(state.mean.u, np.float64))


def _members(cfg, n_members=2, n=1000):
    members = []
    for e in range(n_members):
        bg, state, statics = setup(cfg, n=n, amp=0.003 * (1 + 0.2 * e))
        members.append((state, statics))
    return bg, stack_ensemble(members)


def case_ensemble_lifecycle():
    cfg = FAST.replace(cull=True, relaunch=True, m_max=M_MAX)
    bg, (bstates, bstatics) = _members(cfg)
    src = (bstates.rays, bstatics)
    (f, sf, _), (s, ss, _) = both(
        lambda c, b, st, stt, cv: ensemble_simulate(
            st, stt, b, c, _run(), sources=cv(src)),
        cfg, bg, bstates, bstatics)
    assert np.asarray(sf.active).sum() == bstatics.active.size
    np.testing.assert_array_equal(np.asarray(sf.active), np.asarray(ss.active))
    return compare_state(f, s)


def case_ensemble_shared_wind():
    cfg = FAST.replace(cull=True, relaunch=True, m_max=M_MAX)
    bg, (bstates, bstatics) = _members(cfg)
    src = (bstates.rays, bstatics)
    wf = tidal(cfg)
    (f, sf, _), (s, ss, _) = both(
        lambda c, b, st, stt, cv: ensemble_simulate(
            st, stt, b, c, _run(), sources=cv(src), wind_fn=wf),
        cfg, bg, bstates, bstatics)
    np.testing.assert_array_equal(np.asarray(sf.active), np.asarray(ss.active))
    return compare_state(f, s)


def case_ensemble_per_member_winds():
    cfg = FAST
    bg, (bstates, bstatics) = _members(cfg)
    scales = jnp.asarray([1.0, 1.5], jnp.float32)

    def go(c, b, st, stt, cv):
        def member(s_, t_, scale):
            wf = tidal(cfg, 1.0, 43200.0)
            return mt.simulate(
                s_, t_, b, c, _run(),
                wind_fn=lambda t: cv((scale * wf(t)[0], wf(t)[1])))[0]
        return jax.jit(jax.vmap(member))(st, stt, cv(scales))

    f, s = both(go, cfg, bg, bstates, bstatics)
    # the member winds really differ (a broadcast bug would hide here)
    assert rel(f.mean.u[0], f.mean.u[1]) > 1e-3
    return compare_state(f, s) + [("u", f.mean.u, s.mean.u, TOL)]


def case_ensemble_gradient():
    cfg = FAST.replace(prognostic_mean=True)
    bg, (bstates, bstatics) = _members(cfg, n=300)
    run = _run(3)

    def go(c, b, st, stt, cv):
        def loss(scale):
            s_ = st._replace(rays=st.rays._replace(dens=st.rays.dens * scale))
            fin = ensemble_simulate(s_, stt, b, c, run)[0]
            return jnp.sum((fin.mean.u - st.mean.u) ** 2)
        return jax.grad(loss)(cv(jnp.float32(1.0)))

    g32, g64 = both(go, cfg, bg, bstates, bstatics)
    assert np.isfinite(float(g32)) and float(g32) != 0.0
    return [("grad", g32, g64, 1e-3)]


def case_deposit_accuracy_at_capacity():
    """One prognostic step at 131,072 rays (16 compensated blocks): with
    phi0 = 0 the wind increment is a pure flux observable (Coriolis and
    pressure-gradient terms vanish, lib/libprop.py:523-539)."""
    cfg = FAST.replace(prognostic_mean=True)
    n = 131072
    bg, state, statics = setup(cfg, n=n)
    go = lambda c, b, st, stt, cv: mt.simulate(st, stt, b, c, _run(1))[0]
    f, s = both(go, cfg, bg, state, statics)
    u0 = np.asarray(state.mean.u, np.float64)
    return [("du", np.asarray(f.mean.u, np.float64) - u0,
             np.asarray(s.mean.u) - u0, 1e-6)]


def case_hprop():
    cfg = FAST.replace(hprop=True, prognostic_mean=True,
                       phi0=float(np.deg2rad(-30.0)))
    bg, state, statics = setup(cfg)
    (f, _, _), (s, _, _) = both(
        lambda c, b, st, stt, cv: mt.simulate(st, stt, b, c, _run()),
        cfg, bg, state, statics)
    return compare_state(f, s, fields=("dens", "r", "m", "k", "l", "phi",
                                       "lam"))


def _integrator(name):
    def case():
        cfg = FAST.replace(integrator=name, prognostic_mean=True)
        bg, state, statics = setup(cfg)
        (f, _, _), (s, _, _) = both(
            lambda c, b, st, stt, cv: mt.simulate(st, stt, b, c, _run()),
            cfg, bg, state, statics)
        return compare_state(f, s, u0=np.asarray(state.mean.u, np.float64))
    return case


def case_relaunch_every():
    cfg = FAST.replace(cull=True, relaunch=True, m_max=M_MAX)
    bg, state, statics = setup(cfg)
    src = (state.rays, statics)
    (f, sf, _), (s, ss, _) = both(
        lambda c, b, st, stt, cv: mt.simulate(
            st, stt, b, c, _run(), source=cv(src), relaunch_every=4),
        cfg, bg, state, statics)
    # relaunch ran at step 0 and 4 only: slots culled after step 4 stay off
    np.testing.assert_array_equal(np.asarray(sf.active), np.asarray(ss.active))
    return compare_state(f, s)


def case_include_t0():
    bg, state, statics = setup()
    (_, _, hf), (_, _, hs) = both(
        lambda c, b, st, stt, cv: mt.simulate(
            st, stt, b, c, _run(save_every=2), include_t0=True),
        FAST, bg, state, statics)
    assert hf[0].rays.r.shape[0] == N_STEPS // 2 + 1
    np.testing.assert_array_equal(np.asarray(hf[0].rays.r[0]),
                                  np.asarray(state.rays.r))
    return [("r history", hf[0].rays.r, hs[0].rays.r, TOL),
            ("dens_prop history", hf[2], hs[2], TOL)]


def case_remat_gradient():
    cfg = FAST.replace(prognostic_mean=True)
    bg, state, statics = setup(cfg, n=500)
    run = _run(4, save_every=2)

    def go(c, b, st, stt, cv):
        def loss(dens0):
            s_ = st._replace(rays=st.rays._replace(dens=dens0))
            fin = mt.simulate(s_, stt, b, c, run, remat="full",
                              validate=False)[0]
            return jnp.sum((fin.mean.u - st.mean.u) ** 2)
        return jax.grad(loss)(st.rays.dens)

    g32, g64 = both(go, cfg, bg, state, statics)
    assert np.all(np.isfinite(np.asarray(g32)))
    return [("grad", g32, g64, 1e-3)]


CASES = {
    "cull_only": case_cull_only,
    "relaunch_tidal": case_relaunch_tidal,
    "keyed_source": case_keyed_source,
    "prescribed_wind_prognostic_mean": case_prescribed_wind_prognostic_mean,
    "scalar_wind_fn": case_scalar_wind_fn,
    "offline_saturation_dens_prop": case_offline_saturation_dens_prop,
    "observe": case_observe,
    "t0_continuity": case_t0_continuity,
    "long_horizon": case_long_horizon,
    "capacity_padding": case_capacity_padding,
    "ensemble_lifecycle": case_ensemble_lifecycle,
    "ensemble_shared_wind": case_ensemble_shared_wind,
    "ensemble_per_member_winds": case_ensemble_per_member_winds,
    "ensemble_gradient": case_ensemble_gradient,
    "deposit_accuracy_at_capacity": case_deposit_accuracy_at_capacity,
    "hprop": case_hprop,
    "rk4": _integrator("rk4"),
    "euler": _integrator("euler"),
    "relaunch_every": case_relaunch_every,
    "include_t0": case_include_t0,
    "remat_gradient": case_remat_gradient,
}


@pytest.mark.parametrize("feature", list(CASES))
def test_fast_path_matches_parity_path(feature):
    for label, fast, slow, tol in CASES[feature]():
        err = rel(fast, slow)
        assert np.isfinite(err) and err < tol, (feature, label, err, tol)
