"""Multi-chip correctness on an 8-device virtual CPU mesh (SURVEY.md §4
item 4): sharded == single-device, ensemble fan-out, psum placement."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import msgwam_tpu as mt
from msgwam_tpu.parallel import (
    ensemble_simulate,
    make_mesh,
    shard_state,
    sharded_simulate,
    sharded_step_fn,
    stack_ensemble,
)


# the device count is read inside the fixture (conftest.py), never at import
pytestmark = pytest.mark.usefixtures("eight_devices")


def _setup(capacity=64):
    cfg = mt.REFERENCE_RUN_CONFIG
    gc = mt.GridConfig()
    centers = gc.centers()
    uu = np.asarray(mt.velocities_sine_homogeneous(jnp.asarray(centers), cfg))
    vv = np.zeros_like(uu)
    bg = mt.make_background(gc, cfg, uu, vv)
    rays, statics = mt.wave_packet_ic(gc, cfg, bg, n_ray=60)
    rays, statics = mt.pad_rays(rays, statics, capacity)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.asarray(vv)))
    return cfg, bg, state, statics


def test_sharded_equals_single_device():
    cfg, bg, state, statics = _setup()
    run = mt.RunConfig(dt=120.0, n_steps=30, save_every=30)
    sf, stf, _ = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfg, run))(state, statics)
    mesh = make_mesh(8)
    sf8, stf8, hist8 = sharded_simulate(mesh, state, statics, bg, cfg, run)
    np.testing.assert_allclose(
        np.asarray(sf8.mean.u), np.asarray(sf.mean.u), rtol=1e-12, atol=1e-15
    )
    np.testing.assert_allclose(
        np.asarray(sf8.rays.dens), np.asarray(sf.rays.dens), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(sf8.rays.m), np.asarray(sf.rays.m), rtol=1e-12
    )
    # history is the replicated mean profile
    assert np.asarray(hist8.u).shape == (1, 100)


def test_sharded_step_fn_and_placement():
    cfg, bg, state, statics = _setup()
    mesh = make_mesh(8)
    state8, statics8 = shard_state(mesh, state, statics)
    assert not state8.rays.dens.sharding.is_fully_replicated
    assert state8.mean.u.sharding.is_fully_replicated
    f = sharded_step_fn(mesh, bg, cfg, 120.0)
    s1, st1 = f(state8, statics8)
    s1b, st1b, _ = mt.step(120.0, state, statics, bg, cfg)
    np.testing.assert_allclose(
        np.asarray(s1.mean.u), np.asarray(s1b.mean.u), rtol=1e-12, atol=1e-15
    )


def test_mesh_size_2_and_4():
    cfg, bg, state, statics = _setup()
    run = mt.RunConfig(dt=120.0, n_steps=10, save_every=10)
    ref, _, _ = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfg, run))(state, statics)
    for n in (2, 4):
        mesh = make_mesh(n)
        sf, _, _ = sharded_simulate(mesh, state, statics, bg, cfg, run)
        np.testing.assert_allclose(
            np.asarray(sf.mean.u), np.asarray(ref.mean.u), rtol=1e-12,
            atol=1e-15, err_msg=f"mesh size {n}",
        )


def test_ensemble_matches_members():
    cfg, bg, state, statics = _setup()
    gc = mt.GridConfig()
    members = []
    for i in range(4):
        rays_i, st_i = mt.wave_packet_ic(gc, cfg, bg, n_ray=60,
                                         alpha=0.01 * (1 + 0.2 * i))
        members.append((rays_i, st_i))
    brays, bstat = stack_ensemble(members)
    uu = np.asarray(state.mean.u)
    bstate = mt.State(
        brays,
        mt.MeanState(
            jnp.broadcast_to(jnp.asarray(uu), (4,) + uu.shape),
            jnp.zeros((4,) + uu.shape),
        ),
    )
    run = mt.RunConfig(dt=120.0, n_steps=10, save_every=10)
    mesh = jax.make_mesh((4,), ("ensemble",), devices=jax.devices()[:4])
    es, est, eh = ensemble_simulate(bstate, bstat, bg, cfg, run, mesh=mesh)
    # member 2 standalone
    s2 = mt.State(members[2][0], mt.MeanState(jnp.asarray(uu), jnp.zeros_like(jnp.asarray(uu))))
    sf2, _, _ = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfg, run))(s2, members[2][1])
    np.testing.assert_allclose(
        np.asarray(jax.device_get(es.mean.u))[2], np.asarray(sf2.mean.u),
        rtol=1e-12, atol=1e-15,
    )


def test_ensemble_sequential_matches_vmap():
    cfg, bg, state, statics = _setup()
    gc = mt.GridConfig()
    members = [mt.wave_packet_ic(gc, cfg, bg, n_ray=60, alpha=0.01 * (1 + i))
               for i in range(3)]
    brays, bstat = stack_ensemble(members)
    uu = np.asarray(state.mean.u)
    bstate = mt.State(
        brays,
        mt.MeanState(
            jnp.broadcast_to(jnp.asarray(uu), (3,) + uu.shape),
            jnp.zeros((3,) + uu.shape),
        ),
    )
    run = mt.RunConfig(dt=120.0, n_steps=10, save_every=10)
    a = ensemble_simulate(bstate, bstat, bg, cfg, run)
    b = ensemble_simulate(bstate, bstat, bg, cfg, run, sequential=True)
    np.testing.assert_allclose(
        np.asarray(a[0].mean.u), np.asarray(b[0].mean.u), rtol=1e-12, atol=1e-15
    )
    np.testing.assert_allclose(
        np.asarray(a[0].rays.dens), np.asarray(b[0].rays.dens), rtol=1e-12
    )


def test_sharded_with_cull_and_relaunch():
    """Sharded run with culling + relaunch source matches single-device.
    m_max is set so critical-level culls genuinely fire within the run
    (2*pi/2000 never triggered: |m| starts at 2*pi/5000 and does not grow
    2.5x in 40 steps under this jet)."""
    cfg = mt.REFERENCE_RUN_CONFIG.replace(
        cull=True, relaunch=True, m_max=2 * np.pi / 3500.0,
    )
    gc = mt.GridConfig()
    centers = gc.centers()
    uu = 40.0 * np.tanh((centers - 30e3) / 1e4)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu))
    source = mt.gaussian_spectrum_source(cfg, bg, 64)
    rays, statics = source
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.zeros(100)))
    run = mt.RunConfig(dt=120.0, n_steps=40, save_every=40)
    ref, refst, _ = jax.jit(
        lambda s, st: mt.simulate(s, st, bg, cfg, run, source=source)
    )(state, statics)
    # culls must actually fire for this test to exercise the lifecycle
    _, st_cull, _ = jax.jit(
        lambda s, st: mt.simulate(s, st, bg,
                                  cfg.replace(relaunch=False), run)
    )(state, statics)
    assert (~np.asarray(st_cull.active)).any()
    mesh = make_mesh(8)
    sf, stf, _ = sharded_simulate(mesh, state, statics, bg, cfg, run,
                                  source=source)
    np.testing.assert_allclose(
        np.asarray(sf.mean.u), np.asarray(ref.mean.u), rtol=1e-12, atol=1e-15
    )
    np.testing.assert_array_equal(np.asarray(stf.active), np.asarray(refst.active))


def test_ensemble_scan_backend_sources_relaunch():
    """Stacked per-member relaunch templates: every member must match its
    own simulate(source=...) run, batched and sharded."""
    cfg = mt.REFERENCE_RUN_CONFIG.replace(
        cull=True, relaunch=True, m_max=2 * np.pi / 3500.0,
    )
    gc = mt.GridConfig()
    centers = gc.centers()
    uu = 40.0 * np.tanh((centers - 30e3) / 1e4)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu))
    E = 2
    members, sources = [], []
    for e in range(E):
        src = mt.gaussian_spectrum_source(cfg, bg, 64,
                                          amplitude_alpha=0.01 * (1 + e))
        rays, statics = src
        members.append((mt.State(rays, mt.MeanState(jnp.asarray(uu),
                                                    jnp.zeros(100))),
                        statics))
        sources.append(src)
    bstates, bstatics = stack_ensemble(members)
    bsources = (jax.tree.map(lambda *xs: jnp.stack(xs),
                             *[s[0] for s in sources]),
                jax.tree.map(lambda *xs: jnp.stack(xs),
                             *[s[1] for s in sources]))
    run = mt.RunConfig(dt=120.0, n_steps=40, save_every=40)
    mesh = jax.make_mesh((2,), ("ensemble",), devices=jax.devices()[:2])

    # culls must actually fire (else the lifecycle path is dead code here)
    _, st_cull, _ = jax.jit(
        lambda s, st: mt.simulate(s, st, bg,
                                  cfg.replace(relaunch=False), run)
    )(*members[0])
    assert (~np.asarray(st_cull.active)).any()

    for m in (None, mesh):
        fin, stf, _ = ensemble_simulate(bstates, bstatics, bg, cfg, run,
                                        mesh=m, sources=bsources)
        fin = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), fin)
        stf = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), stf)
        for e in range(E):
            s1, st1 = members[e]
            r1, rst1, _ = jax.jit(
                lambda s, st: mt.simulate(s, st, bg, cfg, run,
                                          source=sources[e]))(s1, st1)
            np.testing.assert_allclose(
                fin.mean.u[e], np.asarray(r1.mean.u), rtol=1e-12, atol=1e-15)
            np.testing.assert_array_equal(
                stf.active[e], np.asarray(rst1.active))
