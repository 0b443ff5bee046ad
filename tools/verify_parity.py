"""Verify drive: full default-run parity vs reference + probes, all through
the public msgwam_tpu API."""
import os, sys, time
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_disable_hlo_passes=while_loop_unroller"
).strip()
import numpy as np
import jax
# the parity oracle is NumPy on the host: compare on the CPU backend
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, "/root/reference")
import lib.libprop as lprop
import msgwam_tpu as mt

# ---------- reference full default run (raytracer.py semantics) ----------
NN, nray, ngrid, grid_max, phi0, alpha, dt = 0.01, 60, 101, 100e3, 0.0, 0.01, 120.0
nt_max = int(86400 / dt * 2)
lprop.HPROP_GLOBAL = False
lprop.set_model_setup(bvf=NN, rhs=lprop.rhs_default, boussinesq=False, sig_rr=10000,
                      u0=4, rr0=40000, rr1=40000, phi0=phi0, kappa=1.0, saturate_online=False)
grid = np.linspace(0, grid_max, ngrid); grids = .5*(grid[:-1]+grid[1:])
lprop.grid, lprop.grids = grid, grids
k_abs = 2*np.pi/50e3
init_kk = np.ones(nray)*k_abs; init_ll = np.zeros(nray)
init_mm = np.ones(nray)*-2*np.pi/5e3
init_rr_grid = np.linspace(0, 15000, nray+1)
init_rr = .5*(init_rr_grid[:-1]+init_rr_grid[1:])
init_drr = np.ones(nray)*np.diff(init_rr)[0]
rr_mm_area = 5e-5*init_drr; init_dmm = rr_mm_area/init_drr
init_uu = lprop.velocities_sine_homogeneous(grids); init_vv = np.zeros(init_uu.shape)
lprop.set_hydrostatics(); lprop.set_pressure_gradient(init_uu, init_vv)
init_dkk = np.ones(nray)*1e-4; init_dll = np.ones(nray)*1e-4
lprop.set_statics(dll=init_dll, dkk=init_dkk, rr_mm_area=rr_mm_area)
f0 = 0.0
rhobar_ray = np.interp(init_rr, grids, lprop.rhobar)
omh = lprop.omega(init_kk, init_ll, init_mm, phi0)
init_dens = (alpha**2*rhobar_ray/2*omh/init_mm**2/(omh**2-f0**2)*NN**2
             * np.exp(-(init_rr-init_rr.mean())**2/2/2000**2)) / init_dkk/init_dll/init_dmm

t0 = time.time()
cur = [init_dens.copy(), np.zeros(nray), np.ones(nray)*phi0, init_rr.copy(), init_drr.copy(),
       init_kk.copy(), init_ll.copy(), init_mm.copy(), init_dmm.copy(), init_uu.copy(), init_vv.copy()]
for nt in range(nt_max):
    out = lprop.RK3(dt, np.array(cur, dtype=object))
    dens_prop = out[0]
    dens_sat = lprop.saturation(dt, dens_prop, cur[3], (out[3]-cur[3])/1, cur[4], (out[4]-cur[4])/dt,
                                out[5], out[6], cur[7], (out[7]-cur[7])/dt, direct=True)
    cur = list(out); cur[0] = dens_sat
ref_time = time.time()-t0
print(f"reference full run: {ref_time:.1f} s")

# ---------- our framework, same run through public API ----------
cfg = mt.REFERENCE_RUN_CONFIG
gc = mt.GridConfig(n_face=ngrid, z_max=grid_max)
bg = mt.make_background(gc, cfg, init_uu, init_vv)
rays, statics = mt.wave_packet_ic(gc, cfg, bg, n_ray=nray)
state = mt.State(rays, mt.MeanState(jnp.asarray(init_uu), jnp.asarray(init_vv)))
run = mt.RunConfig(dt=dt, n_steps=nt_max, save_every=nt_max)
t0 = time.time()
sf, stf, _ = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfg, run))(state, statics)
jax.block_until_ready(sf)
our_time = time.time()-t0
print(f"msgwam_tpu full run (cpu, x64, incl compile): {our_time:.1f} s")

for name, mine, theirs in [("dens", sf.rays.dens, cur[0]), ("r", sf.rays.r, cur[3]),
                           ("m", sf.rays.m, cur[7]), ("u", sf.mean.u, cur[9]), ("v", sf.mean.v, cur[10])]:
    theirs = np.asarray(theirs)
    scale = np.max(np.abs(theirs))
    if scale > 0:
        # error relative to the field's max (a raw per-element relative
        # error is meaningless for near-zero entries, e.g. v ~ 0 everywhere)
        err = np.max(np.abs(np.asarray(mine)-theirs)) / scale
        print(f"  {name:4s} max err (rel to max) after {nt_max} steps: {err:.3e}")
    else:
        err = np.max(np.abs(np.asarray(mine)-theirs))
        print(f"  {name:4s} max abs err (field is zero) after {nt_max} steps: {err:.3e}")

# flux-profile comparison (the metric of record)
flux_ref = lprop.wave_projection(cur[0], np.zeros(nray), np.ones(nray)*phi0,
                                 cur[3]-.5*cur[4], cur[3]+.5*cur[4], cur[5], cur[6],
                                 cur[7]-.5*cur[8], cur[7]+.5*cur[8],
                                 init_dkk, init_dll, cur[8], grids, var=0)
flux_mine = mt.project_reference_variant(
    sf.rays.dens, sf.rays.lam, sf.rays.phi,
    sf.rays.r-.5*sf.rays.dr, sf.rays.r+.5*sf.rays.dr,
    sf.rays.k, sf.rays.l, sf.rays.m-.5*sf.rays.dm, sf.rays.m+.5*sf.rays.dm,
    stf.dkk, stf.dll, sf.rays.dm, jnp.asarray(grids), cfg.bvf, var=0)
ferr = np.max(np.abs(np.asarray(flux_mine)-flux_ref)) / (np.max(np.abs(flux_ref))+1e-30)
print(f"  flux-profile max err (rel to max): {ferr:.3e}  {'< 1e-6 TARGET MET' if ferr < 1e-6 else 'FAIL'}")

# ---------- probes ----------
# probe 1: capacity padding — inactive slots must not change results
rays2, statics2 = mt.pad_rays(rays, statics, 128)
state2 = mt.State(rays2, mt.MeanState(jnp.asarray(init_uu), jnp.asarray(init_vv)))
sf2, _, _ = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfg, run))(state2, statics2)
du = np.max(np.abs(np.asarray(sf2.mean.u) - np.asarray(sf.mean.u)))
print(f"probe padding: wind diff with 68 inactive padded slots = {du:.3e} {'OK' if du == 0 else 'FAIL'}")

# probe 2: hprop=True + saturate_online=True path runs without NaNs
cfg3 = cfg.replace(hprop=True, saturate_online=True, phi0=float(np.deg2rad(-30)))
bg3 = mt.make_background(gc, cfg3, init_uu, init_vv)
rays3, statics3 = mt.wave_packet_ic(gc, cfg3, bg3, n_ray=nray)
state3 = mt.State(rays3, mt.MeanState(jnp.asarray(init_uu), jnp.asarray(init_vv)))
sf3, _, _ = jax.jit(lambda s, st: mt.simulate(s, st, bg3, cfg3, mt.RunConfig(dt=dt, n_steps=100, save_every=100)))(state3, statics3)
finite = all(bool(np.all(np.isfinite(np.asarray(x)))) for x in sf3.rays) and bool(np.all(np.isfinite(np.asarray(sf3.mean.u))))
print(f"probe hprop+online-saturation 100 steps: all finite = {finite}")

# probe 3: culling+relaunch with tidal background
cfg4 = cfg.replace(cull=True, relaunch=True, m_max=2*np.pi/200.0)
src = mt.gaussian_spectrum_source(cfg4, bg, 60)
rays4, statics4 = src
state4 = mt.State(rays4, mt.MeanState(jnp.asarray(init_uu), jnp.asarray(init_vv)))
sf4, stf4, _ = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfg4, mt.RunConfig(dt=dt, n_steps=200, save_every=200), source=src))(state4, statics4)
print(f"probe cull+relaunch 200 steps: active={int(np.sum(np.asarray(stf4.active)))}/60, finite={bool(np.all(np.isfinite(np.asarray(sf4.rays.dens))))}")

# probe 4: float32 fast mode runs and stays close
state32 = jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.float64 else x, state)
statics32 = jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.float64 else x, statics)
bg32 = jax.tree.map(lambda x: x.astype(jnp.float32), bg)
cfg32 = cfg.replace(dtype="float32")
sf32, _, _ = jax.jit(lambda s, st: mt.simulate(s, st, bg32, cfg32, mt.RunConfig(dt=dt, n_steps=100, save_every=100)))(state32, statics32)
sf64, _, _ = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfg, mt.RunConfig(dt=dt, n_steps=100, save_every=100)))(state, statics)
rel = np.max(np.abs(np.asarray(sf32.mean.u, dtype=np.float64) - np.asarray(sf64.mean.u)) / (np.max(np.abs(np.asarray(sf64.mean.u)))+1e-30))
print(f"probe float32 100 steps: wind rel err vs f64 = {rel:.2e}")
print("VERIFY DRIVE COMPLETE")
