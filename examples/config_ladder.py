"""The BASELINE.json config ladder, end to end, in one script.

Each BASELINE benchmark configuration as a small runnable demo (sized to
finish in seconds on CPU; crank the constants for real runs):

  1. Gaussian source spectrum over a fixed background, flux diagnostics only
     (``prognostic_mean=False`` — the wind tendencies vanish and XLA drops
     the unused flux work).
  2. Interactive wave–mean-flow coupling: the projected pseudo-momentum flux
     divergence updates U(z) every step.
  5. A stochastic-source ensemble, vmapped over members (data parallel;
     shards across a device mesh when more than one device is visible).

Config 0 (the reference's single-packet default run) is
``examples/reference_experiment.py``; configs 3–4 (tidal shear +
critical-level culling and relaunch) are
``examples/critical_level_relaunch.py``.

Run:  python examples/config_ladder.py [--plot out.png]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_disable_hlo_passes=while_loop_unroller"
).strip()

import numpy as np
import jax
import jax.numpy as jnp

import msgwam_tpu as mt

N_RAY = 2_000
N_STEPS = 240          # 8 simulated hours at dt=120 s
DT = 120.0


def base_setup(cfg, dtype=jnp.float32):
    gc = mt.GridConfig()
    centers = gc.centers()
    uu = np.asarray(
        mt.velocities_sine_homogeneous(jnp.asarray(centers, dtype), cfg)
    ).astype(dtype)
    bg = mt.make_background(gc, cfg, uu, np.zeros_like(uu), dtype=dtype)
    return gc, bg, uu


def config_1_fixed_background():
    """Spectrum over a fixed background; wave-action flux diagnostics."""
    cfg = mt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32", prognostic_mean=False,
        projection_backend="mxu", interp_backend="mxu",
    )
    gc, bg, uu = base_setup(cfg)
    rays, statics = mt.gaussian_spectrum_source(
        cfg, bg, N_RAY, z_launch=4000.0, dz_launch=2000.0,
        amplitude_alpha=0.01, dtype=jnp.float32,
    )
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.zeros_like(jnp.asarray(uu))))
    run = mt.RunConfig(dt=DT, n_steps=N_STEPS, save_every=N_STEPS // 12)

    final, _, hist = jax.jit(
        lambda s, st: mt.simulate(s, st, bg, cfg, run)
    )(state, statics)

    from msgwam_tpu.diagnostics import wave_action_history

    hist_state, hist_active, _ = hist
    diag = wave_action_history(
        hist_state.rays, hist_active, statics, bg, cfg
    )
    wa = np.asarray(diag.wave_action)
    print(f"[config 1] fixed background: projected wave action, frame totals "
          f"{wa.sum(axis=1)[:4].round(4)} ...")
    return wa


def config_2_coupled():
    """Interactive coupling: flux divergence feeds back into U(z)."""
    cfg = mt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32",
        projection_backend="mxu", interp_backend="mxu",
    )
    gc, bg, uu = base_setup(cfg)
    rays, statics = mt.gaussian_spectrum_source(
        cfg, bg, N_RAY, z_launch=4000.0, dz_launch=2000.0,
        amplitude_alpha=0.01, dtype=jnp.float32,
    )
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.zeros_like(jnp.asarray(uu))))
    run = mt.RunConfig(dt=DT, n_steps=N_STEPS, save_every=N_STEPS // 12)

    final, _, hist = jax.jit(
        lambda s, st: mt.simulate(s, st, bg, cfg, run)
    )(state, statics)
    du = np.asarray(final.mean.u) - uu
    print(f"[config 2] coupled: max |ΔU| after {N_STEPS} steps = "
          f"{np.abs(du).max():.3f} m/s at z = "
          f"{np.asarray(bg.centers)[np.abs(du).argmax()]/1e3:.0f} km")
    return np.stack([uu, np.asarray(final.mean.u)])


def config_5_ensemble():
    """Stochastic-source ensemble: the vmapped scan path, sharded over
    members when more than one device is visible."""
    from msgwam_tpu.parallel.ensemble import ensemble_simulate, stack_ensemble

    cfg = mt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32",
        projection_backend="mxu", interp_backend="mxu",
    )
    gc, bg, uu = base_setup(cfg)

    n_members = 8
    members = []
    for i in range(n_members):
        key = jax.random.PRNGKey(i)
        rays, statics = mt.gaussian_spectrum_source(
            cfg, bg, N_RAY // 4, z_launch=4000.0, dz_launch=2000.0,
            amplitude_alpha=0.01, key=key, dtype=jnp.float32,
        )
        members.append((
            mt.State(rays, mt.MeanState(jnp.asarray(uu),
                                        jnp.zeros_like(jnp.asarray(uu)))),
            statics,
        ))
    states, statics = stack_ensemble(members)
    run = mt.RunConfig(dt=DT, n_steps=N_STEPS // 4, save_every=N_STEPS // 4)

    mesh = None
    if len(jax.devices()) > 1:
        from msgwam_tpu.parallel.sharding import make_mesh
        mesh = make_mesh(axis="ensemble")
    finals, _, _ = ensemble_simulate(states, statics, bg, cfg, run,
                                     mesh=mesh)
    du = np.asarray(finals.mean.u) - uu[None, :]
    spread = du.max(axis=0) - du.min(axis=0)
    print(f"[config 5] ensemble of {n_members}: member "
          f"wind-response spread max {spread.max():.4f} m/s "
          f"(devices: {len(jax.devices())})")
    return du


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--plot", default=None, help="save a summary figure")
    args = ap.parse_args()

    wa = config_1_fixed_background()
    u2 = config_2_coupled()
    du5 = config_5_ensemble()

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        z = mt.GridConfig().centers() / 1e3
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        axes[0].imshow(wa.T, aspect="auto", origin="lower",
                       extent=[0, N_STEPS * DT / 3600, 0, 100])
        axes[0].set(title="cfg 1: wave action", xlabel="t [h]", ylabel="z [km]")
        axes[1].plot(u2[0], z, label="U(z, t=0)")
        axes[1].plot(u2[1], z, label="U(z, final)")
        axes[1].set(title="cfg 2: coupled wind", xlabel="U [m/s]")
        axes[1].legend()
        for m in du5:
            axes[2].plot(m, z, lw=0.7)
        axes[2].set(title="cfg 5: ensemble ΔU", xlabel="ΔU [m/s]")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
