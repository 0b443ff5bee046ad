"""Diagnose the long-horizon adjoint blow-up.

`jax.grad` through 100 coupled steps is finite (and FD-validated), but
through 720 steps the gradient has been found non-finite at both 1e5 and
1e6 rays.  Two hypotheses:

  (a) f32 dynamic-range overflow: the adjoint of a nonlinear coupled
      system grows with horizon; cotangents exceed f32 max even though
      the f64 adjoint is finite.
  (b) genuine exponential growth (chaotic sensitivity) or a singular
      VJP (an Inf/NaN injected at a specific step by a non-grad-safe
      op that only activates late in the run, e.g. at breaking events).

This probe runs small-step ladders at 1e4 rays (fast on a CPU or GPU) in f32
AND f64, reporting max|g| and the finite fraction at each horizon: if
max|g| grows roughly exponentially and f64 stays finite after f32
overflows, it's (a); if f64 dies at the same horizon, it's (b) — then
bisect for the step where the backward first goes non-finite.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_disable_hlo_passes=while_loop_unroller"
).strip()
import numpy as np
import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

import msgwam_tpu as mt


def setup(n_ray, dtype, alpha):
    cfg = mt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype=dtype,
        projection_backend="mxu", interp_backend="mxu",
    )
    gc = mt.GridConfig()
    centers = gc.centers()
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    uu = np.asarray(mt.velocities_sine_homogeneous(
        jnp.asarray(centers, jdt), cfg)).astype(dtype)
    vv = np.zeros_like(uu)
    bg = mt.make_background(gc, cfg, uu, vv, dtype=jdt)
    rays, statics = mt.gaussian_spectrum_source(
        cfg, bg, n_ray, z_launch=2000.0, dz_launch=500.0,
        amplitude_alpha=alpha, dtype=jdt)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu, jdt),
                                        jnp.asarray(vv, jdt)))
    return cfg, bg, state, statics


def probe(n_ray=10_000, horizons=(100, 200, 400, 720)):
    alpha = 0.003 * min(1.0, (1e5 / n_ray) ** 0.5)
    for dtype in ("float32", "float64"):
        cfg, bg, state, statics = setup(n_ray, dtype, alpha)
        u0 = state.mean.u
        observe = lambda s, st, aux: s.mean.u
        for n_steps in horizons:
            save = max(1, round(n_steps ** 0.5))
            while n_steps % save:
                save -= 1
            run = mt.RunConfig(dt=120.0, n_steps=n_steps, save_every=save)

            def loss(dens0):
                s = state._replace(rays=state.rays._replace(dens=dens0))
                final, _, _ = mt.simulate(s, statics, bg, cfg, run,
                                          observe=observe, remat="full",
                                          validate=False)
                return jnp.sum((final.mean.u - u0) ** 2)

            val, g = jax.jit(jax.value_and_grad(loss))(state.rays.dens)
            g = np.asarray(g)
            finite = np.isfinite(g).mean()
            print(f"{dtype} n={n_ray} steps={n_steps:5d} save={save:3d} "
                  f"loss={float(val):.6e} finite={finite:.4f} "
                  f"max|g|={np.nanmax(np.abs(g[np.isfinite(g)])) if np.isfinite(g).any() else float('nan'):.6e}",
                  flush=True)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-ray", type=int, default=10_000)
    ap.add_argument("--horizons", type=int, nargs="*",
                    default=[100, 200, 400, 720])
    a = ap.parse_args()
    probe(a.n_ray, tuple(a.horizons))
