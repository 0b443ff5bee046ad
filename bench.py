"""Benchmark: ray-volume steps per second of the coupled scan path, at
1e5 rays with full wave/mean-flow coupling and online saturation (the
metric of record, BASELINE.json), on one GPU.

Prints one JSON line per run: {"metric", "value", "unit", "vs_baseline",
"device", ...}.  ``device`` names the platform, the device kind and the
device count the run used.  Baseline: the NumPy reference measured at
~3.0e4 ray-steps/s on one CPU core (BASELINE.md).

The command line refuses to run on anything but a GPU: a CPU run would
print a host rate under a device metric.  ``run_one`` and ``run_grad``
stay callable as library functions on any backend (the tests call them on
the CPU), and every result they return names its device.

Flags:
  --backend {mxu,xla}          scan-path backend pair (default mxu: dense
                               contractions, the f32 fast path; xla =
                               segment-sum deposit + np.interp-exact gather)
  --accum {native,compensated,f64}  flux accumulation (mxu backend)
  --sharded                    shard_map over all visible devices
  --n-ray N / --steps N        problem size (default 1e5 rays, 720 steps =
                               one simulated day at dt = 120 s)
  --all                        every backend pair, one JSON line each
  --grad                       jax.grad through the coupled run
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# scan compile time scales with trip count unless the unroller is off
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_disable_hlo_passes=while_loop_unroller"
).strip()

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import msgwam_tpu as mt  # noqa: E402
from msgwam_tpu.utils.xla import enable_persistent_compile_cache  # noqa: E402

N_RAY = 100_000
N_STEPS = 720  # one simulated day at dt = 120 s
DT = 120.0
BASELINE_RAY_STEPS_PER_SEC = 3.0e4


def device_info() -> dict:
    """The device a result was measured on, as JAX reports it."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _peak_bytes():
    stats = jax.local_devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _setup(n_ray: int, backend: str, accum: str, alpha: float = 0.003,
           hprop: bool = False, sat: str = "online", dtype: str = "float32"):
    jdt = jnp.dtype(dtype)
    cfg = mt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=(sat == "online"),
        hprop=hprop,
        dtype=dtype,
        projection_backend="xla" if backend == "xla" else "mxu",
        interp_backend="gather" if backend == "xla" else "mxu",
        flux_accum=accum if backend == "mxu" else "native",
    )
    gc = mt.GridConfig()
    centers = gc.centers()
    uu = np.asarray(
        mt.velocities_sine_homogeneous(jnp.asarray(centers, jdt), cfg)
    ).astype(jdt)
    vv = np.zeros_like(uu)
    bg = mt.make_background(gc, cfg, uu, vv, dtype=jdt)
    rays, statics = mt.gaussian_spectrum_source(
        cfg, bg, n_ray,
        z_launch=2000.0, dz_launch=500.0,
        amplitude_alpha=alpha,  # default keeps total forcing physical at 1e5
        dtype=jdt,
    )
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.asarray(vv)))
    return cfg, bg, state, statics


def run_one(n_ray: int = N_RAY, n_steps: int = N_STEPS,
            backend: str = "mxu", accum: str = "compensated",
            sharded: bool = False, hprop: bool = False,
            sat: str = "online") -> dict:
    """Time one ``n_steps`` run (best of three, after a compiling warm-up)
    on the default device and return its result line."""
    if backend not in ("mxu", "xla"):
        raise ValueError(f"unknown backend {backend!r}; available: mxu, xla")
    cfg, bg, state, statics = _setup(n_ray, backend, accum, hprop=hprop,
                                     sat=sat)
    run = mt.RunConfig(dt=DT, n_steps=n_steps, save_every=n_steps)

    if sharded:
        from msgwam_tpu.parallel.sharding import make_mesh, sharded_simulate

        mesh = make_mesh()
        n_dev = mesh.devices.size
        if n_ray % n_dev:
            capacity = -(-n_ray // n_dev) * n_dev
            rays, statics = mt.pad_rays(state.rays, statics, capacity)
            state = mt.State(rays, state.mean)
        step_fn = lambda s, st: sharded_simulate(mesh, s, st, bg, cfg, run)
    else:
        step_fn = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfg, run))

    out = step_fn(state, statics)  # compile + warm-up
    jax.block_until_ready(out)

    best = float("inf")
    for _ in range(3):
        # free the previous output set before allocating the next one, so
        # two output sets are never live beside the input state
        out = None
        t0 = time.perf_counter()
        out = step_fn(state, statics)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)

    final_state = out[0]
    if not bool(jnp.all(jnp.isfinite(final_state.mean.u))):
        raise FloatingPointError("mean wind is not finite at run end")
    if not bool(jnp.all(jnp.isfinite(final_state.rays.dens))):
        raise FloatingPointError("wave-action density is not finite at run end")

    ray_steps_per_sec = n_ray * n_steps / best
    label = backend + ("+" + cfg.flux_accum if cfg.flux_accum != "native" else "") \
        + ("+sharded" if sharded else "") + ("+hprop" if hprop else "")
    result = {
        "metric": f"ray-volume steps/sec at {n_ray:,} rays "
                  f"(coupled, {sat} saturation, f32, {n_steps} steps, {label})",
        "value": ray_steps_per_sec,
        "unit": "ray-steps/s",
        "vs_baseline": ray_steps_per_sec / BASELINE_RAY_STEPS_PER_SEC,
        "seconds": best,
        "device": device_info(),
    }
    peak = _peak_bytes()
    if peak is not None:
        result["peak_bytes_in_use"] = peak
    return result


def grad_loss(cfg, bg, state, statics, n_steps: int, remat="full"):
    """``loss(dens0)``: the squared wind response after ``n_steps`` steps
    of the coupled run started from launch densities ``dens0``, with
    ``save_every ~ sqrt(n_steps)`` remat blocks (see ``simulate(remat=…)``).
    """
    save = max(1, round(n_steps ** 0.5))
    while n_steps % save:
        save -= 1
    run = mt.RunConfig(dt=DT, n_steps=n_steps, save_every=save)
    u0 = state.mean.u
    observe = lambda s, st, aux: s.mean.u  # O(n_cell) history only

    def loss(dens0):
        s = state._replace(rays=state.rays._replace(dens=dens0))
        final, _, _ = mt.simulate(s, statics, bg, cfg, run,
                                  observe=observe, remat=remat,
                                  validate=False)
        return jnp.sum((final.mean.u - u0) ** 2)

    return loss


def grad_setup(n_ray: int, backend: str = "mxu", accum: str = "compensated",
               alpha_scale: float = 1.0, dtype: str = "float32"):
    """``(cfg, bg, state, statics)`` for :func:`grad_loss`.

    The source amplitude is normalized so TOTAL wave action is the same at
    every ray count (alpha ~ 1/sqrt(n_ray); per-ray dens ~ alpha^2 and all
    rays share one launch layer): finer ray discretizations of the SAME
    physical wave field.  Without this, 1e6 rays = 10x the physical
    forcing and the coupled wind feedback blows the forward up within ~100
    steps.  ``alpha_scale`` further scales the launch amplitude for
    long-horizon rows: at the default forcing the adjoint of the
    saturation-coupled system grows ~x2/step once strong breaking sets in
    (tools/grad_blowup_probe.py), so a 720-step gradient overflows even in
    f64; 0.1 keeps a simulated day bounded."""
    alpha = 0.003 * alpha_scale * min(1.0, (1e5 / n_ray) ** 0.5)
    return _setup(n_ray, backend, accum, alpha=alpha, dtype=dtype)


def run_grad(n_ray: int, n_steps: int = 100, remat="full",
             alpha_scale: float = 1.0, backend: str = "mxu",
             accum: str = "compensated") -> dict:
    """Adjoint benchmark: time ``jax.grad`` of :func:`grad_loss` through
    the fully coupled run and report the backward:forward ratio plus
    device peak memory.  Non-finite gradients are recorded as
    ``"gradient_finite": false`` — a measured outcome (see
    :func:`grad_setup`), not a harness failure."""
    cfg, bg, state, statics = grad_setup(n_ray, backend, accum, alpha_scale)
    loss = grad_loss(cfg, bg, state, statics, n_steps, remat)
    fwd = jax.jit(loss)
    grad = jax.jit(jax.grad(loss))

    def _time(fn, arg):
        out = fn(arg)  # compile + warm-up
        jax.block_until_ready(out)
        b = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(arg)
            jax.block_until_ready(out)
            b = min(b, time.perf_counter() - t0)
        return b, out

    t_fwd, _ = _time(fwd, state.rays.dens)
    t_grad, g = _time(grad, state.rays.dens)
    finite = bool(jnp.all(jnp.isfinite(g)))
    gmax = float(jnp.max(jnp.where(jnp.isfinite(g), jnp.abs(g), 0.0)))
    if finite and gmax == 0.0:
        raise FloatingPointError("gradient is identically zero")
    rs = n_ray * n_steps / t_grad
    remat_name = remat if isinstance(remat, str) else ("on" if remat else "off")
    result = {
        "metric": f"adjoint (value+grad) ray-steps/sec at {n_ray:,} rays "
                  f"(coupled run, {n_steps} steps, {backend}, "
                  f"remat={remat_name})",
        "value": rs,
        "unit": "ray-steps/s",
        "vs_baseline": rs / BASELINE_RAY_STEPS_PER_SEC,
        "forward_s": t_fwd,
        "grad_s": t_grad,
        "bwd_fwd_ratio": t_grad / t_fwd,
        "gradient_finite": finite,
        "grad_max_abs": gmax,
        "device": device_info(),
    }
    if alpha_scale != 1.0:
        result["alpha_scale"] = alpha_scale
    peak = _peak_bytes()
    if peak is not None:
        result["peak_bytes_in_use"] = peak
    return result


def require_gpu() -> None:
    """Exit non-zero unless JAX's default device is a GPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU, but JAX's default device is "
            f"{platform!r}; run it on a machine with a GPU (a CPU run "
            f"would report a host rate as a device metric)")


def cli(argv=None):
    """Flag-driven entry point (also reachable as
    ``python -m msgwam_tpu bench <flags>``)."""
    ap = argparse.ArgumentParser(prog="bench.py")
    ap.add_argument("--backend", choices=["mxu", "xla"], default="mxu")
    ap.add_argument("--accum", choices=["native", "compensated", "f64"],
                    default="compensated")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--n-ray", type=int, default=N_RAY)
    ap.add_argument("--steps", type=int,
                    help="steps per run (default 720, one simulated day; "
                         "100 with --grad)")
    ap.add_argument("--all", action="store_true",
                    help="run every backend pair (one JSON line each)")
    ap.add_argument("--grad", action="store_true",
                    help="adjoint benchmark: jax.grad through the coupled "
                         "run at --n-ray (default 100 steps)")
    ap.add_argument("--hprop", action="store_true",
                    help="spherical horizontal propagation on")
    ap.add_argument("--sat", choices=["online", "offline"], default="online",
                    help="saturation mode: online (inside the RHS) or "
                         "offline (the reference quirk-2 between-steps "
                         "finite-difference pass)")
    ap.add_argument("--grad-remat", choices=["on", "full", "off"],
                    default="full",
                    help="jax.checkpoint remat for --grad: full = per-block "
                         "+ per-step (required at 1e6 rays); on = "
                         "per-block only; off = none")
    ap.add_argument("--grad-alpha-scale", type=float, default=1.0,
                    help="launch-amplitude scale for --grad long-horizon "
                         "rows (0.1 keeps a full simulated day bounded)")
    args = ap.parse_args(argv)
    require_gpu()
    enable_persistent_compile_cache()  # after parsing: --help stays cheap
    if args.grad:
        remat = {"on": True, "off": False}.get(args.grad_remat,
                                               args.grad_remat)
        print(json.dumps(run_grad(args.n_ray, args.steps or 100, remat=remat,
                                  alpha_scale=args.grad_alpha_scale,
                                  backend=args.backend, accum=args.accum)))
        return
    steps = args.steps or N_STEPS
    pairs = ([("mxu", "compensated"), ("mxu", "native"), ("xla", "native")]
             if args.all else [(args.backend, args.accum)])
    for backend, accum in pairs:
        print(json.dumps(run_one(args.n_ray, steps, backend, accum,
                                 args.sharded, hprop=args.hprop,
                                 sat=args.sat)), flush=True)


if __name__ == "__main__":
    cli()
