"""Decompose the adjoint backward:forward ratio.

Under the two-level remat schedule (``simulate(remat="full")``), the cost
of ``jax.grad`` through an n-step run is, in single-forward-pass units:

    1  (primal value pass)
  + 1  (per-block forward replay — outer ``jax.checkpoint``)
  + 1  (per-step forward replay — inner ``jax.checkpoint``)
  + x  (the per-step VJP: residual-saving forward overhead + transpose)
  = 3 + x

so a measured end-to-end ratio r implies x = r - 3: the transpose sweep
of one coupled step, in forward units (textbook ~2).  This tool measures
x directly (a scan
whose body runs ``jax.vjp`` through one step, forward + backward per
iteration, minus a plain forward scan) and then ablates the step's
components to locate where the transpose cost concentrates:

  * ``no_sat``    — online saturation off (RK3 + projection only)
  * ``no_proj``   — ``prognostic_mean=False``: XLA drops the flux
                    projection and mean-flow tendencies entirely
  * ``no_sat+no_proj`` — neither: the bare ray-propagation RHS
  * ``interp=gather`` — dense hat-basis interp swapped for gather (whose
                    transpose is a scatter-add)

Prints a table and one JSON line per row.
Matches the differentiability contract of the reference's full
experiment loop (raytracer.py:157-191).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_disable_hlo_passes=while_loop_unroller"
).strip()

import jax
import jax.numpy as jnp

import bench
from msgwam_tpu.models.integrate import rk3_step


def _time(fn, *args, reps=3):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def measure(n_ray: int, n_steps: int, cfg, bg, state, statics, label: str):
    """Per-step forward time and per-step (vjp fwd+bwd) time for `step`
    under config `cfg`, amortized over an n_steps scan (one dispatch, so
    per-call launch overhead does not swamp a single step)."""

    # rk3_step, not step(): bench's grad operating point runs online
    # saturation with cull off, where step() IS rk3_step plus an aux
    # wrapper — and using rk3_step keeps the saturate_online=False
    # ablation from triggering step()'s offline saturation pass (which
    # would move the saturation cost, not remove it)
    def one(dt, s, st):
        return rk3_step(dt, s, st, bg, cfg), st

    @jax.jit
    def fwd_scan(s, st):
        def body(carry, _):
            s, st = carry
            return one(bench.DT, s, st), 0.0
        (s, st), _ = jax.lax.scan(body, (s, st), None, length=n_steps)
        return s

    @jax.jit
    def fwd_bwd_scan(s, st, ct):
        # each iteration: vjp through one step (forward with residuals +
        # transpose).  The statics cotangent is dropped (int/mask fields);
        # the state cotangent is threaded so the chain matches a real
        # backward sweep's data flow.
        def body(carry, _):
            s, st, ct = carry
            s2, vjp = jax.vjp(lambda s_: one(bench.DT, s_, st)[0], s)
            (ct2,) = vjp(ct)
            return (s2, st, ct2), 0.0
        (s, st, ct), _ = jax.lax.scan(body, (s, st, ct), None, length=n_steps)
        return s, ct

    ct0 = jax.tree.map(jnp.ones_like, state)
    t_f, _ = _time(fwd_scan, state, statics)
    t_fb, _ = _time(fwd_bwd_scan, state, statics, ct0)
    per_f = t_f / n_steps
    per_fb = t_fb / n_steps
    x = (t_fb - t_f) / t_f  # transpose cost in forward units
    row = {
        "label": label,
        "n_ray": n_ray,
        "fwd_ms_per_step": round(per_f * 1e3, 4),
        "fwd_bwd_ms_per_step": round(per_fb * 1e3, 4),
        "x_transpose_over_fwd": round(x, 2),
        "predicted_end_to_end_ratio": round(3 + x, 2),
    }
    print(f"{label:>16} fwd {per_f*1e3:8.3f} ms  fwd+bwd {per_fb*1e3:8.3f} ms"
          f"  x = {x:5.2f}  ratio(3+x) = {3+x:5.2f}", flush=True)
    return row


def main(n_ray=1_000_000, n_steps=100):
    from msgwam_tpu.utils.xla import enable_persistent_compile_cache
    enable_persistent_compile_cache()
    rows = []
    print(f"# adjoint transpose decomposition — {n_ray:,} rays, "
          f"{n_steps}-step scans, device={jax.devices()[0].device_kind}")

    alpha = 0.003 * min(1.0, (1e5 / n_ray) ** 0.5)
    cfg, bg, state, statics = bench._setup(n_ray, "mxu", "native",
                                           alpha=alpha)
    rows.append(measure(n_ray, n_steps, cfg, bg, state, statics, "base"))

    c = cfg.replace(saturate_online=False)
    rows.append(measure(n_ray, n_steps, c, bg, state, statics, "no_sat"))

    c = cfg.replace(prognostic_mean=False)
    rows.append(measure(n_ray, n_steps, c, bg, state, statics, "no_proj"))

    c = cfg.replace(saturate_online=False, prognostic_mean=False)
    rows.append(measure(n_ray, n_steps, c, bg, state, statics,
                        "no_sat+no_proj"))

    c = cfg.replace(interp_backend="gather")
    rows.append(measure(n_ray, n_steps, c, bg, state, statics,
                        "interp=gather"))

    for row in rows:
        print(json.dumps(row))


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-ray", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=100)
    a = ap.parse_args()
    main(a.n_ray, a.steps)
