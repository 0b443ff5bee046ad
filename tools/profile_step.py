"""Capture a jax.profiler trace of the model step for xprof/tensorboard.

Usage:
    python tools/profile_step.py [--nray 100000] [--steps 20] [--out /tmp/trace]

View with: tensorboard --logdir <out>   (or upload to xprof)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_disable_hlo_passes=while_loop_unroller"
).strip()

import numpy as np
import jax
import jax.numpy as jnp

import msgwam_tpu as mt
from msgwam_tpu.utils.profiling import StepTimer, trace


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nray", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="/tmp/msgwam_trace")
    args = ap.parse_args()

    cfg = mt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32",
        projection_backend="mxu", interp_backend="mxu",
    )
    gc = mt.GridConfig()
    uu = np.sin(gc.centers() / 1e4).astype(np.float32)
    vv = np.zeros_like(uu)
    bg = mt.make_background(gc, cfg, uu, vv, dtype=jnp.float32)
    rays, statics = mt.gaussian_spectrum_source(
        cfg, bg, args.nray, z_launch=2000.0, dz_launch=500.0,
        amplitude_alpha=0.003, dtype=jnp.float32,
    )
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.asarray(vv)))
    run = mt.RunConfig(dt=120.0, n_steps=args.steps, save_every=args.steps)
    f = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfg, run))

    out = f(state, statics)
    jax.block_until_ready(out)  # compile outside the trace

    timer = StepTimer()
    with trace(args.out):
        for _ in range(3):
            timer.start()
            out = f(state, statics)
            timer.stop(out)
    print(f"traced 3 runs of {args.steps} steps @ {args.nray} rays: "
          f"best {timer.best / args.steps * 1e3:.3f} ms/step -> {args.out}")


if __name__ == "__main__":
    main()
