"""Experiment driver CLI — the reference's L3 layer (``raytracer.py``) as a
config-file-driven command instead of an edit-the-constants script.

Usage:
    python -m msgwam_tpu run --config experiment.json --out results/
    python -m msgwam_tpu run --preset reference --steps 200 --out results/
    python -m msgwam_tpu bench

The JSON config mirrors the driver constants block (``raytracer.py:32-64``)
plus any :class:`~msgwam_tpu.config.ModelConfig` field, e.g.::

    {
      "model": {"u0": 4.0, "kappa": 1.0, "saturate_online": false,
                "hprop": false, "phi0": 0.0, "rr0": 40000.0},
      "grid": {"n_face": 101, "z_max": 100e3},
      "run": {"dt": 120.0, "n_steps": 1440, "save_every": 10},
      "source": {"kind": "wave_packet", "n_ray": 60, "alpha": 0.01},
      "background": "sine",
      "dtype": "float64"
    }
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from typing import NamedTuple


REFERENCE_PRESET = {
    "model": {
        "bvf": 0.01, "boussinesq": False, "sig_rr": 10000.0, "u0": 4.0,
        "rr0": 40000.0, "rr1": 40000.0, "phi0": 0.0, "kappa": 1.0,
        "saturate_online": False, "hprop": False,
    },
    "grid": {"n_face": 101, "z_max": 100e3},
    "run": {"dt": 120.0, "n_steps": 1440, "save_every": 1},
    "source": {"kind": "wave_packet", "n_ray": 60, "alpha": 0.01},
    "background": "sine",
    "dtype": "float64",
}

FAST_PRESET = {
    "model": {
        "bvf": 0.01, "u0": 4.0, "rr0": 40000.0, "phi0": 0.0, "kappa": 1.0,
        "saturate_online": True, "hprop": False,
        "projection_backend": "mxu", "interp_backend": "mxu",
        # compensated block accumulation keeps the f32 deposit error ~1e-7,
        # inside the <1e-6 north-star bar ('native' exceeds it at this ray
        # count); tested in test_fast_path.py
        "flux_accum": "compensated",
    },
    "grid": {"n_face": 101, "z_max": 100e3},
    "run": {"dt": 120.0, "n_steps": 720, "save_every": 10},
    "source": {"kind": "gaussian_spectrum", "n_ray": 100000,
               "z_launch": 2000.0, "dz_launch": 500.0,
               "amplitude_alpha": 0.001},
    "background": "sine",
    "dtype": "float32",
}

PRESETS = {"reference": REFERENCE_PRESET, "fast": FAST_PRESET}

# --kernels / "kernels": the two backend pairs of the scan path.
KERNELS = {
    # parity backends: segment-sum deposit at the working dtype,
    # np.interp-exact interpolation
    "xla": dict(projection_backend="xla", interp_backend="gather",
                flux_accum="native"),
    # dense-contraction backends: the f32 fast path
    "mxu": dict(projection_backend="mxu", interp_backend="mxu"),
}

# ModelConfig fields that configured the removed fused and whole-run kernels
REMOVED_MODEL_KEYS = ("rhs_backend", "window_cells", "window_cells2")

BACKGROUNDS = {
    "sine": "velocities_sine_homogeneous",
    "tanh": "velocities_tanh_homogeneous",
    "gauss": "velocities_gauss_homogeneous",
    "zero": None,
}

# Named TRANSIENT backgrounds: a JSON config cannot carry
# a wind_fn callable, so ``"background": {"kind": "tidal", ...}`` names one
# from this registry instead; extra keys are keyword arguments for the
# factory (models/backgrounds.py).  Each entry maps to a function
# f(centers, t, cfg, **params) -> u(z, t); v is zero.  This makes
# BASELINE.json configs[3] (tidal shear + critical-level cull + relaunch)
# an end-to-end driver experience — see examples/config4.json.
TRANSIENT_BACKGROUNDS = {
    "tidal": "tidal_shear",
}


def _load_config(args) -> dict:
    if args.config:
        with open(args.config) as f:
            spec = json.load(f)
    else:
        spec = json.loads(json.dumps(PRESETS[args.preset]))  # deep copy
    if args.steps:
        spec["run"]["n_steps"] = args.steps
        # keep save_every a divisor of the overridden n_steps (simulate
        # requires divisibility): largest divisor <= the preset's cadence
        cap = min(spec["run"].get("save_every", 1), args.steps)
        while args.steps % cap:
            cap -= 1
        spec["run"]["save_every"] = cap
    # --kernels from the command line, else "kernels" from the config
    # file — both install the matching model-backend settings.  A
    # command-line choice overrides the preset/file model block; a
    # file-level "kernels" only fills backends the file left unset.
    from_args = getattr(args, "kernels", None)
    kernels = from_args or spec.get("kernels")
    if kernels:
        if kernels not in KERNELS:
            raise ValueError(
                f"unknown kernels choice {kernels!r}; available: "
                f"{sorted(KERNELS)} (the whole-run and fused-RHS kernels "
                f"were removed: every run uses the scan path)")
        model = spec.setdefault("model", {})
        if from_args:
            model.update(KERNELS[kernels])
        else:
            for key, val in KERNELS[kernels].items():
                model.setdefault(key, val)
        spec["kernels"] = kernels
    return spec


def _model_config(spec: dict, dtype_name: str):
    """The spec's ModelConfig, with a clear error for removed options."""
    from . import ModelConfig

    model = spec.get("model", {})
    for key in REMOVED_MODEL_KEYS:
        if key in model:
            raise ValueError(
                f"model option {key!r} no longer exists: the kernels it "
                f"configured were removed and every run uses the scan path; "
                f"drop it and choose the backends with 'kernels' "
                f"({sorted(KERNELS)}) or projection_backend/interp_backend")
    return ModelConfig(dtype=dtype_name, **model)


class Experiment(NamedTuple):
    """Everything a run of ``spec`` needs before its time loop."""

    cfg: object        # ModelConfig
    grid: object       # GridConfig
    run: object        # RunConfig
    bg: object         # Background
    state: object      # State
    statics: object    # RayStatics
    source: object     # relaunch template (None without relaunch)
    wind_fn: object    # transient background t -> (u, v), or None


def setup_experiment(spec: dict) -> Experiment:
    """Build the configuration, background and initial state of ``spec``
    (a preset or a JSON config) on JAX's default device.  A float64 spec
    turns on ``jax_enable_x64``."""
    import jax

    if spec.get("dtype", "float64") == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from . import (
        GridConfig, MeanState, RunConfig, State,
        gaussian_spectrum_source, make_background, wave_packet_ic,
    )
    from . import models as _models

    dtype = jnp.float64 if spec.get("dtype") == "float64" else jnp.float32
    cfg = _model_config(spec, str(np.dtype(dtype)))
    gc = GridConfig(**spec.get("grid", {}))
    run = RunConfig(**spec.get("run", {}))
    centers = jnp.asarray(gc.centers(), dtype)
    bg_spec = spec.get("background", "sine")
    wind_fn = None
    if isinstance(bg_spec, dict):
        kind = bg_spec.get("kind")
        if kind not in TRANSIENT_BACKGROUNDS:
            raise ValueError(
                f"unknown transient background kind {kind!r}; "
                f"known: {sorted(TRANSIENT_BACKGROUNDS)}")
        params = {k: v for k, v in bg_spec.items() if k != "kind"}
        fn = getattr(_models, TRANSIENT_BACKGROUNDS[kind])
        zeros = jnp.zeros_like(centers)
        wind_fn = lambda t: (fn(centers, t, cfg, **params).astype(dtype),
                             zeros)
        uu = wind_fn(0.0)[0]  # hydrostatics/pressure gradient use t=0
    else:
        bg_name = BACKGROUNDS[bg_spec]
        if bg_name is None:
            uu = jnp.zeros_like(centers)
        else:
            uu = getattr(_models, bg_name)(centers, cfg).astype(dtype)
    vv = jnp.zeros_like(uu)
    bg = make_background(gc, cfg, uu, vv, dtype=dtype)

    src = dict(spec.get("source", {"kind": "wave_packet"}))
    kind = src.pop("kind", "wave_packet")
    if kind == "wave_packet":
        rays, statics = wave_packet_ic(gc, cfg, bg, dtype=dtype, **src)
    elif kind == "gaussian_spectrum":
        n_ray = src.pop("n_ray")
        rays, statics = gaussian_spectrum_source(cfg, bg, n_ray, dtype=dtype, **src)
    else:
        raise ValueError(f"unknown source kind {kind!r}")
    state = State(rays, MeanState(uu, vv))
    source = (rays, statics) if cfg.relaunch else None

    # d(dr)/dt is structurally zero in this model, so the widest ray volume
    # is known at run start: auto-raise max_span so the xla (segment-sum)
    # projection never truncates a deposit.
    if cfg.projection_backend == "xla":
        from .ops.projection import required_span

        need = required_span(float(jnp.max(rays.dr)), gc.dz)
        if need > cfg.max_span:
            print(f"raising max_span {cfg.max_span} -> {need} "
                  f"(widest ray volume spans {need} cells)")
            cfg = cfg.replace(max_span=need)

    return Experiment(cfg, gc, run, bg, state, statics, source, wind_fn)


def run_experiment(
    spec: dict,
    out_dir: str,
    make_plot: bool = True,
    log_every: int = 0,
    resume_from: str = None,
    stream_history: bool = False,
    shard: bool = False,
) -> dict:
    from .utils.xla import (
        apply_recommended_xla_flags, enable_persistent_compile_cache,
    )

    if make_plot and importlib.util.find_spec("matplotlib") is None:
        # fail before the run, not after it
        raise RuntimeError(
            "plotting needs matplotlib, which is not installed; pass "
            "--no-plot (make_plot=False) to run without the figure")
    apply_recommended_xla_flags()
    import jax

    enable_persistent_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from . import RunConfig, simulate
    from .diagnostics import wave_action_history
    from .utils.checkpoint import save_checkpoint

    cfg, gc, run, bg, state, statics, source, wind_fn = setup_experiment(spec)
    dtype = state.rays.dens.dtype

    step0 = 0
    if resume_from:
        from .utils.checkpoint import load_checkpoint

        state, statics, step0, _, _ = load_checkpoint(resume_from)
        print(f"resumed from {resume_from} at step {step0}")
    # resumed runs continue physical time where the checkpoint stopped:
    # transient wind_fn backgrounds and the output time axis both use t0
    t0 = step0 * run.dt

    # every sim takes the chunk's physical start time as a TRACED scalar:
    # with --log-every the run is host-chunked, and a transient wind_fn
    # must continue its phase across chunks (a closed-over constant t0
    # would restart the tide every chunk)
    if shard:
        if wind_fn is not None:
            raise ValueError(
                "--shard does not support transient backgrounds (the "
                "sharded scan path has no wind_fn threading); drop "
                "--shard or use a static background")
        # rays sharded over all visible devices; one psum per RHS
        # evaluation at the flux reduction (parallel/sharding.py).  The
        # sharded scan path takes no t0: sharded backgrounds are static
        # wind profiles (transient ones are rejected above), so t0 only
        # shapes the output time axis, which is handled below.
        from .parallel import (
            full_history_observe, full_history_observe_spec, make_mesh,
            sharded_simulate,
        )

        mesh = make_mesh()
        n_dev = mesh.devices.size
        n_cap = int(state.rays.dens.shape[0])
        if n_cap % n_dev:
            raise ValueError(
                f"--shard: ray count {n_cap} must be divisible by the "
                f"device count {n_dev} (source n_ray controls it)"
            )
        print(f"--shard: rays split over {n_dev} device(s)")
        from jax.sharding import NamedSharding, PartitionSpec

        def sim(s, st, r, toff):  # toff unused: transient bgs rejected above
            f, sf, h = sharded_simulate(
                mesh, s, st, bg, cfg, r,
                observe=full_history_observe,
                observe_spec=full_history_observe_spec(),
                source=source,
            )
            # post-run diagnostics contract over the ray axis; gather the
            # history to replicated (one all-gather per run, not per step)
            h = jax.device_put(h, NamedSharding(mesh, PartitionSpec()))
            return f, sf, h
    else:
        sim = jax.jit(
            lambda s, st, r, toff: simulate(s, st, bg, cfg, r, source=source,
                                            wind_fn=wind_fn, t0=toff),
            static_argnums=(2,),
        )
    if log_every:
        # host-chunked stepping with structured progress metrics
        from .utils.metrics import MetricsLogger
        import logging

        logging.basicConfig(level=logging.INFO, format="%(message)s")
        chunk = RunConfig(dt=run.dt, n_steps=log_every,
                          save_every=run.save_every)
        if log_every % run.save_every or run.n_steps % log_every:
            raise ValueError("log_every must tile save_every and n_steps")
        logger = MetricsLogger(run.n_steps, every=log_every)
        writer = None
        if stream_history:
            from .utils.history_io import StateHistoryWriter

            os.makedirs(out_dir, exist_ok=True)
            writer = StateHistoryWriter(
                os.path.join(out_dir, "state_history.msgw"),
                capacity=int(state.rays.dens.shape[0]), n_cell=gc.n_cell,
                dtype=np.dtype(dtype),
            )
        pieces = []       # full in-RAM history chunks (non-streamed mode)
        diag_pieces = []  # per-chunk diagnostics (streamed mode: small)
        uv_frames = []    # (frames, n_cell) wind profiles (streamed mode)
        for start in range(0, run.n_steps, log_every):
            state, statics, h = sim(state, statics, chunk,
                                    t0 + start * run.dt)
            jax.block_until_ready(state)
            logger.record(
                start + log_every,
                max_u=float(jnp.max(jnp.abs(state.mean.u))),
                active=float(jnp.sum(statics.active)),
            )
            if writer is not None:
                # streamed mode: every decimated frame goes to disk through
                # the async writer (bounded queue -> the host holds at most
                # ~2 frames even at 1e6 rays) and only the per-frame grid
                # diagnostics — a few hundred floats — stay in RAM
                h_state, h_active, h_prop = h
                for fi in range(h_active.shape[0]):
                    writer.push_frame(
                        jax.tree.map(lambda x: x[fi], h_state.rays),
                        np.asarray(h_active[fi]),
                        np.asarray(h_prop[fi]),
                        jax.tree.map(lambda x: x[fi], h_state.mean),
                    )
                diag_pieces.append(wave_action_history(
                    h_state.rays, h_active, statics, bg, cfg))
                # np.array(copy=True): np.asarray of a CPU jax array is a
                # zero-copy view whose buffer is recycled with the jax array
                uv_frames.append((np.array(h_state.mean.u, copy=True),
                                  np.array(h_state.mean.v, copy=True)))
            else:
                pieces.append(h)
        if writer is not None:
            writer.close()
            diag = jax.tree.map(lambda *xs: jnp.concatenate(xs), *diag_pieces)
            hist_u = np.concatenate([u for u, _ in uv_frames])
            hist_v = np.concatenate([v for _, v in uv_frames])
            hist = None
        else:
            hist = jax.tree.map(lambda *xs: jnp.concatenate(xs), *pieces)
        final, statics_f = state, statics
    else:
        final, statics_f, hist = sim(state, statics, run, t0)

    os.makedirs(out_dir, exist_ok=True)
    ckpt = os.path.join(out_dir, "final_state.npz")
    save_checkpoint(ckpt, final, statics_f, step=step0 + run.n_steps,
                    extra={"spec": spec})

    if hist is not None:
        hist_state, hist_active, _ = hist
        diag = wave_action_history(
            hist_state.rays, hist_active, statics_f, bg, cfg)
        hist_u = np.asarray(hist_state.mean.u)
        hist_v = np.asarray(hist_state.mean.v)
    np.savez(
        os.path.join(out_dir, "diagnostics.npz"),
        wave_action=np.asarray(diag.wave_action),
        flux=np.asarray(diag.flux),
        tendency=np.asarray(diag.tendency),
        u=hist_u,
        v=hist_v,
        time=t0 + np.arange(1, run.n_steps // run.save_every + 1)
             * run.dt * run.save_every,
    )
    fig_path = None
    if make_plot:
        from .plotting import plot_wave_action_panels

        fig_path = os.path.join(out_dir, "wave_action.png")
        t = t0 + np.arange(1, run.n_steps // run.save_every + 1) \
            * run.dt * run.save_every
        plot_wave_action_panels(
            t, np.asarray(bg.faces[:-1] + 0.5 * (bg.faces[1] - bg.faces[0])),
            np.asarray(diag.wave_action), np.asarray(diag.tendency),
            plot_max_s=float(t[-1]), show=False, save_path=fig_path,
        )
    return {"checkpoint": ckpt, "figure": fig_path, "out_dir": out_dir}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="msgwam_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="run an experiment")
    runp.add_argument("--config", help="JSON experiment config")
    runp.add_argument("--preset", choices=sorted(PRESETS), default="reference")
    runp.add_argument("--steps", type=int, help="override n_steps")
    runp.add_argument("--out", default="results")
    runp.add_argument("--no-plot", action="store_true")
    runp.add_argument("--log-every", type=int, default=0,
                      help="emit structured progress metrics every N steps")
    runp.add_argument("--resume", help="checkpoint (.npz) to resume from")
    runp.add_argument("--stream-history", action="store_true",
                      help="stream wind profiles to disk via the native "
                           "async writer (requires --log-every)")
    runp.add_argument("--shard", action="store_true",
                      help="shard the ray axis over all visible devices "
                           "(scan path under shard_map; one psum per RHS "
                           "evaluation at the flux reduction)")
    runp.add_argument("--kernels", choices=sorted(KERNELS),
                      help="backend pair of the scan path: xla = parity "
                           "backends (segment-sum deposit / np.interp-exact "
                           "interpolation); mxu = dense-contraction "
                           "backends (the f32 fast path)")
    # add_help=False: `msgwam_tpu bench --help` must show bench.py's own
    # flags, so --help rides along in the forwarded extras instead of
    # being answered by this (flagless) subparser (ADVICE r3)
    sub.add_parser(
        "bench", add_help=False,
        help="run the metric-of-record benchmark; all flags are "
             "forwarded to bench.py (--backend/--n-ray/--steps/--grad/"
             "--help/...)")
    # bench flags are owned by bench.py: parse only our args and forward
    # the rest (argparse.REMAINDER mis-handles leading optionals, bpo-17050)
    args, extra = ap.parse_known_args(argv)

    if args.cmd == "bench":
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        sys.path.insert(0, root)
        import bench

        bench.cli(extra)
        return
    if extra:
        # error against the run subparser so the message carries its usage
        # and flag suggestions, not the bare top-level usage (ADVICE r3)
        runp.error(f"unrecognized arguments: {' '.join(extra)}")

    spec = _load_config(args)
    result = run_experiment(
        spec, args.out, make_plot=not args.no_plot,
        log_every=args.log_every, resume_from=args.resume,
        stream_history=args.stream_history, shard=args.shard,
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
