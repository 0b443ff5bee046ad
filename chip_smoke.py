"""End-to-end smoke test of the ray tracer on NVIDIA GPUs, through the
entry points a user calls.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # four cards: sharded run + ensemble

One card runs, in one process:

  fast_day        the ``fast`` preset (1e5 f32 rays, one simulated day)
                  through ``cli.run_experiment``: compile time, wall time,
                  ray-steps/s and peak device memory;
  fast_vs_parity  the f32 fast path (dense ``mxu`` backends, compensated
                  deposit) against the f64 parity path (``xla``/``gather``)
                  on the card: the deposit of the day's final state must be
                  within 1e-6 rel-to-max, and a 20-step run within the bound
                  that float32 arithmetic itself sets (see ``fast_vs_parity``);
  reference_f64   the ``reference`` preset in f64 on the GPU against the same
                  run on the host CPU: flux profile within 1e-8 rel-to-max
                  after one simulated day, 1e-7 after the full run;
  gradient        ``jax.grad`` through 100 coupled steps at 1e5 rays, f32
                  fast path against f64 parity path, both on the card;
  scan_timing     ms per step of both backend pairs at 1e5 and 1e6 rays,
                  and device kernels per step from a ``jax.profiler`` trace.

``--four-cards`` runs only: the ``fast`` preset sharded over the ray axis
of four cards against the same run on one card, and a four-member
ensemble on an ``('ensemble',)`` mesh of four cards against each member
run alone.

Any failed phase ends the script with a non-zero exit and no result line.
The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card's name and power limit from ``nvidia-smi``.
Without a GPU the script exits non-zero before any phase.  Outputs go to
``results/chip_smoke/`` in the checkout.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import bench  # noqa: E402  (sets XLA_FLAGS before the backend starts)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import msgwam_tpu as mt  # noqa: E402
from msgwam_tpu import cli  # noqa: E402
from msgwam_tpu.diagnostics import pseudo_momentum_flux  # noqa: E402
from msgwam_tpu.ops.projection import required_span  # noqa: E402
from msgwam_tpu.parallel import ensemble_simulate, stack_ensemble  # noqa: E402
from msgwam_tpu.utils.checkpoint import load_checkpoint  # noqa: E402
from msgwam_tpu.utils.xla import enable_persistent_compile_cache  # noqa: E402
OUT = os.path.join(REPO, "results", "chip_smoke")

# fast_vs_parity: steps of the short trajectory comparison
SHORT_STEPS = 20
# gradient: rays and steps of the jax.grad comparison
GRAD_RAYS = 100_000
GRAD_STEPS = 100
# scan_timing: (rays, steps) per timed run, and the traced window
TIMING = ((100_000, 100), (1_000_000, 50))
TRACE_STEPS = 20

DEPOSIT_TOL = 1e-6      # the north-star deposit bar against f64
REFERENCE_DAY_TOL = 1e-8  # f64 GPU vs f64 CPU, one simulated day
REFERENCE_TOL = 1e-7      # f64 GPU vs f64 CPU, the full two-day run
GRAD_MAX_TOL = 1.0        # f32 fast vs f64 parity gradient, rel-to-max
GRAD_L2_TOL = 0.1         # the same, relative L2


def nvidia_smi() -> str:
    """The card's name and power limit, from a child that stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0].strip()


class Smoke:
    """Shared state of one smoke run: the card tag and what phases pass on."""

    def __init__(self, card: str):
        self.card = card
        self.fast_checkpoint = None

    def report(self, name, value, unit=""):
        print(f"{name}: {value!r} {unit}  [{self.card}]", flush=True)

    def check(self, name, value, tol, reason):
        ok = bool(value < tol)
        print(f"{name}: {value!r} (tolerance {tol!r}: {reason}) "
              f"{'ok' if ok else 'FAIL'}  [{self.card}]", flush=True)
        if not ok:
            raise RuntimeError(f"{name} = {value!r} exceeds {tol!r}")


def rel_to_max(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def to64(tree):
    return jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float64)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


def _parity_cfg(cfg, state, dz):
    """The f64 parity configuration for ``cfg`` (the ``xla`` kernels pair),
    with the deposit span raised to the widest ray volume."""
    c = cfg.replace(dtype="float64", **cli.KERNELS["xla"])
    need = required_span(float(jnp.max(state.rays.dr)), dz)
    return c.replace(max_span=max(c.max_span, need))


def _spec(name, **run):
    spec = json.loads(json.dumps(cli.PRESETS[name]))
    spec["run"].update(run)
    return spec


def _finite(name, *arrays):
    for a in arrays:
        if not np.all(np.isfinite(np.asarray(a))):
            raise FloatingPointError(f"{name}: non-finite values")


# --- one card -------------------------------------------------------------

def phase_fast_day(smoke: Smoke):
    """The ``fast`` preset through ``cli.run_experiment``, twice: the first
    call compiles, the second finds the persistent compile cache."""
    spec = _spec("fast")
    out = os.path.join(OUT, "fast")
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = cli.run_experiment(spec, out, make_plot=False)
        walls.append(time.perf_counter() - t0)
    n_ray = spec["source"]["n_ray"]
    n_steps = spec["run"]["n_steps"]
    d = np.load(os.path.join(out, "diagnostics.npz"))
    frames = n_steps // spec["run"]["save_every"]
    if d["u"].shape != (frames, 100) or d["wave_action"].shape != (frames, 100):
        raise RuntimeError(f"fast day: unexpected shapes {d['u'].shape}")
    _finite("fast day diagnostics", d["u"], d["wave_action"], d["flux"])
    smoke.report("fast day wall, first call (compile + run)", walls[0], "s")
    smoke.report("fast day wall, second call (run)", walls[1], "s")
    smoke.report("fast day compile time (first - second call)",
                 walls[0] - walls[1], "s")
    smoke.report("fast day ray-steps/s (second call)",
                 n_ray * n_steps / walls[1], "ray-steps/s")
    stats = jax.devices()[0].memory_stats() or {}
    smoke.report("peak_bytes_in_use after the fast day",
                 stats.get("peak_bytes_in_use", "not reported"), "bytes")
    smoke.fast_checkpoint = res["checkpoint"]


def phase_fast_vs_parity(smoke: Smoke):
    """Deposit of the day's final state, and a 20-step trajectory, f32
    fast path against f64 parity path on the same (upcast) inputs."""
    jax.config.update("jax_enable_x64", True)
    exp = cli.setup_experiment(_spec("fast"))
    cfg, bg = exp.cfg, exp.bg
    cfg64 = _parity_cfg(cfg, exp.state, exp.grid.dz)

    state, statics = load_checkpoint(smoke.fast_checkpoint)[:2]
    pm32 = jax.jit(pseudo_momentum_flux, static_argnums=3)(
        state.rays, statics, bg, cfg)
    pm64 = jax.jit(pseudo_momentum_flux, static_argnums=3)(
        to64(state.rays), to64(statics), to64(bg), cfg64)
    _finite("deposit", pm32, pm64)
    smoke.check("deposit rel-to-max error, f32 fast vs f64 parity, "
                f"{state.rays.dens.shape[0]} rays",
                rel_to_max(pm32, pm64), DEPOSIT_TOL,
                "north-star bar; TF32 contractions would miss it")

    run = mt.RunConfig(dt=exp.run.dt, n_steps=SHORT_STEPS,
                       save_every=SHORT_STEPS)
    sim = jax.jit(lambda s, st, b, c: mt.simulate(s, st, b, c, run)[0],
                  static_argnums=3)
    s0, st0 = exp.state, exp.statics
    u0 = np.asarray(s0.mean.u, np.float64)
    fast = sim(s0, st0, bg, cfg)
    slow = sim(to64(s0), to64(st0), to64(bg), cfg64)
    # what float32 arithmetic alone costs: the parity backends in float32
    f32 = sim(s0, st0, bg, cfg64.replace(dtype="float32"))
    _finite("short run", fast.mean.u, slow.mean.u, f32.mean.u)
    for name, get in (("wind increment", lambda x: np.asarray(
                          x.mean.u, np.float64) - u0),
                      ("ray heights", lambda x: x.rays.r)):
        spread = rel_to_max(get(f32), get(slow))
        smoke.report(f"{SHORT_STEPS}-step {name}: f32 parity backends vs "
                     "f64 rel-to-max", spread)
        smoke.check(f"{SHORT_STEPS}-step {name}: f32 fast vs f64 parity "
                    "rel-to-max", rel_to_max(get(fast), get(slow)),
                    3.0 * max(spread, 1e-6),
                    "3x what float32 arithmetic alone makes (saturation "
                    "clamps amplify rounding chaotically)")


def phase_reference_f64(smoke: Smoke):
    """The ``reference`` preset in f64 on the GPU and on the host CPU, in
    this process: flux profile of the final state, rel-to-max, after one
    simulated day and after the full two-day run.

    The two devices round a few operations differently (the GPU's deposit
    is a scatter-add whose atomics sum in no fixed order), ~1e-15 at step
    10.  The saturation clamps amplify that chaotically: ~1e-11 after 800
    steps, then 1.6e-8 to 3.1e-8 at step 1440 on H100s, where two GPU runs
    of the same program already differ by 1.2e-8.  So the day is held to
    the CPU's regression level against NumPy, 1e-8, and the full run to
    1e-7."""
    cpu = jax.devices("cpu")[0]
    for n_steps, tol in ((720, REFERENCE_DAY_TOL), (1440, REFERENCE_TOL)):
        spec = _spec("reference", n_steps=n_steps)
        out = {}
        t0 = time.perf_counter()
        out["gpu"] = cli.run_experiment(
            spec, os.path.join(OUT, f"ref{n_steps}_gpu"), make_plot=False)
        smoke.report(f"reference preset, {n_steps} steps, wall on the GPU "
                     "(compile + run)", time.perf_counter() - t0, "s")
        with jax.default_device(cpu):
            out["cpu"] = cli.run_experiment(
                spec, os.path.join(OUT, f"ref{n_steps}_cpu"), make_plot=False)
            exp = cli.setup_experiment(spec)
            flux = {}
            for dev, res in out.items():
                state, statics = load_checkpoint(res["checkpoint"])[:2]
                flux[dev] = np.asarray(pseudo_momentum_flux(
                    state.rays, statics, exp.bg, exp.cfg))
        _finite("reference flux", *flux.values())
        d = {dev: np.load(os.path.join(OUT, f"ref{n_steps}_{dev}",
                                       "diagnostics.npz")) for dev in out}
        smoke.report(f"reference, {n_steps} steps: wind history, GPU vs CPU "
                     "rel-to-max", rel_to_max(d["gpu"]["u"], d["cpu"]["u"]))
        smoke.check(f"reference, {n_steps} steps: flux profile, f64 GPU vs "
                    "f64 CPU rel-to-max", rel_to_max(flux["gpu"], flux["cpu"]),
                    tol, "see phase_reference_f64: rounding order amplified "
                    "chaotically by the saturation clamps")


def phase_gradient(smoke: Smoke):
    """``jax.grad`` of bench's adjoint loss through 100 steps at 1e5 rays:
    f32 fast path against f64 parity path, both on the card, at bounded
    forcing (``grad_setup(alpha_scale=0.1)``, bench's long-horizon
    setting).  At the default forcing the adjoint of the saturation-coupled
    run grows ~2x per step after breaking sets in, and float32 rounding
    alone then moves the 100-step gradient by 100% (measured on an H100)."""
    jax.config.update("jax_enable_x64", True)
    cfg, bg, state, statics = bench.grad_setup(GRAD_RAYS, alpha_scale=0.1)
    cfg64 = _parity_cfg(cfg, state, mt.GridConfig().dz)

    def grad(c, b, s, st):
        loss = bench.grad_loss(c, b, s, st, GRAD_STEPS)
        return np.asarray(jax.jit(jax.grad(loss))(s.rays.dens), np.float64)

    g32 = grad(cfg, bg, state, statics)
    g64 = grad(cfg64, to64(bg), to64(state), to64(statics))
    g32p = grad(cfg64.replace(dtype="float32"), bg, state, statics)
    _finite("gradient", g32, g64, g32p)
    gmax = float(np.max(np.abs(g32)))
    if gmax == 0.0:
        raise RuntimeError("gradient is identically zero")
    smoke.report(f"gradient max |g| ({GRAD_RAYS} rays, {GRAD_STEPS} steps, "
                 "alpha_scale 0.1)", gmax)
    rel_l2 = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for name, err, tol in (("rel-to-max", rel_to_max, GRAD_MAX_TOL),
                           ("relative L2", rel_l2, GRAD_L2_TOL)):
        smoke.report(f"gradient {name}, f32 parity backends vs f64",
                     err(g32p, g64))
        smoke.check(f"gradient {name}, f32 fast vs f64 parity",
                    err(g32, g64), tol,
                    "float32 rounding through 100 linearized steps moves "
                    "a few rays' gradients by tens of per cent on either "
                    "backend pair (measured 0.22-0.36 rel-to-max, "
                    "0.013-0.024 relative L2); a wrong gradient is O(1)")


def _kernels_per_step(fn, args, n_steps, log_dir):
    """Device events per step in one ``jax.profiler`` trace of ``fn``."""
    jax.block_until_ready(fn(*args))  # compile outside the trace
    jax.profiler.start_trace(log_dir)
    try:
        jax.block_until_ready(fn(*args))
    finally:
        jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    lines = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines[f"{plane.name} | {line.name}"] = sum(1 for _ in line.events)
    return lines


def phase_scan_timing(smoke: Smoke):
    """ms per step of both backend pairs (what XLA compiles of the scan
    path), and device events per step from one trace."""
    for n_ray, n_steps in TIMING:
        for backend, accum in (("xla", "native"), ("mxu", "compensated")):
            r = bench.run_one(n_ray, n_steps, backend, accum)
            smoke.report(f"scan path {backend}+{accum} at {n_ray} rays "
                         f"({n_steps}-step runs, best of 3)",
                         1e3 * r["seconds"] / n_steps, "ms/step")
    for backend, accum in (("xla", "native"), ("mxu", "compensated")):
        cfg, bg, state, statics = bench._setup(TIMING[0][0], backend, accum)
        run = mt.RunConfig(dt=bench.DT, n_steps=TRACE_STEPS,
                           save_every=TRACE_STEPS)
        fn = jax.jit(lambda s, st: mt.simulate(s, st, bg, cfg, run)[0])
        lines = _kernels_per_step(
            fn, (state, statics), TRACE_STEPS,
            os.path.join(OUT, f"trace_{backend}"))
        for name, count in sorted(lines.items()):
            smoke.report(f"trace {backend} at {TIMING[0][0]} rays: {name}: "
                         f"events per step", count / TRACE_STEPS)


# --- four cards -----------------------------------------------------------

def _compare_histories(smoke, what, u_a, u_b, u0, save_every,
                       wa_a=None, wa_b=None):
    """Two runs of one configuration whose only difference is the order of
    float32 sums.  Over the first ``EARLY_STEPS`` steps the wind increments
    agree to rounding.  After that the saturation clamps amplify rounding
    chaotically (a ray within rounding of its threshold clamps in one run
    and not the other; on the CPU rehearsal even the day-mean wind of two
    such runs differs by ~10%), so the whole day is reported, not bounded."""
    early = EARLY_STEPS // save_every
    smoke.check(f"{what}: wind increment over the first {EARLY_STEPS} steps, "
                "rel-to-max", rel_to_max(u_a[:early] - u0, u_b[:early] - u0),
                EARLY_TOL, "float32 sums in another order, before the "
                "saturation clamps amplify them; a lost or doubled deposit "
                "would be O(1)")
    smoke.report(f"{what}: wind over the whole day, rel-to-max (chaotic "
                 "divergence, reported)", rel_to_max(u_a, u_b))
    if wa_a is not None:
        smoke.report(f"{what}: column wave action per frame, max relative "
                     "difference (reported)", float(np.max(
                         np.abs(wa_a.sum(1) - wa_b.sum(1))
                         / np.abs(wa_b.sum(1)))))


def phase_sharded_fast_day(smoke: Smoke):
    """The ``fast`` preset with its rays sharded over four cards against
    the same run on one card, in this process."""
    spec = _spec("fast")
    t0 = time.perf_counter()
    cli.run_experiment(spec, os.path.join(OUT, "shard4"), make_plot=False,
                       shard=True)
    smoke.report("sharded fast day wall over 4 cards (compile + run)",
                 time.perf_counter() - t0, "s")
    t0 = time.perf_counter()
    cli.run_experiment(spec, os.path.join(OUT, "shard1"), make_plot=False)
    smoke.report("fast day wall on one card (compile + run)",
                 time.perf_counter() - t0, "s")
    d4 = np.load(os.path.join(OUT, "shard4", "diagnostics.npz"))
    d1 = np.load(os.path.join(OUT, "shard1", "diagnostics.npz"))
    _finite("sharded day", d4["u"], d4["wave_action"])
    u0 = np.asarray(cli.setup_experiment(spec).state.mean.u, np.float64)
    _compare_histories(smoke, "sharded over 4 cards vs one card",
                       d4["u"].astype(np.float64), d1["u"], u0,
                       spec["run"]["save_every"],
                       d4["wave_action"], d1["wave_action"])


def phase_ensemble_members(smoke: Smoke):
    """Four ``fast``-preset members (stochastic sources) on an
    ``('ensemble',)`` mesh of four cards, against each member run alone."""
    spec = _spec("fast")
    exp = cli.setup_experiment(spec)
    src = dict(spec["source"])
    src.pop("kind")
    n_ray = src.pop("n_ray")
    members = []
    for e in range(4):
        rays, statics = mt.gaussian_spectrum_source(
            exp.cfg, exp.bg, n_ray, key=jax.random.PRNGKey(e),
            dtype=exp.state.rays.dens.dtype, **src)
        members.append((mt.State(rays, exp.state.mean), statics))
    states, statics = stack_ensemble(members)
    mesh = jax.make_mesh((4,), ("ensemble",), devices=jax.devices()[:4])
    t0 = time.perf_counter()
    hist = ensemble_simulate(states, statics, exp.bg, exp.cfg, exp.run,
                             mesh=mesh)[2]
    u_ens = np.asarray(jax.device_get(hist.u), np.float64)
    smoke.report("4-member ensemble wall over 4 cards (compile + run)",
                 time.perf_counter() - t0, "s")
    _finite("ensemble", u_ens)
    sim = jax.jit(lambda s, st: mt.simulate(
        s, st, exp.bg, exp.cfg, exp.run,
        observe=lambda s_, st_, aux: s_.mean.u)[2])
    u0 = np.asarray(exp.state.mean.u, np.float64)
    for e, (s, st) in enumerate(members):
        _compare_histories(smoke, f"ensemble member {e} vs alone",
                           u_ens[e], np.asarray(sim(s, st), np.float64), u0,
                           exp.run.save_every)


# four-card comparisons (see _compare_histories)
EARLY_STEPS = 20
EARLY_TOL = 1e-4

ONE_CARD = (("fast_day", phase_fast_day),
            ("fast_vs_parity", phase_fast_vs_parity),
            ("reference_f64", phase_reference_f64),
            ("gradient", phase_gradient),
            ("scan_timing", phase_scan_timing))
FOUR_CARDS = (("sharded_fast_day", phase_sharded_fast_day),
              ("ensemble_members", phase_ensemble_members))


def select_phases(four_cards: bool):
    return FOUR_CARDS if four_cards else ONE_CARD


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def require_gpu(n_cards: int):
    """JAX's devices, or a non-zero exit unless ``n_cards`` GPUs are there."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX's default device is "
                         f"{devices[0].platform!r}, not a GPU")
    if len(devices) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, JAX sees "
                         f"{len(devices)}")
    return devices


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phases")
    args = ap.parse_args(argv)

    devices = require_gpu(4 if args.four_cards else 1)
    card = nvidia_smi()
    print(f"card: {card}; device_kind {devices[0].device_kind}; "
          f"{len(devices)} device(s); jax {jax.__version__}", flush=True)

    print(f"compile cache: {enable_persistent_compile_cache()}", flush=True)
    os.makedirs(OUT, exist_ok=True)
    smoke = Smoke(card)
    for name, phase in select_phases(args.four_cards):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        phase(smoke)
        print(f"== phase {name} done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(card)
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
