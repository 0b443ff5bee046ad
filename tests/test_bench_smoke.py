"""bench.py and __graft_entry__ stay importable and runnable (tiny sizes,
CPU) — guards the driver-facing entry points in CI."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench():
    sys.path.insert(0, REPO)
    import bench

    return bench


def test_bench_main_tiny():
    """run_one is a library function: it runs the scan path on whatever
    device JAX has (the CPU here) and returns the result line."""
    payload = _bench().run_one(n_ray=512, n_steps=5)
    json.dumps(payload)
    assert {"metric", "value", "unit", "vs_baseline", "device"} <= set(payload)
    assert payload["value"] > 0


@pytest.mark.parametrize("kind", ["mxu", "xla", "grad"])
def test_bench_result_names_device(kind):
    """Every result names the platform, device kind and device count it
    ran on, so a CPU number can never pass for a GPU one."""
    import jax

    bench = _bench()
    if kind == "grad":
        payload = bench.run_grad(n_ray=256, n_steps=4)
    else:
        payload = bench.run_one(n_ray=256, n_steps=3, backend=kind)
    d = jax.devices()[0]
    assert payload["device"] == {"platform": d.platform,
                                 "kind": d.device_kind,
                                 "count": len(jax.devices())}
    assert payload["device"]["platform"] == "cpu"
    assert kind in payload["metric"]


def test_graft_entry_single_chip():
    import jax

    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    state, statics = out
    assert state.rays.dens.shape == args[0].rays.dens.shape


def test_graft_dryrun_subprocess():
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "dryrun_multichip OK" in r.stdout


def test_bench_subcommand_forwards_flags():
    """`python -m msgwam_tpu bench <flags>` forwards the flags to
    bench.cli, which refuses to measure without a GPU; unknown `run` flags
    still error."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "msgwam_tpu", "bench",
         "--n-ray", "512", "--steps", "5", "--backend", "mxu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "measures the GPU" in r.stderr
    assert '"value"' not in r.stdout

    # --help reaches bench.py's own parser
    rh = subprocess.run(
        [sys.executable, "-m", "msgwam_tpu", "bench", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert rh.returncode == 0, rh.stderr[-2000:]
    assert "--n-ray" in rh.stdout and "--grad" in rh.stdout

    r2 = subprocess.run(
        [sys.executable, "-m", "msgwam_tpu", "run", "--bogus-flag"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r2.returncode != 0
    assert "unrecognized arguments" in r2.stderr
