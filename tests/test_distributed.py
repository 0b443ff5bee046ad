"""Multi-host (multi-process) path: 2 CPU processes × 2 devices each,
gloo cross-process collectives, driving a real sharded model step through
``parallel.distributed`` — and matching the single-process answer
(the multi-host code path must be executed, not just shipped)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import msgwam_tpu as mt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, sys
pid = int(sys.argv[1]); port = sys.argv[2]
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, %(repo)r)
from msgwam_tpu.parallel.distributed import initialize, global_mesh, \
    make_global_sharded
initialize(coordinator_address="127.0.0.1:" + port,
           num_processes=2, process_id=pid)
initialize()  # idempotent: second call is a no-op via is_initialized()

import numpy as np
import jax.numpy as jnp
import msgwam_tpu as mt
from msgwam_tpu.parallel.sharding import (
    build_sharded_simulate_fn, ray_sharding_specs,
)

assert jax.device_count() == 4 and jax.local_device_count() == 2
mesh = global_mesh((4,), ("rays",))

cfg = mt.REFERENCE_RUN_CONFIG
gc = mt.GridConfig()
centers = gc.centers()
uu = np.asarray(mt.velocities_sine_homogeneous(jnp.asarray(centers), cfg))
vv = np.zeros_like(uu)
bg = mt.make_background(gc, cfg, uu, vv)
rays, statics = mt.wave_packet_ic(gc, cfg, bg, n_ray=16)
state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.asarray(vv)))

state_spec, statics_spec = ray_sharding_specs()
g_state = make_global_sharded(mesh, state_spec, jax.tree.map(np.asarray, state))
g_statics = make_global_sharded(mesh, statics_spec,
                                jax.tree.map(np.asarray, statics))

run = mt.RunConfig(dt=120.0, n_steps=5, save_every=5)
fn = build_sharded_simulate_fn(mesh, cfg, run)
final, _, hist = fn(g_state, g_statics, bg)
u = np.asarray(final.mean.u)  # replicated -> addressable on every process
if pid == 0:
    print("RESULT " + json.dumps(u.tolist()), flush=True)
""" % {"repo": REPO}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_sharded_step_matches_single_process(tmp_path):
    port = str(_free_port())
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers configure their own devices

    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), port],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
    result_lines = [l for l in outs[0][0].splitlines() if l.startswith("RESULT ")]
    assert result_lines, f"no RESULT from process 0:\n{outs[0][0]}"
    u_multi = np.array(json.loads(result_lines[0][len("RESULT "):]))

    # single-process oracle, same tiny run
    cfg = mt.REFERENCE_RUN_CONFIG
    gc = mt.GridConfig()
    centers = gc.centers()
    uu = np.asarray(mt.velocities_sine_homogeneous(jnp.asarray(centers), cfg))
    vv = np.zeros_like(uu)
    bg = mt.make_background(gc, cfg, uu, vv)
    rays, statics = mt.wave_packet_ic(gc, cfg, bg, n_ray=16)
    state = mt.State(rays, mt.MeanState(jnp.asarray(uu), jnp.asarray(vv)))
    run = mt.RunConfig(dt=120.0, n_steps=5, save_every=5)
    final, _, _ = jax.jit(
        lambda s, st: mt.simulate(s, st, bg, cfg, run)
    )(state, statics)
    np.testing.assert_allclose(u_multi, np.asarray(final.mean.u),
                               rtol=1e-12, atol=1e-15)
