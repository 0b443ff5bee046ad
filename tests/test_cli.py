"""The config-file CLI driver end to end (CPU, tiny runs)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra=None, **kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu", MPLBACKEND="Agg")
    if env_extra:
        env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-m", "msgwam_tpu"] + args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600, **kw,
    )


def test_run_preset_and_resume(tmp_path):
    out1 = tmp_path / "a"
    r = _run(["run", "--preset", "reference", "--steps", "20",
              "--out", str(out1), "--no-plot"])
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert os.path.exists(result["checkpoint"])
    d = np.load(out1 / "diagnostics.npz")
    assert d["wave_action"].shape[1] == 100
    assert np.all(np.isfinite(d["wave_action"]))

    out2 = tmp_path / "b"
    r2 = _run(["run", "--preset", "reference", "--steps", "10",
               "--out", str(out2), "--no-plot",
               "--resume", str(out1 / "final_state.npz")])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed" in r2.stdout


def test_run_json_config(tmp_path):
    spec = {
        "model": {"u0": 4.0, "phi0": 0.0, "kappa": 1.0, "hprop": False,
                  "saturate_online": True, "rr0": 40000.0,
                  "projection_backend": "mxu", "interp_backend": "mxu"},
        "grid": {"n_face": 101, "z_max": 100e3},
        "run": {"dt": 120.0, "n_steps": 10, "save_every": 5},
        "source": {"kind": "gaussian_spectrum", "n_ray": 100},
        "background": "tanh",
        "dtype": "float32",
    }
    cfg_path = tmp_path / "exp.json"
    cfg_path.write_text(json.dumps(spec))
    out = tmp_path / "out"
    r = _run(["run", "--config", str(cfg_path), "--out", str(out),
              "--no-plot", "--log-every", "5"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out / "diagnostics.npz").exists()


def test_steps_override_keeps_save_every_divisible():
    """--steps N picks the largest divisor of N <= the preset cadence
    (ADVICE r1: `--preset fast --steps 15` used to abort)."""
    import argparse
    from msgwam_tpu.cli import _load_config

    ns = argparse.Namespace(config=None, preset="fast", steps=15)
    spec = _load_config(ns)  # fast preset has save_every=10
    assert spec["run"]["n_steps"] == 15
    assert spec["run"]["save_every"] == 5
    ns = argparse.Namespace(config=None, preset="fast", steps=7)
    spec = _load_config(ns)
    assert spec["run"]["save_every"] == 7
    ns = argparse.Namespace(config=None, preset="reference", steps=13)
    spec = _load_config(ns)
    assert spec["run"]["save_every"] == 1


@pytest.mark.parametrize("kernels", ["xla", "mxu"])
def test_kernels_flag(tmp_path, kernels):
    """--kernels picks the scan path's backend pair through the CLI and
    produces finite diagnostics."""
    out = tmp_path / "w"
    r = _run(["run", "--preset", "fast", "--steps", "4", "--out", str(out),
              "--no-plot", "--kernels", kernels])
    assert r.returncode == 0, r.stderr[-2000:]
    d = np.load(out / "diagnostics.npz")
    assert np.all(np.isfinite(d["wave_action"]))


def test_kernels_in_config_file_installs_backends():
    """A config FILE specifying "kernels" gets the same model-backend
    overrides as the --kernels flag."""
    import argparse
    import json as _json
    from msgwam_tpu.cli import _load_config

    def load(spec_dict, **args):
        import tempfile, os
        with tempfile.NamedTemporaryFile("w", suffix=".json",
                                         delete=False) as f:
            _json.dump(spec_dict, f)
            p = f.name
        try:
            ns = argparse.Namespace(config=p, preset="reference",
                                    steps=None, **args)
            return _load_config(ns)
        finally:
            os.unlink(p)

    base = {"model": {}, "grid": {}, "run": {"dt": 120.0, "n_steps": 4,
                                             "save_every": 4},
            "source": {"kind": "gaussian_spectrum", "n_ray": 64},
            "dtype": "float32"}

    spec = load({**base, "kernels": "mxu"})
    assert spec["model"]["projection_backend"] == "mxu"
    assert spec["model"]["interp_backend"] == "mxu"

    # file-set model keys win over the file-level kernels defaults...
    spec = load({**base, "kernels": "mxu",
                 "model": {"interp_backend": "gather"}})
    assert spec["model"]["interp_backend"] == "gather"
    assert spec["model"]["projection_backend"] == "mxu"

    # ...but the --kernels flag overrides the file's model block
    spec = load({**base, "model": {"projection_backend": "mxu"}},
                kernels="xla")
    assert spec["model"]["projection_backend"] == "xla"
    assert spec["model"]["interp_backend"] == "gather"


def test_shard_flag(tmp_path):
    """--shard splits the ray axis over the visible devices (8 virtual CPU
    devices here) and matches the unsharded run to f32 psum-reordering
    tolerance."""
    spec = {
        "model": {"u0": 4.0, "phi0": 0.0, "kappa": 1.0, "hprop": False,
                  "saturate_online": True, "rr0": 40000.0,
                  "projection_backend": "mxu", "interp_backend": "mxu"},
        "grid": {"n_face": 101, "z_max": 100e3},
        "run": {"dt": 120.0, "n_steps": 4, "save_every": 2},
        "source": {"kind": "gaussian_spectrum", "n_ray": 320},
        "background": "sine",
        "dtype": "float32",
    }
    cfg_path = tmp_path / "shard.json"
    cfg_path.write_text(json.dumps(spec))
    env8 = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    out = tmp_path / "s"
    r = _run(["run", "--config", str(cfg_path), "--out", str(out),
              "--no-plot", "--shard"], env_extra=env8)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "rays split over 8 device(s)" in r.stdout
    d = np.load(out / "diagnostics.npz")
    assert np.all(np.isfinite(d["wave_action"]))

    out2 = tmp_path / "u"
    r2 = _run(["run", "--config", str(cfg_path), "--out", str(out2),
               "--no-plot"], env_extra=env8)
    assert r2.returncode == 0, r2.stderr[-2000:]
    d2 = np.load(out2 / "diagnostics.npz")
    np.testing.assert_allclose(d["u"], d2["u"], atol=1e-4)
    np.testing.assert_allclose(d["wave_action"], d2["wave_action"],
                               rtol=1e-4, atol=1e-12)

    # indivisible ray count: clear error, not a shard_map shape crash
    spec["source"]["n_ray"] = 321
    cfg_path.write_text(json.dumps(spec))
    r3 = _run(["run", "--config", str(cfg_path), "--out",
               str(tmp_path / "x"), "--no-plot", "--shard"],
              env_extra=env8)
    assert r3.returncode != 0
    assert "divisible by the device count" in (r3.stderr + r3.stdout)


def test_transient_background_tidal(tmp_path):
    """A JSON config can name a transient background:
    ``"background": {"kind": "tidal", ...}`` builds the wind_fn from
    cli.TRANSIENT_BACKGROUNDS, the run is finite, and the imposed mean
    wind in the history equals tidal_shear at the frame times."""
    spec = {
        "model": {"u0": 4.0, "phi0": 0.0, "kappa": 1.0, "hprop": False,
                  "saturate_online": True, "rr0": 40000.0,
                  "cull": True, "relaunch": True, "prognostic_mean": False,
                  "projection_backend": "mxu", "interp_backend": "mxu"},
        "grid": {"n_face": 101, "z_max": 100e3},
        "run": {"dt": 120.0, "n_steps": 6, "save_every": 2},
        "source": {"kind": "gaussian_spectrum", "n_ray": 300},
        "background": {"kind": "tidal", "period": 43200.0,
                       "lambda_z": 30000.0},
        "dtype": "float32",
    }
    cfg_path = tmp_path / "tidal.json"
    cfg_path.write_text(json.dumps(spec))
    out = tmp_path / "t"
    r = _run(["run", "--config", str(cfg_path), "--out", str(out),
              "--no-plot"])
    assert r.returncode == 0, r.stderr[-2000:]
    d = np.load(out / "diagnostics.npz")
    assert np.all(np.isfinite(d["wave_action"]))

    # the imposed wind is overwritten from wind_fn at each saved frame's
    # step start: frame j covers step (j+1)*save_every, whose last inner
    # step starts at t = ((j+1)*save_every - 1) * dt
    import jax.numpy as jnp
    from msgwam_tpu import GridConfig, ModelConfig
    from msgwam_tpu.models.backgrounds import tidal_shear

    cfg = ModelConfig(dtype="float32", **spec["model"])
    centers = jnp.asarray(GridConfig().centers(), jnp.float32)
    for j, t_frame in enumerate(d["time"]):
        expect = np.asarray(tidal_shear(
            centers, jnp.float32(t_frame - spec["run"]["dt"]), cfg))
        np.testing.assert_allclose(d["u"][j], expect, rtol=1e-5, atol=1e-6)

    # --log-every host-chunks the run; the wind phase must CONTINUE
    # across chunks (a closed-over t0 would restart the tide per chunk)
    out2 = tmp_path / "t_chunked"
    r = _run(["run", "--config", str(cfg_path), "--out", str(out2),
              "--no-plot", "--log-every", "2"])
    assert r.returncode == 0, r.stderr[-2000:]
    d2 = np.load(out2 / "diagnostics.npz")
    np.testing.assert_array_equal(d["u"], d2["u"])
    np.testing.assert_array_equal(d["wave_action"], d2["wave_action"])


def test_transient_background_resume_continuity(tmp_path):
    """Resuming a tidal run threads t0 into the wind phase: 3+3 steps via
    --resume reproduces a straight 6-step run bit-for-bit."""
    spec = {
        "model": {"u0": 4.0, "phi0": 0.0, "kappa": 1.0, "hprop": False,
                  "saturate_online": True, "rr0": 40000.0,
                  "prognostic_mean": False,
                  "projection_backend": "mxu", "interp_backend": "mxu"},
        "grid": {"n_face": 101, "z_max": 100e3},
        "run": {"dt": 120.0, "n_steps": 6, "save_every": 3},
        "source": {"kind": "gaussian_spectrum", "n_ray": 200},
        "background": {"kind": "tidal"},
        "dtype": "float32",
    }
    cfg_path = tmp_path / "tidal6.json"
    cfg_path.write_text(json.dumps(spec))
    out_full = tmp_path / "full"
    r = _run(["run", "--config", str(cfg_path), "--out", str(out_full),
              "--no-plot"])
    assert r.returncode == 0, r.stderr[-2000:]

    out_a = tmp_path / "a"
    r = _run(["run", "--config", str(cfg_path), "--out", str(out_a),
              "--no-plot", "--steps", "3"])
    assert r.returncode == 0, r.stderr[-2000:]
    out_b = tmp_path / "b"
    r = _run(["run", "--config", str(cfg_path), "--out", str(out_b),
              "--no-plot", "--steps", "3",
              "--resume", str(out_a / "final_state.npz")])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed" in r.stdout

    full = np.load(out_full / "final_state.npz")
    split = np.load(out_b / "final_state.npz")
    for key in ("rays.dens", "rays.r", "rays.m", "mean.u"):
        np.testing.assert_array_equal(full[key], split[key])


def test_transient_background_rejects_shard_and_unknown(tmp_path):
    """--shard with a transient background is a clear error; so is an
    unknown kind."""
    spec = {
        "model": {"u0": 4.0, "phi0": 0.0, "saturate_online": True,
                  "prognostic_mean": False},
        "grid": {"n_face": 101, "z_max": 100e3},
        "run": {"dt": 120.0, "n_steps": 2, "save_every": 1},
        "source": {"kind": "gaussian_spectrum", "n_ray": 160},
        "background": {"kind": "tidal"},
        "dtype": "float32",
    }
    cfg_path = tmp_path / "ts.json"
    cfg_path.write_text(json.dumps(spec))
    r = _run(["run", "--config", str(cfg_path), "--out",
              str(tmp_path / "o"), "--no-plot", "--shard"],
             env_extra={"XLA_FLAGS":
                        "--xla_force_host_platform_device_count=8"})
    assert r.returncode != 0
    assert "transient backgrounds" in (r.stderr + r.stdout)

    spec["background"] = {"kind": "nope"}
    cfg_path.write_text(json.dumps(spec))
    r = _run(["run", "--config", str(cfg_path), "--out",
              str(tmp_path / "o2"), "--no-plot"])
    assert r.returncode != 0
    assert "unknown transient background" in (r.stderr + r.stdout)


def test_missing_matplotlib_fails_before_the_run(tmp_path, monkeypatch):
    """Without matplotlib, a plotting run stops before any compute with a
    hint to pass --no-plot."""
    import importlib.util

    from msgwam_tpu import cli

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))
    monkeypatch.setattr(cli, "setup_experiment",
                        lambda spec: pytest.fail("the run started"))
    with pytest.raises(RuntimeError, match="--no-plot"):
        cli.run_experiment(cli.PRESETS["reference"], str(tmp_path / "o"))
