"""Utility coverage: metrics logger, plotting smoke, profiling timer."""

import json
import logging
import os

import numpy as np
import pytest

from msgwam_tpu.utils.metrics import MetricsLogger
from msgwam_tpu.utils.profiling import StepTimer


def test_metrics_logger_cadence_and_jsonl(tmp_path, caplog):
    path = tmp_path / "metrics.jsonl"
    logger = MetricsLogger(100, every=25, jsonl_path=str(path))
    with caplog.at_level(logging.INFO, logger="msgwam_tpu"):
        for step in range(1, 101):
            logger.record(step, max_u=1.5 * step)
    logger.close()
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert [l["step"] for l in lines] == [25, 50, 75, 100]
    assert lines[-1]["progress"] == 1.0
    assert lines[0]["max_u"] == 1.5 * 25
    assert all("steps_per_sec" in l for l in lines)


def test_step_timer():
    t = StepTimer()
    for _ in range(3):
        t.start()
        t.stop()
    assert len(t.times) == 3
    assert t.best <= t.mean


def test_plotting_smoke(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    from msgwam_tpu.plotting import plot_wave_action_panels, plot_wind_evolution

    t = np.linspace(0, 86400, 20)
    z = np.linspace(500, 99500, 100)
    wa = np.random.rand(20, 100)
    tend = np.random.randn(20, 100) * 1e-3
    fig, ax = plot_wave_action_panels(
        t, z, wa, tend, show=False, save_path=tmp_path / "p.png"
    )
    assert (tmp_path / "p.png").exists()
    fig2, ax2 = plot_wind_evolution(
        t, z, np.random.randn(20, 100), show=False,
        save_path=tmp_path / "w.png",
    )
    assert (tmp_path / "w.png").exists()


@pytest.fixture()
def _restore_cache_config():
    import jax

    prev = jax.config.jax_compilation_cache_dir
    prev_min = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    jax.config.update("jax_compilation_cache_dir", prev)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", prev_min)


def test_persistent_compile_cache(tmp_path, monkeypatch, _restore_cache_config):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and nothing else
    is set in code; the directory is created."""
    import jax
    from msgwam_tpu.utils.xla import enable_persistent_compile_cache

    d = tmp_path / "xla-cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(d))
    assert enable_persistent_compile_cache() == str(d)
    assert d.is_dir()
    assert jax.config.jax_compilation_cache_dir == str(d)


@pytest.mark.parametrize("case", ["unset_default", "cpu_opt_out", "fixed_path"])
def test_compile_cache_default(case, monkeypatch, _restore_cache_config):
    """Unset, the cache directory is <repo>/.jax_cache (git-ignored), the
    CPU backend keeps the cache off, and the path holds no pid or time."""
    import jax
    from msgwam_tpu.utils import xla

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    if case == "unset_default":
        assert xla.compile_cache_dir() == want
        with open(os.path.join(repo, ".gitignore")) as f:
            ignored = {line.strip().strip("/") for line in f}
        assert ".jax_cache" in ignored, ".jax_cache must be git-ignored"
    elif case == "cpu_opt_out":
        before = jax.config.jax_compilation_cache_dir
        assert jax.default_backend() == "cpu"
        assert xla.enable_persistent_compile_cache() is None
        assert jax.config.jax_compilation_cache_dir == before
    else:
        # the same path on every call and in every process: the path is
        # part of the cache key
        assert xla.DEFAULT_COMPILE_CACHE_DIR == want
        assert str(os.getpid()) not in want
        assert xla.compile_cache_dir() == xla.compile_cache_dir()
