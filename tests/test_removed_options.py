"""Options of the removed whole-run and fused-RHS kernels fail with a clear
message instead of running something else or failing deep inside JAX."""

import argparse
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config_file(tmp_path, spec):
    p = tmp_path / "exp.json"
    p.write_text(json.dumps(spec))
    return str(p)


def _load(tmp_path, spec):
    from msgwam_tpu.cli import _load_config

    return _load_config(argparse.Namespace(
        config=_config_file(tmp_path, spec), preset="reference", steps=None))


def _model_key(key, value):
    def case(tmp_path):
        from msgwam_tpu.cli import _model_config

        spec = _load(tmp_path, {"model": {key: value}, "run": {}})
        _model_config(spec, "float32")
    return case, ValueError, "no longer exists"


def _kernels_in_file(name):
    def case(tmp_path):
        _load(tmp_path, {"kernels": name, "model": {}, "run": {}})
    return case, ValueError, "unknown kernels choice"


def _cli(argv):
    def case(tmp_path):
        from msgwam_tpu import cli

        cli.main(argv)
    return case, SystemExit, None


def _bench_cli(argv):
    def case(tmp_path):
        sys.path.insert(0, REPO)
        import bench

        bench.cli(argv)
    return case, SystemExit, None


def _bench_run_one(tmp_path):
    sys.path.insert(0, REPO)
    import bench

    bench.run_one(n_ray=64, n_steps=1, backend="mega")


def _projection_backend(tmp_path):
    from msgwam_tpu.ops.projection import project_backend

    project_backend("pallas")


def _config_field(tmp_path):
    from msgwam_tpu import ModelConfig

    ModelConfig(rhs_backend="pallas")


def _ensemble_backend(tmp_path):
    import msgwam_tpu as mt
    from msgwam_tpu.parallel import ensemble_simulate

    ensemble_simulate(None, None, None, mt.ModelConfig(), mt.RunConfig(),
                      backend="mega")


CASES = {
    "model_rhs_backend": _model_key("rhs_backend", "pallas"),
    "model_window_cells": _model_key("window_cells", 24),
    "model_window_cells2": _model_key("window_cells2", 96),
    "file_kernels_mega": _kernels_in_file("mega"),
    "file_kernels_windowed": _kernels_in_file("windowed"),
    "file_kernels_pallas": _kernels_in_file("pallas"),
    "cli_kernels_mega": _cli(["run", "--kernels", "mega", "--no-plot"]),
    "cli_window2": _cli(["run", "--window2", "24", "--no-plot"]),
    "bench_backend_mega": _bench_cli(["--backend", "mega"]),
    "bench_backend_pallasw": _bench_cli(["--backend", "pallasw"]),
    "bench_matrix": _bench_cli(["--matrix"]),
    "bench_run_one_mega": (_bench_run_one, ValueError, "unknown backend"),
    "projection_backend_pallas": (_projection_backend, ValueError,
                                  "unknown projection backend"),
    "config_rhs_backend": (_config_field, TypeError, "rhs_backend"),
    "ensemble_backend_mega": (_ensemble_backend, TypeError, "backend"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_removed_option_fails_clearly(name, tmp_path, capsys):
    case, exc, match = CASES[name]
    with pytest.raises(exc, match=match) as info:
        case(tmp_path)
    if exc is SystemExit:
        # argparse refuses the flag or value by name, before any run
        assert info.value.code == 2
        err = capsys.readouterr().err
        assert "invalid choice" in err or "unrecognized arguments" in err
