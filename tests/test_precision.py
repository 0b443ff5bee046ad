"""Every contraction on the device path runs at ``Precision.HIGHEST``.

On a GPU a float32 matrix product left at the default precision may run in
TF32, which keeps ~3 decimal digits — far outside the 1e-6 deposit bar.
The CPU ignores the setting, so the suite cannot see the numbers change;
it checks the jaxpr instead: one case per contraction site in
``ops/interp.py`` and ``ops/projection.py``, selected by the shape of its
result.
"""

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

from msgwam_tpu.ops import projection
from msgwam_tpu.ops.interp import _basis_interp_bwd, _basis_interp_raw

N, C, K = 9000, 100, 2  # N > ACCUM_BLOCK: blocked and remainder deposits


def _dot_generals(jaxpr):
    """Every dot_general equation in ``jaxpr`` and its sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out += _dot_generals(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out += _dot_generals(sub)
    return out


def _rays():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(0.0, 100e3, N), jnp.float32)
    dr = jnp.asarray(rng.uniform(100.0, 2000.0, N), jnp.float32)
    vals = jnp.asarray(rng.normal(size=(K, N)), jnp.float32)
    pv = jnp.asarray(rng.uniform(0.5, 1.5, N), jnp.float32)
    valid = jnp.ones((N,), bool)
    grid = jnp.linspace(0.0, 100e3, C + 1, dtype=jnp.float32)
    return x, dr, vals, pv, valid, grid


def _trace(site):
    x, dr, vals, pv, valid, grid = _rays()
    tables = jnp.ones((C, K), jnp.float32)
    x0, dx = jnp.float32(500.0), jnp.float32(1000.0)
    if site in ("interp_forward", "interp_vjp_tables", "interp_vjp_query"):
        if site == "interp_forward":
            fn, args = _basis_interp_raw, (x, x0, dx, tables)
        else:
            ct = jnp.ones((N, K), jnp.float32)
            fn = _basis_interp_bwd
            args = ((x, x0, dx, tables), ct)
        shape = {"interp_forward": (N, K), "interp_vjp_tables": (C, K),
                 "interp_vjp_query": (N, K)}[site]
    elif site in ("deposit_forward", "deposit_vjp_values",
                  "deposit_vjp_weights"):
        res = (vals, x - 0.5 * dr, x + 0.5 * dr, pv, valid, grid)
        if site == "deposit_forward":
            fn, args = projection._dense_deposit, res
        else:
            fn = projection._dense_deposit_bwd
            args = (res, jnp.ones((K, C), jnp.float32))
        shape = {"deposit_forward": (K, C), "deposit_vjp_values": (K, N),
                 "deposit_vjp_weights": (N, C)}[site]
    elif site in ("deposit_blocked", "deposit_remainder"):
        fn = lambda *a: projection.project_dense(*a, accum="compensated")
        args = (vals, x - 0.5 * dr, x + 0.5 * dr, pv, valid, grid)
        nb = N // projection.ACCUM_BLOCK
        shape = {"deposit_blocked": (nb, K, C),
                 "deposit_remainder": (K, C)}[site]
    else:
        fn = projection.project_interfaces
        args = (vals, x - 0.5 * dr, x + 0.5 * dr, pv, valid, grid)
        shape = (K, C + 1)
    return jax.make_jaxpr(fn)(*args), shape


SITES = ["interp_forward", "interp_vjp_tables", "interp_vjp_query",
         "deposit_forward", "deposit_vjp_values", "deposit_vjp_weights",
         "deposit_blocked", "deposit_remainder", "interfaces"]


@pytest.mark.parametrize("site", SITES)
def test_contraction_precision_is_highest(site):
    closed, shape = _trace(site)
    dots = [e for e in _dot_generals(closed.jaxpr)
            if tuple(e.outvars[0].aval.shape) == shape]
    assert dots, f"no contraction with result shape {shape} at {site}"
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None, site
        assert all(p == jax.lax.Precision.HIGHEST for p in prec), (site, prec)


@pytest.mark.gpu
def test_fast_deposit_meets_bar_on_gpu(gpu):
    """On the card, the f32 fast deposit of the ``fast`` preset's 1e5 rays
    stays within 1e-6 of the f64 parity deposit — TF32 would not."""
    import json

    from msgwam_tpu import cli
    from msgwam_tpu.diagnostics import pseudo_momentum_flux

    exp = cli.setup_experiment(json.loads(json.dumps(cli.PRESETS["fast"])))
    cfg64 = exp.cfg.replace(dtype="float64", **cli.KERNELS["xla"])
    to64 = lambda t: jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
    pm32 = np.asarray(pseudo_momentum_flux(exp.state.rays, exp.statics,
                                           exp.bg, exp.cfg), np.float64)
    pm64 = np.asarray(pseudo_momentum_flux(to64(exp.state.rays),
                                           to64(exp.statics), to64(exp.bg),
                                           cfg64))
    assert np.max(np.abs(pm32 - pm64)) / np.max(np.abs(pm64)) < 1e-6
