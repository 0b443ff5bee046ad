"""Interpolation kernels vs np.interp (the reference's primitive,
``lib/libprop.py:355-358``)."""

import numpy as np
import jax.numpy as jnp

from msgwam_tpu.ops.interp import basis_interp, grid_interp, interp, uniform_interp


def _case(rng, n_table=100, n_query=500, x0=500.0, dx=1000.0):
    xp = x0 + dx * np.arange(n_table)
    fp = rng.normal(size=n_table)
    # queries: interior, below, above, and exactly-on-grid points
    x = np.concatenate([
        rng.uniform(xp[0] - 2 * dx, xp[-1] + 2 * dx, n_query),
        xp[:5], [xp[0], xp[-1]],
    ])
    return x, xp, fp


def test_interp_matches_numpy(rng):
    x, xp, fp = _case(rng)
    expect = np.interp(x, xp, fp)
    np.testing.assert_allclose(np.asarray(interp(x, xp, fp)), expect, rtol=1e-14)


def test_grid_interp_matches_numpy(rng):
    x, xp, fp = _case(rng)
    expect = np.interp(x, xp, fp)
    np.testing.assert_allclose(np.asarray(grid_interp(x, xp, fp)), expect, rtol=1e-13)


def test_uniform_interp_matches_numpy(rng):
    x, xp, fp = _case(rng)
    expect = np.interp(x, xp, fp)
    got = uniform_interp(x, xp[0], xp[1] - xp[0], fp)
    np.testing.assert_allclose(np.asarray(got), expect, rtol=1e-12, atol=1e-12)


def test_basis_interp_matches_numpy(rng):
    """The mxu (hat-basis contraction) backend reproduces clamped linear
    interpolation."""
    x, xp, fp = _case(rng)
    expect = np.interp(x, xp, fp)
    got = basis_interp(x, xp[0], xp[1] - xp[0], fp)
    np.testing.assert_allclose(np.asarray(got), expect, rtol=1e-12, atol=1e-12)
    # stacked tables in one matmul
    fp2 = np.stack([fp, 2 * fp + 1], axis=1)
    got2 = basis_interp(x, xp[0], xp[1] - xp[0], fp2)
    np.testing.assert_allclose(np.asarray(got2[:, 0]), expect, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(got2[:, 1]), np.interp(x, xp, fp2[:, 1]), rtol=1e-12, atol=1e-12
    )


def test_basis_interp_custom_vjp_matches_autodiff(rng):
    """basis_interp's residual-free custom VJP (the basis is rebuilt in
    the backward instead of stored — the ~400 MB/call residual that made
    the adjoint bandwidth-bound, ADJOINT_PROFILE_r05.json) must produce
    the same cotangents as plain autodiff of the raw implementation, for
    every argument: x, x0, dx, tables."""
    import jax
    import jax.numpy as jnp
    from msgwam_tpu.ops.interp import _basis_interp_raw

    x, xp, fp = _case(rng)
    # include out-of-range queries (the clip branch zeroes d/dx there)
    x = np.concatenate([x, [xp[0] - 5.0, xp[-1] + 5.0]])
    fp2 = np.stack([fp, np.cos(fp)], axis=1)
    x0, dx = float(xp[0]), float(xp[1] - xp[0])
    args = (jnp.asarray(x), jnp.asarray(x0), jnp.asarray(dx),
            jnp.asarray(fp2))

    out_c, vjp_c = jax.vjp(basis_interp, *args)
    out_r, vjp_r = jax.vjp(_basis_interp_raw, *args)
    np.testing.assert_allclose(np.asarray(out_c), np.asarray(out_r),
                               rtol=1e-14)

    ct = jnp.asarray(rng.standard_normal(out_c.shape))
    for got, want, name in zip(vjp_c(ct), vjp_r(ct),
                               ("x", "x0", "dx", "tables")):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-12, atol=1e-12,
            err_msg=f"cotangent mismatch for {name}")

    # squeeze (1-D table) path, via jax.grad end to end
    f_c = lambda xx, t: jnp.sum(jnp.sin(basis_interp(xx, x0, dx, t)))
    f_r = lambda xx, t: jnp.sum(jnp.sin(
        _basis_interp_raw(xx, x0, dx, t[:, None])[:, 0]))
    g_c = jax.grad(f_c, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(fp))
    g_r = jax.grad(f_r, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(fp))
    for got, want in zip(g_c, g_r):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
