"""Linear interpolation of grid profiles onto ray heights.

The reference uses ``np.interp`` (``lib/libprop.py:355-358,400,424,595``) —
clamped linear interpolation onto a sorted 1-D grid.  This is a gather + a
fused multiply-add; because the reference grids are uniform we also provide
a closed-form fast path that avoids ``searchsorted`` entirely, and a dense
hat-basis form (:func:`basis_interp`) that interpolates several tables at
once as one contraction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def interp(x, xp, fp):
    """``np.interp`` semantics for a sorted 1-D ``xp``: linear inside,
    clamped to ``fp[0]`` / ``fp[-1]`` outside.  General (non-uniform) grid.
    """
    x = jnp.asarray(x)
    xp = jnp.asarray(xp)
    fp = jnp.asarray(fp)
    n = xp.shape[0]
    i = jnp.clip(jnp.searchsorted(xp, x, side="right") - 1, 0, n - 2)
    x0 = xp[i]
    x1 = xp[i + 1]
    f0 = fp[i]
    f1 = fp[i + 1]
    # numpy's compiled inner-loop arithmetic: slope*(x - x0) + f0, clamped
    inner = (f1 - f0) / (x1 - x0) * (x - x0) + f0
    return jnp.where(x <= xp[0], fp[0], jnp.where(x >= xp[-1], fp[-1], inner))


def uniform_interp(x, x0, dx, fp):
    """``np.interp`` on a *uniform* grid ``xp[j] = x0 + j*dx`` — index math
    instead of searchsorted (no log-n gather chain; single gather pair).

    The arithmetic mirrors numpy's compiled ``interp`` inner loop
    (``slope*(x - xp[i]) + fp[i]``, clamped outside) so that float64 results
    track ``np.interp`` as closely as possible for trajectory parity.
    """
    x = jnp.asarray(x)
    fp = jnp.asarray(fp)
    n = fp.shape[0]
    t = (x - x0) / dx
    i = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, n - 2)
    xi = x0 + i * dx
    f0 = fp[i]
    f1 = fp[i + 1]
    inner = (f1 - f0) / dx * (x - xi) + f0
    return jnp.where(x <= x0, fp[0], jnp.where(x >= x0 + (n - 1) * dx, fp[-1], inner))


def basis_matrix(x, x0, dx, n):
    """Dense linear-interpolation (hat-function) basis: ``B[i, j] =
    hat_j(clip(x_i))`` for the uniform grid ``xp[j] = x0 + j*dx``, such that
    ``B @ fp`` equals clamped linear interpolation (``np.interp``) of any
    table ``fp`` on that grid.

    The ``mxu`` interp backend: the table is tiny (~100 entries), so
    interpolation of many tables at the same query points is one
    ``(n_query, n_table)`` basis construction (fused elementwise) + one
    contraction, with no per-query gather.
    """
    x = jnp.asarray(x)
    xc = jnp.clip(x, x0, x0 + (n - 1) * dx)
    t = (xc[:, None] - x0) / dx - jnp.arange(n, dtype=x.dtype)[None, :]
    return jnp.maximum(0.0, 1.0 - jnp.abs(t))


def _basis_interp_raw(x, x0, dx, tables):
    B = basis_matrix(x, x0, dx, tables.shape[0])
    return jax.lax.dot_general(
        B, tables,
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=tables.dtype,
    )


@jax.custom_vjp
def _basis_interp_2d(x, x0, dx, tables):
    """``basis_matrix(x) @ tables`` with a hand-written VJP.

    Why not plain autodiff: the VJP of the fused basis-build-plus-matmul
    needs ``B`` for the tables cotangent, so XLA materializes the
    ``(n_query, n_table)`` basis matrix as a residual — ~400 MB per call
    at 1e6 rays (f32, 100 cells).  With six such interps per RK3 step
    the adjoint would become bound by the bandwidth of those residuals.
    This VJP stores only ``x`` and ``tables`` and REBUILDS the bases in
    the backward (fused elementwise + contraction, no basis round-trips
    device memory):

    * tables cotangent:  Bᵀ(x) @ ct        (one rebuilt-basis matmul)
    * query cotangent:   ct ⊙ (B'(x) @ tables) / dx — the derivative of
      clamped linear interpolation is the interp of the hat-derivative
      basis B'[i,j] = -sign(t_ij)·1{|t_ij|<1}, zeroed where the clip is
      active (outside the grid the clamped value is constant)
    * x0/dx cotangents: reductions of the same ct ⊙ (B' @ tables)
      product (∂u/∂x0 = -1/dx, ∂u/∂dx = -(x-x0)/dx² inside; both zero
      under an active clip)

    Kink convention at the hat peak/edges matches JAX's ``abs``/``max``
    subgradients (sign(0)=0, half-open window) — measure-zero points;
    the forward is bit-identical to the autodiff path.
    """
    return _basis_interp_raw(x, x0, dx, tables)


def _basis_interp_fwd(x, x0, dx, tables):
    return _basis_interp_raw(x, x0, dx, tables), (x, x0, dx, tables)


def _basis_interp_bwd(res, ct):
    x, x0, dx, tables = res
    n = tables.shape[0]
    hi = x0 + (n - 1) * dx
    xc = jnp.clip(x, x0, hi)
    t = (xc[:, None] - x0) / dx - jnp.arange(n, dtype=x.dtype)[None, :]
    B = jnp.maximum(0.0, 1.0 - jnp.abs(t))
    # tables cotangent: Bᵀ @ ct, basis rebuilt (no stored residual)
    ct_tables = jax.lax.dot_general(
        B, ct,
        dimension_numbers=(((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=tables.dtype,
    )
    # hat-derivative basis, matching JAX's kink subgradients exactly so
    # the custom VJP is bit-compatible with autodiff even at on-node
    # queries (measured conventions: abs'(0) = 1, maximum ties -> 0.5):
    # d hat/d u = -sgn(u) on |u| < 1 (sgn(0) := +1), -0.5 sgn(u) at
    # |u| = 1, zero beyond
    sgn = jnp.where(t >= 0, 1.0, -1.0).astype(t.dtype)
    at = jnp.abs(t)
    dB = jnp.where(at < 1.0, -sgn, jnp.where(at == 1.0, -0.5 * sgn, 0.0))
    G = jax.lax.dot_general(
        dB, tables,
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=tables.dtype,
    )  # (n_query, k): ∂out/∂u per query, summed over nothing yet
    ctG = jnp.sum(ct * G, axis=1)  # (n_query,)
    # clip factor: 1 inside, 0.5 exactly on a boundary (JAX's clip tie
    # convention), 0 outside — one factor serves the x, x0, AND dx
    # cotangents (the tie algebra works out identically for all three)
    clipf = jnp.where((x > x0) & (x < hi), 1.0,
                      jnp.where((x == x0) | (x == hi), 0.5, 0.0))
    ctG = ctG * clipf.astype(ctG.dtype)
    ct_x = ctG / dx
    ct_x0 = -jnp.sum(ctG) / dx
    ct_dx = -jnp.sum(ctG * (xc - x0)) / (dx * dx)
    return (ct_x.astype(x.dtype),
            ct_x0.astype(jnp.asarray(x0).dtype),
            ct_dx.astype(jnp.asarray(dx).dtype),
            ct_tables)


_basis_interp_2d.defvjp(_basis_interp_fwd, _basis_interp_bwd)


def basis_interp(x, x0, dx, tables):
    """Interpolate one or more stacked ``(n_table,)`` / ``(n_table, k)``
    tables at query points ``x`` via :func:`basis_matrix` (one matmul).
    Carries a residual-free custom VJP (see :func:`_basis_interp_2d`) —
    gradients rebuild the basis instead of storing the
    ``(n_query, n_table)`` matrix."""
    tables = jnp.asarray(tables)
    x = jnp.asarray(x)
    squeeze = tables.ndim == 1
    if squeeze:
        tables = tables[:, None]
    out = _basis_interp_2d(x, jnp.asarray(x0, x.dtype),
                           jnp.asarray(dx, x.dtype), tables)
    return out[:, 0] if squeeze else out


def grid_interp(x, xp, fp):
    """``np.interp`` on a *uniform, explicitly materialized* grid ``xp``:
    indices come from closed-form index math (fast), but the interpolation
    arithmetic uses the actual ``xp[i]`` values and per-interval widths so
    float64 results match ``np.interp`` to the last few ULPs (trajectory
    parity with the reference's ``lib/libprop.py:355-358,595``)."""
    x = jnp.asarray(x)
    xp = jnp.asarray(xp)
    fp = jnp.asarray(fp)
    n = fp.shape[0]
    x0 = xp[0]
    dx = xp[1] - xp[0]
    i = jnp.clip(jnp.floor((x - x0) / dx).astype(jnp.int32), 0, n - 2)
    xi = xp[i]
    # if rounding put x below xp[i], step back one interval (searchsorted semantics)
    i = jnp.where(x < xi, jnp.maximum(i - 1, 0), i)
    xi = xp[i]
    f0 = fp[i]
    f1 = fp[i + 1]
    inner = (f1 - f0) / (xp[i + 1] - xi) * (x - xi) + f0
    return jnp.where(x <= x0, fp[0], jnp.where(x >= xp[-1], fp[-1], inner))
