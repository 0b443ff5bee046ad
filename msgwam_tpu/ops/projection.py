"""Ray→grid projection: the hot kernel of the whole model.

The reference implements this as a per-ray × per-cell Python double loop
(``lib/libprop.py:92-221``) — it is where ~97% of the reference's runtime
goes (SURVEY.md §6).  Here each ray volume's fractional overlap with grid
cells becomes a statically-bounded sparse row of weights, and the deposition
is a ``segment_sum`` scatter (``xla`` backend, parity mode) or a dense
weight-matrix contraction (``mxu`` backend, the f32 fast path).

Every contraction here passes ``precision=HIGHEST``: the deposit bar is a
1e-6 relative error against float64, and a float32 matrix product left at
the default precision may run in TF32 on a GPU, which keeps ~3 digits.

Faithfully reproduced reference semantics (needed for bit-parity):

* cell indices from the *origin-0* ratio ``r/dz``, truncated toward zero:
  ``nlow = int(r_low/dz)``, ``nup = int(r_up/dz + 1)``
  (``lib/libprop.py:123-125``) — even when projecting onto the staggered
  grid whose first point is dz/2 (the reference does exactly this inside
  ``rhs_default``, ``lib/libprop.py:654-658``);
* clamping both indices to ``nzmax = len(grid) - 2`` so the top cell never
  receives deposition, and the ``-99999`` out-of-domain sentinel
  (``lib/libprop.py:127-135``) — here a boolean mask;
* the *absolute value* of the overlap ``|min(grid[c+1], r_up) −
  max(grid[c], r_low)|/dz`` (``lib/libprop.py:157-160``), which can deposit
  spurious positive weight for cells the index arithmetic selects but the
  grid values do not actually overlap (reference quirk — kept).

Out-of-domain rays are masked but (like the reference) never deleted here;
culling is a separate, optional pass (:mod:`msgwam_tpu.models.sources`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .dispersion import cg_r


def _cell_spans(r_low, r_up, dz, n_points):
    """Reference index arithmetic (``lib/libprop.py:121-135``).

    Returns ``(nlow, nup, in_domain)`` with indices clamped to
    ``[0, nzmax]`` and the out-of-domain mask already applied.
    """
    nzmax = n_points - 2
    nlow = (r_low / dz).astype(jnp.int32)  # truncates toward zero, like numpy
    nup = (r_up / dz + 1.0).astype(jnp.int32)
    out_of_domain = ((nlow >= nzmax) & (nup >= nzmax)) | ((nlow <= 0) & (nup <= 0))
    nlow = jnp.clip(nlow, 0, nzmax)
    nup = jnp.clip(nup, 0, nzmax)
    return nlow, nup, ~out_of_domain


def projection_weights(r_low, r_up, valid, grid, max_span: int):
    """Sparse overlap weights for every ray.

    Returns ``(cells, weights, live)``, each ``(n, max_span)``: for ray
    ``i`` and slot ``j``, ``weights[i, j]`` is the fractional-overlap weight
    of cell ``cells[i, j]``, and ``live[i, j]`` marks real (unmasked,
    in-span) slots; masked-off slots carry weight 0.

    ``max_span`` is the static bound on cells-per-ray; any ray overlapping
    more cells is truncated (choose ``max_span >= ceil(max dr/dz) + 1``).
    """
    n_points = grid.shape[0]
    dz = grid[1] - grid[0]
    nlow, nup, in_domain = _cell_spans(r_low, r_up, dz, n_points)
    ok = in_domain if valid is None else (valid & in_domain)

    j = jnp.arange(max_span, dtype=jnp.int32)
    cells = nlow[:, None] + j[None, :]                      # (n, S)
    live = ok[:, None] & (cells < nup[:, None])
    cells = jnp.clip(cells, 0, n_points - 2)
    zmin = jnp.maximum(grid[cells], r_low[:, None])
    zmax = jnp.minimum(grid[cells + 1], r_up[:, None])
    weights = jnp.where(live, jnp.abs(zmax - zmin) / dz, 0.0)
    return cells, weights, live


# Ray-axis block length for the wide-accumulation modes: partial deposits
# are computed per block at working precision, then combined in a wider (or
# compensated) reduction.  8192 keeps the worst-case in-block accumulation
# error ~1e-7 relative while the per-block contractions stay large.
ACCUM_BLOCK = 8192


def _kahan_sum(parts):
    """Compensated (Kahan) summation over the leading axis — error ~2·eps
    independent of length, entirely at working precision (no x64 needed).
    XLA does not reassociate floating-point arithmetic, so the compensation
    survives compilation."""
    zero = jnp.zeros_like(parts[0])

    def body(carry, x):
        s, c = carry
        y = x - c
        t = s + y
        c = (t - s) - y
        return (t, c), None

    (s, c), _ = jax.lax.scan(body, (zero, zero), parts)
    return s


def _reduce_partials(parts, accum: str, out_dtype):
    """Combine ``(nb, nvar, C)`` per-block partial deposits.

    ``accum``:
      * ``"native"`` — plain sum at working precision;
      * ``"f64"``    — upcast partials to float64, sum, cast back (needs
        ``jax_enable_x64``; raises otherwise rather than silently degrading);
      * ``"compensated"`` — Kahan summation at working precision (the f32
        fast path: no x64 dependency, same <1e-7 accuracy).
    """
    if accum == "native":
        return parts.sum(axis=0)
    if accum == "f64":
        if not jax.config.jax_enable_x64:
            raise ValueError(
                "flux_accum='f64' requires jax_enable_x64 (the float64 "
                "accumulator would silently degrade to float32); enable x64 "
                "or use flux_accum='compensated'"
            )
        return parts.astype(jnp.float64).sum(axis=0).astype(out_dtype)
    if accum == "compensated":
        return _kahan_sum(parts)
    raise ValueError(
        f"unknown flux accumulation mode {accum!r}; "
        "available: 'native', 'f64', 'compensated'"
    )


def project(values, r_low, r_up, phase_vol, valid, grid, max_span: int,
            accum: str = "native"):
    """Deposit per-ray quantities onto grid cells.

    Args:
      values: ``(nvar, n)`` per-ray values (e.g. ``cg_r * k * dens``).
      r_low, r_up: ``(n,)`` ray-volume vertical edges.
      phase_vol: ``(n,)`` phase-space volume ``|dk dl dm|``
        (``lib/libprop.py:137``).
      valid: ``(n,)`` bool activity mask, or None.
      grid: ``(G,)`` uniform projection grid (faces of G-1 cells).
      max_span: static max cells per ray.
      accum: deposit accumulation mode (see :func:`_reduce_partials`);
        ``"f64"`` runs the whole scatter in float64.

    Returns ``(nvar, G-1)`` cell deposits.
    """
    values = jnp.atleast_2d(values)
    n_points = grid.shape[0]
    n_cells = n_points - 1
    cells, weights, live = projection_weights(r_low, r_up, valid, grid, max_span)
    w = weights * phase_vol[:, None]                        # (n, S)
    # route dead slots to a dump segment so they never touch real cells
    seg = jnp.where(live, cells, n_cells).reshape(-1)       # (n*S,)
    contrib = (values[:, :, None] * w[None, :, :]).reshape(values.shape[0], -1)
    if accum == "f64":
        if not jax.config.jax_enable_x64:
            raise ValueError(
                "flux_accum='f64' requires jax_enable_x64; enable x64 or "
                "use the 'mxu' backend with flux_accum='compensated'"
            )
        out = jax.ops.segment_sum(
            contrib.T.astype(jnp.float64), seg,
            num_segments=n_cells + 1, indices_are_sorted=False,
        ).astype(values.dtype)
    else:
        if accum != "native":
            raise ValueError(
                f"the 'xla' (segment-sum) backend supports accum 'native' "
                f"or 'f64', got {accum!r}; 'compensated' needs the blockwise "
                f"'mxu' backend"
            )
        out = jax.ops.segment_sum(
            contrib.T, seg, num_segments=n_cells + 1, indices_are_sorted=False
        )                                                   # (n_cells+1, nvar)
    return out[:n_cells].T


def _dense_weights(r_low, r_up, phase_vol, valid, grid):
    """The dense per-(ray, cell) overlap-weight matrix ``w`` such that the
    deposit is ``values @ w`` — factored out so the custom VJP below can
    REBUILD it in the backward instead of storing it."""
    n_points = grid.shape[0]
    n_cells = n_points - 1
    dz = grid[1] - grid[0]
    nlow, nup, in_domain = _cell_spans(r_low, r_up, dz, n_points)
    ok = in_domain if valid is None else (valid & in_domain)
    c = jnp.arange(n_cells, dtype=jnp.int32)
    in_span = (c[None, :] >= nlow[:, None]) & (c[None, :] < nup[:, None])
    zmin = jnp.maximum(grid[:-1][None, :], r_low[:, None])
    zmax = jnp.minimum(grid[1:][None, :], r_up[:, None])
    w = jnp.abs(zmax - zmin) / dz
    return jnp.where(in_span & ok[:, None], w, 0.0) * phase_vol[:, None]


@jax.custom_vjp
def _dense_deposit(values, r_low, r_up, phase_vol, valid, grid):
    """``values @ _dense_weights(...)`` with a residual-free VJP.

    Stores only the small primal inputs and rebuilds the ``(n, n_cells)``
    weight matrix in the backward; the cotangents of the weight
    construction itself (r_low/r_up/phase_vol/grid, piecewise through the
    clamp/span logic) are delegated to a nested ``jax.vjp`` of
    :func:`_dense_weights` evaluated inside the backward — identical
    conventions to plain autodiff by construction
    (tests/test_projection.py).

    It makes rematerialization of the weight build a *guarantee* rather
    than a scheduler choice: the ~400 MB/deposit residual (1e6 f32 rays)
    can never reappear under a different fusion decision, jax version, or
    problem shape.
    """
    w = _dense_weights(r_low, r_up, phase_vol, valid, grid)
    return jax.lax.dot_general(
        values, w,
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=values.dtype,
    )


def _dense_deposit_fwd(values, r_low, r_up, phase_vol, valid, grid):
    out = _dense_deposit(values, r_low, r_up, phase_vol, valid, grid)
    return out, (values, r_low, r_up, phase_vol, valid, grid)


def _dense_deposit_bwd(res, ct):
    # Analytic transpose of the weight construction — one fused
    # elementwise (n, n_cells) pass + two contractions, instead of the
    # ~10 passes a nested jax.vjp of _dense_weights generates.  Kink/tie
    # subgradients reproduce JAX's measured conventions exactly
    # (abs'(0) = 1; maximum/minimum ties split 0.5/0.5), validated
    # against plain autodiff in tests/test_projection.py.
    values, r_low, r_up, phase_vol, valid, grid = res
    n_points = grid.shape[0]
    n_cells = n_points - 1
    dz = grid[1] - grid[0]
    nlow, nup, in_domain = _cell_spans(r_low, r_up, dz, n_points)
    ok = in_domain if valid is None else (valid & in_domain)
    c = jnp.arange(n_cells, dtype=jnp.int32)
    mask = ((c[None, :] >= nlow[:, None]) & (c[None, :] < nup[:, None])
            & ok[:, None])
    gl = grid[:-1][None, :]
    gu = grid[1:][None, :]
    rl = r_low[:, None]
    ru = r_up[:, None]
    d = jnp.minimum(gu, ru) - jnp.maximum(gl, rl)
    absd = jnp.abs(d)
    w_raw = absd / dz                                       # pre-phase_vol
    w = jnp.where(mask, w_raw, 0.0) * phase_vol[:, None]

    ct_values = jax.lax.dot_general(
        ct, w,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=values.dtype,
    )                                                       # (nvar, n)
    ctm = jnp.where(mask, jax.lax.dot_general(
        values, ct,
        dimension_numbers=(((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=values.dtype,
    ), 0.0)                                                 # (n, n_cells)

    ct_pv = jnp.sum(ctm * w_raw, axis=1)
    one = jnp.ones((), dtype=d.dtype)
    s = jnp.where(d >= 0, one, -one)                        # abs'(0) = 1
    g_d = ctm * s * (phase_vol[:, None] / dz)               # ∂L/∂d_ic
    half = 0.5 * one
    sel_rl = jnp.where(rl > gl, one, jnp.where(rl == gl, half, 0.0))
    sel_ru = jnp.where(ru < gu, one, jnp.where(ru == gu, half, 0.0))
    ct_rl = jnp.sum(g_d * (-sel_rl), axis=1)
    ct_ru = jnp.sum(g_d * sel_ru, axis=1)
    # grid cotangent: zmin routes to grid[c] where the max picked gl,
    # zmax to grid[c+1] where the min picked gu; plus the global 1/dz
    # factor through dz = grid[1] - grid[0]
    g_gl = jnp.sum(g_d * (-(one - sel_rl)), axis=0)         # → grid[:-1]
    g_gu = jnp.sum(g_d * (one - sel_ru), axis=0)            # → grid[1:]
    ct_dz = -jnp.sum(ctm * w_raw * phase_vol[:, None]) / dz
    ct_grid = (jnp.zeros_like(grid)
               .at[:-1].add(g_gl).at[1:].add(g_gu)
               .at[0].add(-ct_dz).at[1].add(ct_dz))
    return ct_values, ct_rl, ct_ru, ct_pv, None, ct_grid


_dense_deposit.defvjp(_dense_deposit_fwd, _dense_deposit_bwd)


def project_dense(values, r_low, r_up, phase_vol, valid, grid, max_span=None,
                  accum: str = "native"):
    """The ``mxu`` projection backend: the deposit is a *dense* weight
    matrix contraction instead of a scatter.

    The grid is tiny (~100 cells), so the full per-(ray, cell)
    overlap-weight matrix is cheap to build elementwise, and the reduction
    over rays is one contraction ``(nvar, n) @ (n, C)`` with no scatter.
    Semantics (index
    arithmetic, clamping, out-of-domain mask, |overlap|) are identical to
    :func:`project`; only the summation order differs (parity mode should
    use the ``xla`` backend).

    ``max_span`` is accepted and ignored (the dense form has no span bound
    — rays wider than ``max_span`` cells are handled exactly).

    ``accum`` selects the deposit accumulation: ``"native"`` is one
    ``(nvar, n) @ (n, C)`` contraction at working precision; ``"f64"`` /
    ``"compensated"`` split the ray axis into :data:`ACCUM_BLOCK`-long
    blocks (one batched matmul), then combine the per-block partials in
    float64 / Kahan-compensated arithmetic — deposit error ~1e-7 relative
    at 1e6 float32 rays, where the plain f32 contraction exceeds 1e-6.
    """
    values = jnp.atleast_2d(values)
    n_cells = grid.shape[0] - 1
    if accum == "native":
        # residual-free custom VJP (the adjoint fast path)
        return _dense_deposit(values, r_low, r_up, phase_vol, valid, grid)

    w = _dense_weights(r_low, r_up, phase_vol, valid, grid)
    nvar, n = values.shape
    nb = n // ACCUM_BLOCK
    parts = []
    if nb:
        vb = values[:, : nb * ACCUM_BLOCK].reshape(nvar, nb, ACCUM_BLOCK)
        wb = w[: nb * ACCUM_BLOCK].reshape(nb, ACCUM_BLOCK, n_cells)
        parts.append(jax.lax.dot_general(
            vb, wb,
            dimension_numbers=(((2,), (1,)), ((1,), (0,))),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=values.dtype,
        ))                                                  # (nb, nvar, C)
    if n - nb * ACCUM_BLOCK:
        parts.append(jax.lax.dot_general(
            values[:, nb * ACCUM_BLOCK:], w[nb * ACCUM_BLOCK:],
            dimension_numbers=(((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=values.dtype,
        )[None])                                            # (1, nvar, C)
    parts = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    return _reduce_partials(parts, accum, values.dtype)


PROJECT_BACKENDS = {"xla": project, "mxu": project_dense}


def project_backend(name: str):
    try:
        return PROJECT_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown projection backend {name!r}; available: "
            f"{sorted(PROJECT_BACKENDS)}"
        ) from None


def project_interfaces(values, r_low, r_up, phase_vol, valid, grid):
    """Interface-flux projection (reference vars 3-4,
    ``lib/libprop.py:199-219``): each interior face ``nb`` accumulates the
    full ``value * phase_vol`` of every ray strictly straddling it
    (``nlow < nb < nup``).  Dense O(n·G) mask + matmul (diagnostics only;
    dead code in the reference driver).

    Returns ``(nvar, G)``.
    """
    values = jnp.atleast_2d(values)
    n_points = grid.shape[0]
    dz = grid[1] - grid[0]
    nlow, nup, in_domain = _cell_spans(r_low, r_up, dz, n_points)
    ok = in_domain if valid is None else (valid & in_domain)
    nb = jnp.arange(n_points, dtype=jnp.int32)
    straddle = (
        (nlow[:, None] < nb[None, :])
        & (nup[:, None] > nb[None, :])
        & ok[:, None]
        & (nb[None, :] >= 1)
        & (nb[None, :] < n_points - 1)
    )                                                       # (n, G)
    w = straddle.astype(values.dtype) * phase_vol[:, None]
    return jnp.matmul(values, w,
                      precision=jax.lax.Precision.HIGHEST)  # (nvar, G)


def project_reference_variant(
    dens, lam, phi, rr_low, rr_up,
    kk, ll, mm_low, mm_up,
    dkk, dll, dmm,
    grid, bvf,
    var: int = 0,
    max_span: int = 4,
    valid=None,
):
    """Full mirror of the reference ``wave_projection`` entry point
    (``lib/libprop.py:92-221``), all five variants:

    * var=0 — pseudo-momentum fluxes (u,v) at cell centers → ``(2, G-1)``
    * var=1 — vertical wave-action flux at cell centers → ``(G-1,)``
    * var=2 — wave action at cell centers → ``(G-1,)``
    * var=3 — wave-action flux at interfaces → ``(G,)``
    * var=4 — pseudo-momentum fluxes at interfaces → ``(2, G)``

    Like the reference, cg_r is evaluated at ray centers
    (``lib/libprop.py:139-144``) and the phase-space volume is
    ``|dkk·dll·dmm|`` (``lib/libprop.py:137``).
    """
    phase_vol = jnp.abs(dkk * dll * dmm)
    cgr = cg_r(kk, ll, 0.5 * (mm_low + mm_up), phi, bvf)

    if var == 0:
        vals = jnp.stack([cgr * kk * dens, cgr * ll * dens])
        return project(vals, rr_low, rr_up, phase_vol, valid, grid, max_span)
    if var == 1:
        return project(
            cgr * dens, rr_low, rr_up, phase_vol, valid, grid, max_span
        )[0]
    if var == 2:
        return project(dens, rr_low, rr_up, phase_vol, valid, grid, max_span)[0]
    if var == 3:
        return project_interfaces(
            cgr * dens, rr_low, rr_up, phase_vol, valid, grid
        )[0]
    if var == 4:
        vals = jnp.stack([cgr * kk * dens, cgr * ll * dens])
        return project_interfaces(vals, rr_low, rr_up, phase_vol, valid, grid)
    raise ValueError(f"unknown projection variant {var}")


def required_span(dr_max: float, dz: float) -> int:
    """Host-side helper: the ``max_span`` needed so no ray volume of extent
    up to ``dr_max`` is truncated."""
    import math

    return int(math.ceil(dr_max / dz)) + 1
