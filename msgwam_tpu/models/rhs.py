"""The coupled wave/mean-flow right-hand side.

One pure, jittable function mirroring the reference ``rhs_default``
(``lib/libprop.py:618-676``) over the :class:`msgwam_tpu.state.State`
pytree.  Data flow per evaluation:

* mean-flow → rays: one fused gather interpolating u, v, du/dz, dv/dz onto
  ray heights (the reference's ``gradients``, ``lib/libprop.py:328-366``);
* per-ray elementwise physics: group velocities, refraction, (optional)
  online saturation — elementwise chains XLA fuses over the ray batch;
* rays → mean-flow: the projection scatter of pseudo-momentum fluxes onto
  the staggered grid (``lib/libprop.py:653-660``), boundary padding by copy,
  flux divergence, and the wind tendencies (``lib/libprop.py:523-558``).

When the ray axis is sharded over a device mesh (``axis_name`` given), the
projected flux profile — a few hundred floats — is ``psum``-reduced across
shards right at the scatter, exactly the reference's single ray→grid
transpose point (SURVEY.md §3.3); the mean-flow update is then replicated.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from ..constants import RAD_EARTH
from ..state import Background, MeanState, RayState, RayStatics, State, coriolis
from ..ops.dispersion import cg_r, group_velocities, wavenumber_tendencies
from ..ops.interp import basis_interp, grid_interp
from ..ops.projection import project_backend
from ..ops.saturation import saturation_tendency


def gather_winds(rays: RayState, mean: MeanState, bg: Background,
                 backend: str = "gather"):
    """Interpolate winds and vertical shears onto ray heights
    (``lib/libprop.py:328-366``): centered FD of u, v on cell centers gives
    shear on interior faces; both are linearly interpolated (clamped) to
    each ray's center height.

    ``backend="gather"`` matches ``np.interp`` arithmetic exactly (parity
    mode); ``backend="mxu"`` evaluates all four profiles with two dense
    hat-basis contractions against the ~100-row tables (the f32 fast path).
    """
    dz = bg.centers[1] - bg.centers[0]
    du_dz = (mean.u[1:] - mean.u[:-1]) / dz
    dv_dz = (mean.v[1:] - mean.v[:-1]) / dz
    if backend == "mxu":
        uv = basis_interp(
            rays.r, bg.centers[0], dz, jnp.stack([mean.u, mean.v], axis=1)
        )
        # shear lives on interior faces: faces[1:-1] (lib/libprop.py:355-356)
        sh = basis_interp(
            rays.r, bg.faces[1], dz, jnp.stack([du_dz, dv_dz], axis=1)
        )
        return uv[:, 0], uv[:, 1], sh[:, 0], sh[:, 1]
    u_ray = grid_interp(rays.r, bg.centers, mean.u)
    v_ray = grid_interp(rays.r, bg.centers, mean.v)
    du_dr = grid_interp(rays.r, bg.faces[1:-1], du_dz)
    dv_dr = grid_interp(rays.r, bg.faces[1:-1], dv_dz)
    return u_ray, v_ray, du_dr, dv_dr


def rhs(
    dt,
    state: State,
    statics: RayStatics,
    bg: Background,
    cfg: ModelConfig,
    axis_name: Optional[str] = None,
) -> State:
    """d(state)/dt.  ``cfg`` is jit-static; ``axis_name`` names the sharded
    ray axis for the cross-shard flux reduction (None = single shard)."""
    rays, mean = state
    active = statics.active

    u_ray, v_ray, du_dr, dv_dr = gather_winds(rays, mean, bg, cfg.interp_backend)

    # Structurally-zero tendencies are Python scalars (0.0), not zero
    # arrays: the RK3 stage arithmetic then folds to a no-op for those
    # fields and XLA never materializes or round-trips them through device
    # memory (with hprop off, 6 of 11 state fields are constant).
    #
    # cg_r is height-independent in this model, so the reference's edge
    # evaluations at r ± dr/2 (lib/libprop.py:635-636) are bitwise
    # identical: drr_st = cg_r, the stretching ddrr_st ≡ 0, and with it
    # the dm-extent tendency ddmm_st = dm/dr * ddrr_st (lib/libprop.py:645).
    ddrr_st = 0.0
    ddmm_st = 0.0
    if cfg.hprop:
        cglam, cgphi, cgr = group_velocities(
            rays.k, rays.l, rays.m, rays.phi, u_ray, v_ray, cfg.bvf, True
        )
        radius = RAD_EARTH + rays.r
        dlam_st = cglam / radius / jnp.cos(rays.phi)
        dphi_st = cgphi / radius
        dkk_st, dll_st, dmm_st = wavenumber_tendencies(
            rays.k, rays.l, rays.m, rays.phi, rays.r,
            u_ray, v_ray, du_dr, dv_dr,
            cfg.bvf, True,
        )
    else:
        # horizontal propagation off (lib/libprop.py:404-407,467-471,
        # 493-499): positions and horizontal wavenumbers are frozen
        cgr = cg_r(rays.k, rays.l, rays.m, rays.phi, cfg.bvf)
        dlam_st = dphi_st = dkk_st = dll_st = 0.0
        dmm_st = -(rays.k * du_dr + rays.l * dv_dr)  # lib/libprop.py:519-520
    drr_st = cgr

    if cfg.saturate_online:
        dens_st = saturation_tendency(
            dt, rays.dens, rays.r, drr_st, rays.dr, ddrr_st,
            rays.k, rays.l, rays.m, dmm_st,
            statics.dkk, statics.dll, statics.rr_mm_area,
            bg.centers, bg.rhobar,
            cfg.bvf, cfg.kappa, cfg.phi0,
            faithful=cfg.faithful_saturation,
            active=active,
            interp_backend=cfg.interp_backend,
        )
    else:
        dens_st = 0.0

    # rays → mean flow: pseudo-momentum flux onto the staggered grid
    # (lib/libprop.py:653-658).  cg_r at the ray center equals cgr above.
    phase_vol = jnp.abs(statics.dkk * statics.dll * rays.dm)
    flux_vals = jnp.stack([cgr * rays.k * rays.dens, cgr * rays.l * rays.dens])
    pm_interior = project_backend(cfg.projection_backend)(
        flux_vals,
        rays.r - 0.5 * rays.dr,
        rays.r + 0.5 * rays.dr,
        phase_vol,
        active,
        bg.centers,
        cfg.max_span,
        accum=cfg.flux_accum,
    )  # (2, n_cell - 1)
    if axis_name is not None:
        pm_interior = jax.lax.psum(pm_interior, axis_name)

    # pad boundaries by copy (lib/libprop.py:653-660): full profile on the
    # n_face-point layout, interior = projection onto centers
    edge_lo = pm_interior[:, :1]
    edge_hi = pm_interior[:, -1:]
    pm_flux = jnp.concatenate([edge_lo, pm_interior, edge_hi], axis=1)

    dz = bg.faces[1] - bg.faces[0]
    pm_flux_gradient = (pm_flux[:, 1:] - pm_flux[:, :-1]) / dz  # (2, n_cell)

    # mean-flow tendencies (lib/libprop.py:523-558); with the mean flow
    # non-prognostic (fixed/prescribed background) they are exactly zero
    if cfg.prognostic_mean:
        ff = coriolis(cfg.phi0)
        du_st = ff * mean.v - (bg.pressure_gradient[0] + pm_flux_gradient[0]) / bg.rhobar
        dv_st = -ff * mean.u - (bg.pressure_gradient[1] + pm_flux_gradient[1]) / bg.rhobar
    else:
        du_st = 0.0
        dv_st = 0.0

    # inactive slots are frozen: zero tendencies everywhere (structural
    # scalar zeros pass through untouched — already inactive-safe)
    z = jnp.zeros((), dtype=rays.dens.dtype)

    def msk(t):
        if isinstance(t, float):
            return t
        return jnp.where(active, t, z).astype(rays.dens.dtype)

    ray_st = RayState(
        dens=msk(dens_st), lam=msk(dlam_st), phi=msk(dphi_st),
        r=msk(drr_st), dr=msk(ddrr_st),
        k=msk(dkk_st), l=msk(dll_st), m=msk(dmm_st), dm=msk(ddmm_st),
    )
    # cast back: weak-type promotion (e.g. the f64-weak Coriolis scalar
    # under x64) must not change the carried state dtype
    cast = lambda t, like: t if isinstance(t, float) else t.astype(like.dtype)
    return State(ray_st, MeanState(cast(du_st, mean.u), cast(dv_st, mean.v)))

