"""Projection-based scientific observables.

Mirrors the reference driver's diagnostics block (``raytracer.py:194-240``):
wave action and wave-action flux projected per timestep, and the wave-action
tendency as the negative flux divergence — but jit-batched (vmap) over the
time axis instead of a Python loop per frame.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import ModelConfig
from .state import Background
from .ops.dispersion import cg_r
from .ops.projection import project_backend


class WaveActionDiagnostics(NamedTuple):
    wave_action: jax.Array     # (n_t, n_face - 1)     on the face grid cells
    flux: jax.Array            # (n_t, n_cell - 1)     on the center-grid cells
    tendency: jax.Array        # (n_t, n_cell)         −∂flux/∂z, zero-padded


def _project_frame(dens, phi, r, dr, k, l, m, dm, dkk, dll, active,
                   grid, bvf, max_span, with_flux: bool, backend: str = "xla"):
    phase_vol = jnp.abs(dkk * dll * dm)
    vals = dens
    if with_flux:
        vals = cg_r(k, l, m, phi, bvf) * dens
    return project_backend(backend)(
        vals, r - 0.5 * dr, r + 0.5 * dr, phase_vol, active, grid, max_span
    )[0]


def wave_action_history(
    history_rays,
    history_active,
    statics,
    bg: Background,
    cfg: ModelConfig,
) -> WaveActionDiagnostics:
    """Compute the reference's conservation diagnostics over a stacked
    history (leading time axis on every ray field).

    * wave action (var=2) projected onto the *face* grid
      (``raytracer.py:210-223``),
    * wave-action flux (var=1) onto the *center* grid
      (``raytracer.py:225-231``),
    * tendency = −Δflux/Δz, zero at the profile edges
      (``raytracer.py:234-237``).
    """
    def frame(rays, active):
        wa = _project_frame(
            rays.dens, rays.phi, rays.r, rays.dr, rays.k, rays.l,
            rays.m, rays.dm, statics.dkk, statics.dll, active,
            bg.faces, cfg.bvf, cfg.max_span, with_flux=False,
            backend=cfg.projection_backend,
        )
        fl = _project_frame(
            rays.dens, rays.phi, rays.r, rays.dr, rays.k, rays.l,
            rays.m, rays.dm, statics.dkk, statics.dll, active,
            bg.centers, cfg.bvf, cfg.max_span, with_flux=True,
            backend=cfg.projection_backend,
        )
        return wa, fl

    wa, flux = jax.vmap(frame)(history_rays, history_active)
    dz = bg.faces[1] - bg.faces[0]
    interior = -(flux[:, 1:] - flux[:, :-1]) / dz
    pad = jnp.zeros((flux.shape[0], 1), dtype=flux.dtype)
    tendency = jnp.concatenate([pad, interior, pad], axis=1)
    return WaveActionDiagnostics(wave_action=wa, flux=flux, tendency=tendency)


def reference_window_diagnostics(
    history_rays,
    history_active,
    statics,
    bg: Background,
    cfg: ModelConfig,
):
    """Frame-for-frame reproduction of the reference driver's diagnostics
    block (``raytracer.py:194-240``), including its window arithmetic and
    index quirks.  Expects a *full-rate* history that includes the initial
    condition as frame 0, i.e. from ``simulate(..., save_every=1,
    include_t0=True)`` — ``n_frames = n_steps + 1`` like the reference's
    ``int_*`` buffers (``raytracer.py:125-150``).

    With ``nproj1 = n_frames - 4`` (``nproj = [0, len(time) - 5]``,
    ``raytracer.py:198``):

    * ``wave_action`` has ``nproj1`` rows; rows ``0 .. nproj1-3`` are var=2
      projections of those frames onto the face grid (``raytracer.py:
      212-217``); row ``nproj1-2`` is **never filled** (stays zero — the
      loop stops two short of the array, ``raytracer.py:210-212``); row
      ``nproj1-1`` is built from frame ``nproj1-1`` *except* ``rr_up``,
      which quirk 3 reads from frame 0 (``int_rr_up[nproj[1 - 1]]``,
      ``raytracer.py:221``).  ``cfg.faithful_diag_index=False`` corrects
      the index (the zero row is kept either way — it is window
      arithmetic, not an index typo).
    * ``flux`` has ``nproj1 - 1`` rows; rows ``0 .. nproj1-3`` are var=1
      projections onto the center grid (``raytracer.py:226-231``); the last
      row stays zero.
    * ``tendency`` is ``-Δflux/Δz`` zero-padded at both profile edges
      (``raytracer.py:234-237``).

    Returns a :class:`WaveActionDiagnostics`.
    """
    n_frames = history_rays.dens.shape[0]
    nproj1 = n_frames - 4
    if nproj1 < 3:
        raise ValueError(
            f"reference window needs n_frames >= 7, got {n_frames}"
        )

    def frame(rays, active, with_flux, grid):
        return _project_frame(
            rays.dens, rays.phi, rays.r, rays.dr, rays.k, rays.l,
            rays.m, rays.dm, statics.dkk, statics.dll, active,
            grid, cfg.bvf, cfg.max_span, with_flux=with_flux,
            backend=cfg.projection_backend,
        )

    filled = jax.tree.map(lambda x: x[: nproj1 - 2], history_rays)
    act = history_active[: nproj1 - 2]
    wa_filled = jax.vmap(lambda r, a: frame(r, a, False, bg.faces))(filled, act)
    fl_filled = jax.vmap(lambda r, a: frame(r, a, True, bg.centers))(filled, act)

    # the quirked last wave-action row (raytracer.py:219-223)
    last = jax.tree.map(lambda x: x[nproj1 - 1], history_rays)
    r_low = last.r - 0.5 * last.dr
    if cfg.faithful_diag_index:
        first = jax.tree.map(lambda x: x[0], history_rays)
        r_up = first.r + 0.5 * first.dr          # quirk 3: frame 0's rr_up
    else:
        r_up = last.r + 0.5 * last.dr
    phase_vol = jnp.abs(statics.dkk * statics.dll * last.dm)
    vals = last.dens
    wa_last = project_backend(cfg.projection_backend)(
        vals, r_low, r_up, phase_vol, history_active[nproj1 - 1],
        bg.faces, cfg.max_span,
    )[0]

    zero_wa = jnp.zeros((1,) + wa_filled.shape[1:], wa_filled.dtype)
    wa = jnp.concatenate([wa_filled, zero_wa, wa_last[None]])

    zero_fl = jnp.zeros((1,) + fl_filled.shape[1:], fl_filled.dtype)
    flux = jnp.concatenate([fl_filled, zero_fl])

    dz = bg.faces[1] - bg.faces[0]
    interior = -(flux[:, 1:] - flux[:, :-1]) / dz
    pad = jnp.zeros((flux.shape[0], 1), dtype=flux.dtype)
    tendency = jnp.concatenate([pad, interior, pad], axis=1)
    return WaveActionDiagnostics(wave_action=wa, flux=flux, tendency=tendency)


def pseudo_momentum_flux(rays, statics, bg: Background, cfg: ModelConfig):
    """Pseudo-momentum flux profile (u, v components) on the center grid —
    the wave→mean-flow observable (``lib/libprop.py:96,146-163``), with the
    same backend and accumulation as the RHS deposit."""
    phase_vol = jnp.abs(statics.dkk * statics.dll * rays.dm)
    cgr = cg_r(rays.k, rays.l, rays.m, rays.phi, cfg.bvf)
    vals = jnp.stack([cgr * rays.k * rays.dens, cgr * rays.l * rays.dens])
    return project_backend(cfg.projection_backend)(
        vals, rays.r - 0.5 * rays.dr, rays.r + 0.5 * rays.dr,
        phase_vol, statics.active, bg.centers, cfg.max_span,
        accum=cfg.flux_accum,
    )

