"""Wave-breaking saturation: static-instability cap on wave-action density.

Mirrors the reference ``saturation`` (``lib/libprop.py:561-615``): the ray
state is extrapolated one step forward with the supplied rates
(``lib/libprop.py:591-595``), the saturation threshold

    A_max = κ² · ½ ρ̄(r_f) · ω̂ · N² / (m_f² (ω̂² − f²))     (lib/libprop.py:601)

is compared against the *integrated* action ``dens · (dkk dll dmm_f)``
(``lib/libprop.py:604``), and exceeding rays are clamped (``direct=True``,
``lib/libprop.py:606-610``) or relaxed with tendency ``(A_max − dens)/dt``
(``lib/libprop.py:612-615``).

Reference quirk 1 (SURVEY.md §2): in both branches the cap — an integrated
action — is applied to the *density* without dividing by the phase-space
volume.  ``faithful=True`` (default) reproduces this bit-for-bit;
``faithful=False`` applies the dimensionally consistent ``A_max /
phase_volume``.

Everything is masked ``jnp.where`` — no data-dependent control flow.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import ROT_EARTH
from .dispersion import omega
from .interp import basis_interp, grid_interp


def saturation_cap(
    dt, r, r_rate, dr, dr_rate, k, l, m, m_rate,
    dkk, dll, rr_mm_area,
    centers, rhobar,
    bvf, kappa, phi0,
    interp_backend: str = "gather",
):
    """End-of-step extrapolation + threshold.

    Returns ``(max_dens_final, phase_volume)`` exactly as the reference
    computes them (``lib/libprop.py:591-601``).
    """
    r_final = r + r_rate * dt
    dr_final = dr + dr_rate * dt
    m_final = m + m_rate * dt
    dmm_final = rr_mm_area / dr_final
    if interp_backend == "mxu":
        rhobar_final = basis_interp(
            r_final, centers[0], centers[1] - centers[0], rhobar
        )
    else:
        rhobar_final = grid_interp(r_final, centers, rhobar)

    ff = 2.0 * ROT_EARTH * jnp.sin(phi0)
    omh = omega(k, l, m, phi0, bvf)  # reference uses *pre-step* m and phi0
    phase_volume = dkk * dll * dmm_final

    # GRAD-SAFE singular divisions.  When a ray's m crosses zero within a
    # step, m_final^2 lands in (or below) f32 denormal range — a device
    # that flushes denormals makes it 0, the cap becomes inf, and although the forward is
    # unaffected (an astronomically large cap is never selected by
    # `exceed`), the backward of the division then emits inf * 0 = NaN
    # through the jnp.where cotangent, poisoning every gradient entry
    # (measured: a 1e6-ray 100-step jax.grad, min |m_final| 5.8e-11).
    # The double-where pattern keeps the forward value bit-identical
    # whenever the denominators are healthy (same two divisions, same
    # order) and caps the backward's 1/den^2 factors: thresholds sit
    # where the partials stay comfortably inside f32 range while the
    # guarded caps (>= ~1e21) remain unselectable by any physical
    # density.  `bad` rays get an explicitly infinite cap = "unsaturable
    # this step", which is also the correct m -> 0 physics limit.
    m2 = m_final * m_final
    d2 = omh * omh - ff * ff
    eps = jnp.asarray(1e-14, m2.dtype)
    bad = (m2 <= eps) | (d2 <= eps)
    m2s = jnp.where(m2 <= eps, 1.0, m2)
    d2s = jnp.where(d2 <= eps, 1.0, d2)
    max_dens_final = jnp.where(
        bad, jnp.inf,
        kappa * kappa * 0.5 * rhobar_final * omh * bvf * bvf / m2s / d2s,
    )
    return max_dens_final, phase_volume


def saturate_direct(
    dt, dens, r, r_rate, dr, dr_rate, k, l, m, m_rate,
    dkk, dll, rr_mm_area, centers, rhobar,
    bvf, kappa, phi0,
    faithful: bool = True,
    active=None,
    interp_backend: str = "gather",
):
    """Clamp densities that exceed the cap (``direct=True`` branch,
    ``lib/libprop.py:606-610``).  Returns the new density array."""
    max_dens, phase_vol = saturation_cap(
        dt, r, r_rate, dr, dr_rate, k, l, m, m_rate,
        dkk, dll, rr_mm_area, centers, rhobar, bvf, kappa, phi0,
        interp_backend=interp_backend,
    )
    cap = max_dens if faithful else max_dens / phase_vol
    exceed = max_dens < dens * phase_vol
    if active is not None:
        exceed = exceed & active
    return jnp.where(exceed, cap, dens)


def saturation_tendency(
    dt, dens, r, r_rate, dr, dr_rate, k, l, m, m_rate,
    dkk, dll, rr_mm_area, centers, rhobar,
    bvf, kappa, phi0,
    faithful: bool = True,
    active=None,
    interp_backend: str = "gather",
):
    """Relaxation tendency (non-direct branch, ``lib/libprop.py:612-615``):
    ``(cap − dens)/dt`` on exceeding rays, zero elsewhere."""
    max_dens, phase_vol = saturation_cap(
        dt, r, r_rate, dr, dr_rate, k, l, m, m_rate,
        dkk, dll, rr_mm_area, centers, rhobar, bvf, kappa, phi0,
        interp_backend=interp_backend,
    )
    cap = max_dens if faithful else max_dens / phase_vol
    exceed = max_dens < dens * phase_vol
    if active is not None:
        exceed = exceed & active
    return jnp.where(exceed, (cap - dens) / dt, 0.0)
