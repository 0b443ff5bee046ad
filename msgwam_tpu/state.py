"""State pytrees.

The reference packs the model state into an 11-element ``dtype=object``
ndarray of mixed-shape arrays (``raytracer.py:160-172``, consumed at
``lib/libprop.py:629``) and keeps the background (grid, density profile,
pressure gradient) in module globals (``lib/libprop.py:5-9``).

Here the state is a typed, statically-shaped pytree:

* :class:`RayState`   — the nine per-ray fields, each ``(capacity,)``.
* :class:`MeanState`  — the two mean-flow winds, each ``(n_cell,)``.
* :class:`State`      — (rays, mean); this is exactly the pytree the RK3
  stage arithmetic (``lib/libprop.py:693-698``) operates on.
* :class:`RayStatics` — per-ray constants (the reference's ``statics`` dict,
  ``lib/libprop.py:14-27``) plus the ``active`` mask.  These are *not*
  integrated by RK3.
* :class:`Background` — grid arrays, hydrostatic density, geostrophic
  pressure gradient (``lib/libprop.py:47-82``); immutable per run.

Fixed-capacity masked buffers replace the reference's "rays never die"
model: inactive slots contribute exactly zero to projections and tendencies,
and culling/relaunch are mask flips + slot reuse (static shapes for XLA).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import GridConfig, ModelConfig
from .constants import ROT_EARTH


class RayState(NamedTuple):
    """Per-ray integrated fields, each shape ``(capacity,)``.

    Order and meaning match the reference state vector slots 0-8
    (``raytracer.py:160-169``).
    """

    dens: jax.Array  # phase-space wave-action density N(k,l,m,x,z)
    lam: jax.Array   # longitude [rad]
    phi: jax.Array   # latitude [rad]
    r: jax.Array     # ray-volume center height [m]
    dr: jax.Array    # ray-volume vertical extent [m]
    k: jax.Array     # zonal wavenumber
    l: jax.Array     # meridional wavenumber
    m: jax.Array     # vertical wavenumber (center)
    dm: jax.Array    # ray-volume extent in m


class MeanState(NamedTuple):
    """Mean-flow winds on cell centers, shape ``(n_cell,)``
    (state-vector slots 9-10, ``raytracer.py:170-171``)."""

    u: jax.Array
    v: jax.Array


class State(NamedTuple):
    rays: RayState
    mean: MeanState


class RayStatics(NamedTuple):
    """Per-ray constants + activity mask (not integrated).

    ``dkk``/``dll``/``rr_mm_area`` mirror the reference ``statics`` dict
    (``lib/libprop.py:14-27``, set at ``raytracer.py:105-109``).
    """

    dkk: jax.Array         # ray-volume extent in k, (capacity,)
    dll: jax.Array         # ray-volume extent in l, (capacity,)
    rr_mm_area: jax.Array  # conserved r-m phase-space area, (capacity,)
    active: jax.Array      # bool mask, (capacity,)


class Background(NamedTuple):
    """Immutable background for a run.

    ``rhobar`` per ``lib/libprop.py:47-62``; ``pressure_gradient`` per
    ``lib/libprop.py:65-82`` (geostrophic balance of the *initial* winds).
    """

    faces: jax.Array              # (n_face,) grid faces ("grid")
    centers: jax.Array            # (n_cell,) cell centers ("grids")
    rhobar: jax.Array             # (n_cell,) hydrostatic density
    pressure_gradient: jax.Array  # (2, n_cell)


def coriolis(phi, dtype=None):
    """f = 2 Ω sin φ (``lib/libprop.py:78,382``)."""
    f = 2.0 * ROT_EARTH * jnp.sin(phi)
    return f.astype(dtype) if dtype is not None else f


def make_background(
    grid_cfg: GridConfig,
    cfg: ModelConfig,
    u_init,
    v_init,
    dtype=jnp.float64,
) -> Background:
    """Build the run background.

    Combines ``set_hydrostatics`` (``lib/libprop.py:47-62``) and
    ``set_pressure_gradient`` (``lib/libprop.py:65-82``): exponential (or
    Boussinesq-constant) density on cell centers, and the fixed pressure
    gradient that balances the *initial* winds at latitude ``phi0``.
    """
    # Host-side NumPy arithmetic throughout: init runs once, and NumPy's
    # exp/linspace match the reference bit-for-bit, whereas device
    # transcendentals (XLA exp) differ at
    # the ULP level and seed trajectory divergence through the model's
    # discontinuous saturation clamps (measured round 2: jnp.exp rhobar
    # differed on 12/100 cells; with NumPy init a full 1440-step CPU run
    # is bitwise-reproducible against the reference).
    faces_np = grid_cfg.faces()
    centers_np = grid_cfg.centers()
    if cfg.boussinesq:
        rhobar_np = cfg.rhobar0 * np.ones_like(centers_np)
    else:
        rhobar_np = cfg.rhobar0 * np.exp(-centers_np / cfg.hh)
    ff = 2.0 * ROT_EARTH * np.sin(cfg.phi0)
    u_np = np.asarray(u_init, dtype=np.float64)
    v_np = np.asarray(v_init, dtype=np.float64)
    pressure_gradient = np.stack([rhobar_np * ff * v_np, -rhobar_np * ff * u_np])
    return Background(
        jnp.asarray(faces_np, dtype=dtype),
        jnp.asarray(centers_np, dtype=dtype),
        jnp.asarray(rhobar_np, dtype=dtype),
        jnp.asarray(pressure_gradient, dtype=dtype),
    )


# ---------------------------------------------------------------------------
# pytree arithmetic helpers (the RK3 stage updates, lib/libprop.py:693-698,
# are elementwise over this pytree)
# ---------------------------------------------------------------------------

def tree_add(a, b):
    return jax.tree.map(jnp.add, a, b)


def tree_scale(a, s):
    return jax.tree.map(lambda x: x * s, a)


def tree_axpy(s, x, y):
    """y + s * x, fused elementwise."""
    return jax.tree.map(lambda xi, yi: yi + s * xi, x, y)


def pad_rays(rays: RayState, statics: RayStatics, capacity: int):
    """Pad ray buffers up to ``capacity`` with inactive, numerically safe
    slots (nonzero wavevector so dispersion math stays finite)."""
    n = rays.dens.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < number of rays {n}")
    pad = capacity - n
    if pad == 0:
        return rays, statics

    def pad_field(x, fill):
        return jnp.concatenate([x, jnp.full((pad,), fill, dtype=x.dtype)])

    rays = RayState(
        dens=pad_field(rays.dens, 0.0),
        lam=pad_field(rays.lam, 0.0),
        phi=pad_field(rays.phi, 0.0),
        r=pad_field(rays.r, 0.0),
        dr=pad_field(rays.dr, 1.0),
        k=pad_field(rays.k, 1e-5),
        l=pad_field(rays.l, 0.0),
        m=pad_field(rays.m, -1e-3),
        dm=pad_field(rays.dm, 1e-6),
    )
    statics = RayStatics(
        dkk=pad_field(statics.dkk, 1.0),
        dll=pad_field(statics.dll, 1.0),
        rr_mm_area=pad_field(statics.rr_mm_area, 0.0),
        active=jnp.concatenate(
            [statics.active, jnp.zeros((pad,), dtype=bool)]
        ),
    )
    return rays, statics
