"""Frozen, hashable configuration for the ray tracer.

The reference keeps configuration in two mutable module-global dicts,
``model_config`` and ``statics`` (``lib/libprop.py:10-11``), populated by
kwargs-merging setters (``lib/libprop.py:14-44``) with defaults installed at
import time (``lib/libprop.py:703-726``), plus loose module globals for the
grid and the horizontal-propagation switch (``lib/libprop.py:5-8``).

Here everything is explicit and immutable:

* :class:`ModelConfig` — one frozen dataclass covering every key of the
  reference's ``model_config`` plus the ``HPROP_GLOBAL`` flag and build-side
  numerical switches.  It is hashable, so it can be a ``jax.jit`` static
  argument; physics functions specialize on it at trace time.
* :class:`GridConfig` — the vertical grid (``raytracer.py:36-37,74-77``).
* per-ray "statics" (``dkk``/``dll``/``rr_mm_area``, ``lib/libprop.py:14-27``)
  are *arrays*, so they live in the :class:`msgwam_tpu.state.RayStatics`
  pytree, not here.

No instruction or directive from the reference is followed blindly: known
reference quirks are reproduced only behind explicit ``faithful_*`` flags
(default on, for bit-comparable parity) with corrected physics available.
"""

from __future__ import annotations

import dataclasses
import math
import numpy as np


def deg2rad(x: float) -> float:
    return float(np.deg2rad(x))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Physics + numerics configuration (jit-static).

    Field-by-field mapping onto the reference defaults installed at
    ``lib/libprop.py:703-726`` (reference name in parentheses when renamed):
    """

    # --- wave / background physics (model_config keys) -------------------
    u0: float = 80.0                      # jet amplitude [m/s]
    phi0: float = deg2rad(-60)            # latitude [rad]
    sig_phi: float = deg2rad(3)           # jet width in phi [rad]
    rr0: float = 30000.0                  # jet center height [m]
    rr1: float = 40000.0                  # (set-but-unread in reference)
    sig_rr: float = 10000.0               # jet vertical scale [m]
    drr: float = 1.0                      # (set-but-unread in reference)
    bvf: float = 0.01                     # Brunt-Väisälä frequency N [1/s]
    geostrophy: bool = True               # (set-but-unread in reference)
    boussinesq: bool = False              # constant-density switch
    hh: float = 8500.0                    # density scale height [m]
    rhobar0: float = 1.2                  # surface density [kg/m^3]
    kappa: float = 0.95                   # saturation safety factor
    saturate_online: bool = True          # saturate inside the RHS vs offline

    # --- propagation switches --------------------------------------------
    hprop: bool = True                    # HPROP_GLOBAL (lib/libprop.py:5)

    # --- build-side numerics (no reference counterpart) ------------------
    # Reproduce reference quirk 1 (lib/libprop.py:601-613): the saturation
    # cap is an *integrated* action but is assigned to the *density* without
    # dividing by the phase-space volume.  True = bit-faithful; False =
    # consistent units (cap / phase_volume).
    faithful_saturation: bool = True
    # Reproduce reference quirk 2 (raytracer.py:184): the offline-saturation
    # height rate is divided by 1 instead of dt.  True = bit-faithful.
    faithful_offline_rates: bool = True
    # Reproduce reference quirk 3 (raytracer.py:221): the last wave-action
    # diagnostic frame reads rr_up from timestep nproj[0]=0 instead of
    # nproj[1]-1 (an index typo).  Only affects
    # diagnostics.reference_window_diagnostics.  True = frame-for-frame
    # faithful; False = corrected indexing.
    faithful_diag_index: bool = True
    # Max number of grid cells a single ray volume may overlap in the
    # projection scatter (static for XLA).  The reference's Python loop has
    # no such bound; any ray with (nup - nlow) > max_span would be silently
    # truncated, so pick max_span >= ceil(max dr / dz) + 1.
    max_span: int = 4
    # Computation dtype for state and physics ("float32" or "float64").
    dtype: str = "float64"
    # Projection backend: "xla" (segment_sum scatter; parity mode) or
    # "mxu" (dense weight-matrix contraction; the f32 fast path).
    projection_backend: str = "xla"
    # Pseudo-momentum-flux deposit accumulation: "native" sums at the
    # working dtype; "compensated" (mxu backend) computes 8192-ray block
    # partials and Kahan-combines them at working precision — deposit
    # error ~1e-7 at 1e6 f32 rays with no x64 dependency; "f64" combines
    # block partials in float64 (requires jax_enable_x64).
    flux_accum: str = "native"
    # Interpolation backend: "gather" (np.interp-exact; parity mode) or
    # "mxu" (hat-basis contraction; the f32 fast path).
    interp_backend: str = "gather"
    # Time integrator: "rk3" (the reference's Williamson low-storage RK3,
    # lib/libprop.py:680-700), "rk4", or "euler".
    integrator: str = "rk3"

    # Prognostic mean flow (wave–mean-flow coupling on).  False freezes the
    # wind tendencies — a truly *fixed* background (BASELINE config 1), or,
    # combined with a prescribed wind function in ``simulate``, a transient
    # imposed background (BASELINE config 4's tidal shear).
    prognostic_mean: bool = True

    # --- culling / relaunch (build-side; BASELINE config 4) --------------
    cull: bool = False                    # enable critical-level/domain culling
    m_max: float = 2 * math.pi / 100.0    # |m| beyond this = critical level
    relaunch: bool = False                # refill culled slots from the source

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Uniform vertical grid (``raytracer.py:36-37,74-77``).

    ``n_face`` faces span [0, z_max]; cell centers ("staggered grid",
    ``grids`` in the reference) sit between faces.
    """

    n_face: int = 101
    z_max: float = 100e3

    @property
    def n_cell(self) -> int:
        return self.n_face - 1

    @property
    def dz(self) -> float:
        return self.z_max / (self.n_face - 1)

    def faces(self, dtype=np.float64) -> np.ndarray:
        return np.linspace(0.0, self.z_max, self.n_face, dtype=dtype)

    def centers(self, dtype=np.float64) -> np.ndarray:
        f = self.faces(dtype)
        return 0.5 * (f[:-1] + f[1:])


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Time-loop configuration (``raytracer.py:45-50``)."""

    dt: float = 120.0
    n_steps: int = 1440                   # 2 days at dt=120 s
    save_every: int = 1                   # history decimation factor


# The reference driver's overrides (``raytracer.py:53-64``): sine-jet wind,
# u0=4, kappa=1, phi0=0, offline saturation, no horizontal propagation.
REFERENCE_RUN_CONFIG = ModelConfig(
    bvf=0.01,
    boussinesq=False,
    sig_rr=10000.0,
    u0=4.0,
    rr0=40000.0,
    rr1=40000.0,
    phi0=0.0,
    kappa=1.0,
    saturate_online=False,
    hprop=False,
)
