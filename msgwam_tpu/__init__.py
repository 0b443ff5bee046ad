"""msgwam-tpu: Lagrangian phase-space ray tracing of atmospheric internal
gravity waves in JAX/XLA.

A from-scratch framework with the capabilities of the NumPy reference
``python-msgwam`` (see SURVEY.md): ray volumes carrying wave-action density
through (z, m) phase space, refracting in a sheared mean flow, saturating at
the static-instability threshold, and feeding momentum back to the mean flow
— expressed as a ``lax.scan`` over fixed-capacity masked ray buffers, with a
segment-sum or dense-contraction projection and ``shard_map``/``psum``
scaling over device meshes.
"""

from .config import GridConfig, ModelConfig, RunConfig, REFERENCE_RUN_CONFIG  # noqa: F401
from .constants import RAD_EARTH, ROT_EARTH  # noqa: F401
from .state import (  # noqa: F401
    Background,
    MeanState,
    RayState,
    RayStatics,
    State,
    coriolis,
    make_background,
    pad_rays,
)
from .models import (  # noqa: F401
    cull,
    gaussian_spectrum_source,
    relaunch,
    rhs,
    rk3_step,
    simulate,
    step,
    williamson_rk3,
    tidal_shear,
    velocities_gauss_homogeneous,
    velocities_sine_homogeneous,
    velocities_tanh,
    velocities_tanh_homogeneous,
    wave_packet_ic,
)
from .ops import (  # noqa: F401
    cg_r,
    group_velocities,
    grid_interp,
    interp,
    omega,
    project,
    project_reference_variant,
    saturate_direct,
    saturation_tendency,
    uniform_interp,
    wavenumber_tendencies,
)

__version__ = "0.1.0"
