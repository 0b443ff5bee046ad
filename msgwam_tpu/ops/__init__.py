"""Compute kernels: dispersion/group velocity, interpolation, the ray→grid
projection scatter, and saturation.  All pure jnp/lax, compiled by XLA."""

from .interp import interp, uniform_interp, grid_interp  # noqa: F401
from .dispersion import (  # noqa: F401
    omega,
    group_velocities,
    cg_r,
    wavenumber_tendencies,
)
from .projection import (  # noqa: F401
    project,
    project_backend,
    project_dense,
    project_interfaces,
    project_reference_variant,
    projection_weights,
    required_span,
)
from .saturation import saturation_cap, saturate_direct, saturation_tendency  # noqa: F401
