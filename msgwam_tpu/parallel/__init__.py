"""Multi-chip scaling: ray-axis sharding over a device mesh and ensemble
fan-out.  No reference counterpart — the reference is one Python process on
one CPU core (SURVEY.md §2 rows 21-22)."""

from .sharding import (  # noqa: F401
    build_sharded_simulate_fn,
    full_history_observe,
    full_history_observe_spec,
    make_mesh,
    ray_sharding_specs,
    shard_state,
    sharded_simulate,
    sharded_step_fn,
)
from .ensemble import build_ensemble_fn, ensemble_simulate, stack_ensemble  # noqa: F401
from .distributed import initialize as initialize_distributed, global_mesh  # noqa: F401
