"""Multi-host setup.

A single host needs nothing — ``jax.devices()`` sees every local card.
For several hosts (BASELINE config 5 at scale), JAX needs one
``jax.distributed.initialize`` per process before first use; this wrapper
standardizes that and returns the global mesh helpers.

Communication pattern stays unchanged: the per-RHS flux ``psum`` stays
within a host; only ensemble members should ever be split across hosts
(members never communicate), so lay the ``('ensemble', 'rays')`` mesh out
with ``ensemble`` as the outer (slower, host-crossing) axis.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-host JAX (no-op if already initialized or if all
    arguments are None and no cluster environment is detected).

    Exercised end-to-end by ``tests/test_distributed.py``: two CPU
    processes, gloo cross-process collectives, a sharded model step."""
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axes: Sequence[int], names: Sequence[str]):
    """Mesh over all global devices; ``ensemble`` (if present) should be the
    first/outermost axis so it maps across hosts."""
    return jax.make_mesh(tuple(axes), tuple(names))


def make_global_sharded(mesh, spec_tree, host_tree):
    """Build globally-sharded arrays from identical host (NumPy) values on
    every process: each process materializes only its addressable shards.

    In a multi-controller run, plain ``device_put`` of host arrays cannot
    produce arrays spanning other processes' devices; this is the standard
    ``make_array_from_callback`` recipe.  Works single-process too.
    """
    import numpy as np
    from jax.sharding import NamedSharding

    def one(spec, host):
        host = np.asarray(host)
        sharding = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            host.shape, sharding, lambda idx: host[idx]
        )

    # PartitionSpec is a pytree leaf, so spec_tree's structure mirrors
    # host_tree's and a plain tree.map pairs them up
    return jax.tree.map(one, spec_tree, host_tree)
