"""Multi-host runtime helpers.

The reference is strictly single-process (SURVEY.md §2.3: communication =
shared memory + thread join). This framework's multi-host story
(SURVEY.md §5 "distributed communication backend"):

- ``initialize()``: `jax.distributed.initialize` wrapper — one JAX process
  per host, the devices of every host visible to each, collectives over
  NVLink within a host and the network across hosts.
- ``shard_files()``: batch mode (BASELINE config 4) shards *files* across
  processes on the data axis — each host filters its own subset, no
  cross-host traffic at all (embarrassingly parallel outer loop).
- Failure model (SURVEY.md §5): fail fast; re-running with the batch
  manifest (pipeline/manifest.py) resumes exactly the remaining files.
"""

from __future__ import annotations

import os


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize the JAX distributed runtime (idempotent, env-driven).

    With no arguments, reads the standard JAX env vars (JAX finds no
    cluster by itself on a plain machine); explicit args mirror `jax.distributed.initialize`.
    """
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # Idempotence only: a repeated initialize is harmless, but any
        # OTHER failure (bad coordinator, join timeout, ...) must surface —
        # silently proceeding single-process would corrupt a multi-host
        # batch's file sharding.
        if "already initialized" in str(e).lower():
            return
        raise


def process_info():
    import jax

    return jax.process_index(), jax.process_count()


def shard_files(paths, process_index: int | None = None,
                process_count: int | None = None):
    """Deterministic round-robin assignment of files to this process."""
    if process_index is None or process_count is None:
        try:
            process_index, process_count = process_info()
        except Exception:
            process_index, process_count = 0, 1
    return [p for i, p in enumerate(paths) if i % process_count == process_index]
