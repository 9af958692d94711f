"""Multi-host execution: distributed init, host-sharded input, merged results.

The reference is a single process with no communication of any kind
(SURVEY.md §2/§5: "Distributed communication backend: Absent").  Across
hosts the engine runs one Python process per host, each owning that
host's devices; this module is the thin host-side layer that makes the rest
of the engine host-count agnostic:

* :func:`initialize` — idempotent ``jax.distributed.initialize`` wrapper
  (explicit coordinator/process args, or fully env-driven on platforms
  that auto-detect).  After it returns, ``jax.devices()`` spans every
  host; a :class:`~jax.sharding.Mesh` built over it lays the batch axis
  over every host's devices.
* **Host-sharded input** — :func:`owns_chunk` deals the runner's resumable
  chunks round-robin over processes, so each host streams only its share
  of the pair file; :func:`part_path` gives each process its own output
  shard + manifest (no cross-host file contention).
* **Merged results** — the device-side merge is
  :func:`globalign_jax.parallel.mesh.sharded_fill_costs`, whose
  ``lax.all_gather`` over the batch axis replicates every pair's final
  lanes to every process (each host can read the full result without
  touching another host's device memory).

Tested without hardware by a 2-process CPU harness
(tests/test_multihost.py): two OS processes, four virtual devices each,
real Gloo collectives between them — the same code path a multi-host
GPU cluster runs over its interconnect.
"""

from __future__ import annotations

from pathlib import Path

_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> tuple[int, int]:
    """Join (or start) the multi-process JAX runtime; returns (pid, count).

    Calling this is the explicit opt-in to multi-process mode (the CLI's
    ``--distributed``), so ``jax.distributed.initialize`` ALWAYS runs:
    with arguments all None it auto-detects the cluster (SLURM, ...)
    and raises loudly on platforms with nothing to detect — better than silently running every chunk on every host.
    Safe to call more than once (later calls return the cached runtime).
    """
    import jax

    global _initialized
    if not _initialized:
        kwargs = {}
        if coordinator_address is not None:
            kwargs["coordinator_address"] = coordinator_address
        if num_processes is not None:
            kwargs["num_processes"] = int(num_processes)
        if process_id is not None:
            kwargs["process_id"] = int(process_id)
        if local_device_ids is not None:
            kwargs["local_device_ids"] = local_device_ids
        jax.distributed.initialize(**kwargs)
        _initialized = True
    return jax.process_index(), jax.process_count()


def process_info() -> tuple[int, int]:
    """(process_index, process_count) of the current runtime."""
    import jax

    return jax.process_index(), jax.process_count()


def owns_chunk(chunk_id: int, process_id: int, num_processes: int) -> bool:
    """Round-robin deal of resumable chunks over host processes."""
    if num_processes <= 1:
        return True
    return chunk_id % num_processes == process_id


def part_path(output, process_id: int, num_processes: int) -> Path:
    """Per-process output shard path (``<output>.part<k>`` when P > 1).

    Each process appends results and journals its own manifest; shards
    concatenate into the single-process output (row indices are global).
    """
    output = Path(output)
    if num_processes <= 1:
        return output
    return output.with_name(output.name + f".part{process_id}")
