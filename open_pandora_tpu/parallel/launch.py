"""Multi-process launch initialization.

Replaces the reference's `torch.distributed.launch` + NCCL env:// bootstrap
(README.md:76-105, ddp_wrapper.py:8-12, run_mp.sh:66-73). Every process
runs the same program; `jax.distributed.initialize()` wires them from
COORDINATOR_ADDRESS (host:port of process 0), NUM_PROCESSES and PROCESS_ID,
given as arguments or environment variables.

Usage (a no-op for one process, where COORDINATOR_ADDRESS is unset):
    from open_pandora_tpu.parallel.launch import init_distributed
    init_distributed()
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("open_pandora_tpu.launch")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize multi-process JAX. Returns True if a multi-process
    runtime was set up, False for a single process (no-op). A failed
    initialization raises."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if not coordinator:
        return False
    num_processes = num_processes or _env_int("NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError("COORDINATOR_ADDRESS is set: NUM_PROCESSES and "
                         "PROCESS_ID are needed too")
    import jax

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    log.info("distributed: process %d/%d, %d local / %d global devices",
             jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())
    return True


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v else None
