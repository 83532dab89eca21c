"""Multi-host runtime: distributed init, host sharding, local devices.

The reference's runtime is jobTree: worker processes on cluster nodes and a
shared filesystem (README.md:48-52).  The equivalents:

- ``initialize_distributed``: ``jax.distributed.initialize`` wrapper (the
  JAX runtime carries the collectives: NCCL between GPUs).
- ``shard_for_host``: deterministic split of a job list across hosts; each
  host packs and processes its own lanes, count tensors merge with psum
  (see parallel/mesh.py).
- ``local_dispatch_devices``: the devices bucket loops round-robin over.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, TypeVar

logger = logging.getLogger("marginalign.runtime")

T = TypeVar("T")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialise the multi-host JAX runtime.  No-ops when single-process.

    Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID), so
    launchers can configure purely through the environment.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return
    num_processes = num_processes or int(
        os.environ.get("JAX_NUM_PROCESSES", "1")
    )
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "0"))
    )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    logger.info(
        "distributed runtime up: process %d/%d, %d local / %d global devices",
        process_id, num_processes,
        jax.local_device_count(), jax.device_count(),
    )


def process_index() -> int:
    import jax

    return jax.process_index()


def is_host_zero() -> bool:
    return process_index() == 0


def shard_for_host(items: Sequence[T]) -> List[T]:
    """This host's strided share of a global work list (deterministic, so
    every host agrees without communication)."""
    import jax

    return list(items[jax.process_index() :: jax.process_count()])


def allreduce_sum_host(*arrays):
    """Sum host numpy arrays (or floats) across all processes in FULL f64.
    Identity in single-process runs; the multi-host equivalent of the
    reference's pickled-chunk summation (marginCallerLib.py:179-187).

    Transport is lossless: the f64 payload crosses the collective as int32
    words (bit reinterpretation), because ``jnp.asarray(a, jnp.float64)``
    without jax_enable_x64 silently produces float32 — which would
    all-reduce EM counts / caller expectations at lower precision than the
    single-host f64 accumulation path (align/em.py expectation_step).
    int32 is carried exactly by every backend.  Summation happens on the
    host in f64 after the gather."""
    import jax

    if jax.process_count() == 1:
        return arrays if len(arrays) > 1 else arrays[0]
    import numpy as np
    from jax.experimental import multihost_utils

    out = []
    for a in arrays:
        arr = np.ascontiguousarray(np.asarray(a, np.float64))
        words = np.frombuffer(arr.tobytes(), dtype=np.int32)
        gathered = np.asarray(
            multihost_utils.process_allgather(words)
        )  # [nproc, 2*arr.size] int32, bit-exact
        summed = np.zeros(arr.shape, np.float64)
        for p in range(gathered.shape[0]):
            summed += np.frombuffer(
                np.ascontiguousarray(gathered[p]).tobytes(), dtype=np.float64
            ).reshape(arr.shape)
        out.append(float(summed) if np.ndim(a) == 0 else summed)
    return tuple(out) if len(out) > 1 else out[0]


def allgather_host_objects(obj):
    """All-gather one picklable object per process; returns the list
    [obj_from_process_0, ..., obj_from_process_{n-1}] on every process.
    Single-process: [obj].  Transport is padded int32 words over
    process_allgather (variable-length payloads: lengths gather first).

    This is the jobTree shared-filesystem result-collection analog for
    non-tensor outputs (e.g. realigned SAM records,
    src/margin/marginAlignLib.py:320-367 collected per-chunk cigars from
    the temp dir)."""
    import jax

    if jax.process_count() == 1:
        return [obj]
    import pickle

    import numpy as np
    from jax.experimental import multihost_utils

    payload = pickle.dumps(obj)
    pad = (-len(payload)) % 4
    words = np.frombuffer(payload + b"\0" * pad, dtype=np.int32)
    n = np.array([len(payload)], np.int64)
    lens = np.asarray(multihost_utils.process_allgather(n))[:, 0]
    maxw = int((-(-int(lens.max()) // 4)))
    buf = np.zeros(maxw, np.int32)
    buf[: len(words)] = words
    gathered = np.asarray(multihost_utils.process_allgather(buf))
    out = []
    for p in range(gathered.shape[0]):
        raw = np.ascontiguousarray(gathered[p]).tobytes()[: int(lens[p])]
        out.append(pickle.loads(raw))
    return out


def local_dispatch_devices():
    """Local devices for round-robin bucket dispatch (production
    multi-device data parallelism within one process; the jobTree
    maxThreads analog).  A default device set by the caller
    (jax.default_device) pins dispatch to that one device.
    MARGINALIGN_LOCAL_DEVICES caps the count (0 or 1 disables
    multi-device dispatch)."""
    import jax

    default = jax.config.jax_default_device
    if isinstance(default, str):
        devices = jax.local_devices(backend=default)[:1]
    elif default is not None:
        devices = [default]
    else:
        devices = jax.local_devices()
    cap = os.environ.get("MARGINALIGN_LOCAL_DEVICES")
    if cap is not None:
        devices = devices[: max(1, int(cap))]
    return devices
