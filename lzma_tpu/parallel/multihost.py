"""Multi-host pod-slice scaling (SURVEY §5.8's prescribed design).

One process per host; `initialize()` wires jax.distributed so
`jax.devices()` spans the slice, and the same block-data-parallel
shard_map pipeline (parallel/mesh.py) runs unchanged: all_gathers ride ICI
within a slice and DCN across slices.  Input distribution and final
ordered concat stay on host 0 (process_index 0) — the natural layout for
a file codec.

Validated three ways on a single host: the 8-virtual-device mesh
tests, the driver's dryrun_multichip, and a REAL two-process
jax.distributed run (tests/test_multihost.py::test_two_process_pod_roundtrip
— two clients, 4 virtual CPU devices each, cross-process all_gathers over
gloo standing in for ICI/DCN).
"""

from __future__ import annotations

import jax
import numpy as np

from ..format.properties import LzmaParams
from .mesh import decode_blocks_mesh, encode_blocks_mesh, make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the distributed job (idempotent).  With no args, JAX looks
    for a cluster it can detect on its own (a managed cluster's
    environment); on plain GPU hosts pass coordinator_address
    (host:port), num_processes and process_id explicitly.

    Must run before anything initializes the XLA backend — so the check
    uses jax.distributed.is_initialized(), NOT jax.process_count() (which
    would itself initialize the backend and poison the real init).
    """
    if jax.distributed.is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def global_mesh():
    """Mesh over every chip in the slice (all hosts)."""
    return make_mesh(jax.devices())


def is_coordinator() -> bool:
    return jax.process_index() == 0


def encode_blocks_pod(data: bytes, params: LzmaParams | None = None,
                      block_size: int = 1 << 18,
                      preset_len: int = 0,
                      dictionary: bytes = b"") -> bytes | None:
    """Pod-wide block-parallel encode.  Every process must call this with
    identical arguments (SPMD); the container is returned on the
    coordinator and None elsewhere.  `preset_len` writes LZTB v2 — the
    shared dictionary is broadcast to every chip on every host;
    `dictionary` writes LZTB v3 (stored trained dictionary, same
    broadcast, every block primed)."""
    blob = encode_blocks_mesh(data, params, block_size=block_size,
                              mesh=global_mesh(), preset_len=preset_len,
                              dictionary=dictionary)
    return blob if is_coordinator() else None


def decode_blocks_pod(blob) -> bytes | None:
    out = decode_blocks_mesh(blob, mesh=global_mesh())
    return out if is_coordinator() else None
