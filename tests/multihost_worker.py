"""Worker for the real two-process multi-host test (test_multihost.py).

Each process = one "host": own jax.distributed client, 4 virtual CPU
devices, global 8-device mesh.  Exercises the actual pod code path —
jax.distributed.initialize, global mesh construction, sharded
encode/decode with cross-process all_gathers (gloo over localhost
standing in for ICI/DCN) — not the single-process simulation.
"""

import os
import sys


def main():
    process_id = int(sys.argv[1])
    num_processes = int(sys.argv[2])
    port = sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from lzma_tpu.format.properties import LzmaParams
    from lzma_tpu.parallel import multihost
    from lzma_tpu.parallel.mesh import decode_blocks_mesh, encode_blocks_mesh

    multihost.initialize(f"localhost:{port}", num_processes, process_id)
    assert jax.process_count() == num_processes, jax.process_count()
    assert jax.local_device_count() == 4
    assert jax.device_count() == 4 * num_processes
    assert multihost.is_coordinator() == (process_id == 0)

    if len(sys.argv) > 4 and sys.argv[4] == "mb":
        # MB-scale payload over the REAL cross-process all_gather path
        # 1 MB / 16 x 64 KB blocks over 8 devices,
        # cross-process gloo collectives carrying ~compressed-payload-
        # sized buffers, ordered-concat correctness asserted end-to-end.
        word = bytes((i * 131 + 7) % 256 for i in range(37))
        data = (word * ((1 << 20) // len(word) + 1))[: 1 << 20]
        params = LzmaParams(dict_size=1 << 14, fast_bytes=16)
        mesh = multihost.global_mesh()
        blob = encode_blocks_mesh(data, params, block_size=1 << 16,
                                  mesh=mesh)
        out = decode_blocks_mesh(blob, mesh=mesh)
        assert out == data, "MB-scale pod round-trip mismatch"
        print(f"worker {process_id}: OK", flush=True)
        return

    # deterministic corpus, identical on every process (SPMD input contract)
    word = bytes((i * 37 + 11) % 256 for i in range(23))
    data = (word * 200)[: 1 << 12] * 3  # 12 KB, 12 blocks over 8 devices
    params = LzmaParams(dict_size=1 << 10, fast_bytes=16)

    mesh = multihost.global_mesh()
    assert mesh.devices.size == 4 * num_processes
    blob = encode_blocks_mesh(data, params, block_size=1 << 10, mesh=mesh)
    out = decode_blocks_mesh(blob, mesh=mesh)
    assert out == data, "pod round-trip mismatch"

    # the coordinator-filtered wrappers
    blob2 = multihost.encode_blocks_pod(data, params, block_size=1 << 10)
    if multihost.is_coordinator():
        assert blob2 == blob
    else:
        assert blob2 is None

    # LZTB v2: the shared preset dictionary rides as a replicated
    # shard_map operand — a REAL cross-process broadcast here (gloo
    # standing in for ICI/DCN)
    from lzma_tpu.parallel.blocks import encode_blocks as scalar_encode_blocks

    v2 = scalar_encode_blocks(data, params, block_size=1 << 10,
                              preset_len=1 << 9)
    assert v2[4] == 2, "expected an LZTB v2 container"
    out2 = decode_blocks_mesh(v2, mesh=mesh)
    assert out2 == data, "pod v2 preset round-trip mismatch"

    # pod-level v2 encode: preset broadcast across processes on the
    # encode side too.  NB: no coordinator-only mesh calls here — every
    # collective must run on every process (SPMD), so the check is
    # byte-identity with the scalar container, not another decode.
    v2pod = multihost.encode_blocks_pod(data, params, block_size=1 << 10,
                                        preset_len=1 << 9)
    if multihost.is_coordinator():
        assert v2pod is not None and v2pod[4] == 2
    else:
        assert v2pod is None

    # LZTB v3: a stored TRAINED dictionary broadcast to every process,
    # priming every block (encode and decode sides)
    dictionary = data[256:768]  # deterministic, identical on all hosts
    v3 = scalar_encode_blocks(data, params, block_size=1 << 10,
                              dictionary=dictionary)
    assert v3[4] == 3, "expected an LZTB v3 container"
    out3 = decode_blocks_mesh(v3, mesh=mesh)
    assert out3 == data, "pod v3 trained-dict round-trip mismatch"
    v3pod = multihost.encode_blocks_pod(data, params, block_size=1 << 10,
                                        dictionary=dictionary)
    if multihost.is_coordinator():
        assert v3pod is not None and v3pod[4] == 3
    else:
        assert v3pod is None
    print(f"worker {process_id}: OK", flush=True)


if __name__ == "__main__":
    main()
