"""Multi-host: single-process semantics + a real two-process pod test.

The two-process test spawns independent jax.distributed clients (one per
simulated host, 4 virtual CPU devices each) that build the global
8-device mesh and run the sharded codec with cross-process all_gathers
over gloo — the actual pod code path, not a simulation.
"""

import os
import socket
import subprocess
import sys

import jax

from lzma_tpu.parallel import multihost


def test_single_process_identity():
    assert multihost.is_coordinator()
    mesh = multihost.global_mesh()
    assert mesh.devices.size == len(jax.devices())
    assert mesh.axis_names == ("blocks",)


def test_pod_encode_decode_single_process():
    from lzma_tpu.format.properties import LzmaParams

    data = (b"multihost wrapper single process path " * 100)[:3000]
    p = LzmaParams(dict_size=1 << 11, fast_bytes=16)
    blob = multihost.encode_blocks_pod(data, p, block_size=1 << 10)
    assert blob is not None  # single process == coordinator
    assert multihost.decode_blocks_pod(blob) == data


def test_two_process_pod_roundtrip():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(worker))
    env.pop("JAX_PLATFORMS", None)  # worker pins cpu via jax.config
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-2000:]}"
        assert f"worker {i}: OK" in out


def test_two_process_pod_mb_payload():
    """MB-scale payload through the real 2-process all_gather path:
    the cross-process collectives carry
    compressed-payload-sized buffers, not toy KBs."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(worker))
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port), "mb"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-2000:]}"
        assert f"worker {i}: OK" in out
