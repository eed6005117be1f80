"""Mesh-sharded block-parallel codec on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.parallel.mesh import decode_blocks_mesh, encode_blocks_mesh, make_mesh
from lzma_tpu.parallel import blocks as blk


def _data(n=24_000, seed=3):
    rng = np.random.default_rng(seed)
    words = [rng.integers(0, 256, int(rng.integers(4, 24)), dtype=np.uint8).tobytes() for _ in range(40)]
    out = bytearray()
    while len(out) < n:
        out.extend(words[int(rng.integers(0, 40))])
    return bytes(out[:n])


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(jax.devices()[:8])


def test_mesh_roundtrip(mesh):
    data = _data()
    p = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    blob = encode_blocks_mesh(data, p, block_size=1 << 11, mesh=mesh)
    assert decode_blocks_mesh(blob, mesh=mesh) == data


def test_mesh_container_is_standard(mesh):
    """Mesh-encoded containers decode on the scalar block path and vice versa."""
    data = _data(10_000, seed=4)
    p = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    blob = encode_blocks_mesh(data, p, block_size=1 << 11, mesh=mesh)
    assert blk.decode_blocks(blob) == data          # scalar decodes mesh output
    blob2 = blk.encode_blocks(data, p, block_size=1 << 11)
    assert decode_blocks_mesh(blob2, mesh=mesh) == data  # mesh decodes scalar output


def test_mesh_uneven_blocks(mesh):
    """Block count not divisible by device count (padding lanes)."""
    data = _data(13_077, seed=5)
    p = LzmaParams(dict_size=1 << 11, fast_bytes=16)
    blob = encode_blocks_mesh(data, p, block_size=1 << 11, mesh=mesh)  # 7 blocks on 8 devs
    assert decode_blocks_mesh(blob, mesh=mesh) == data


def test_mesh_subset_device_counts():
    for nd in (1, 2, 4):
        mesh = make_mesh(jax.devices()[:nd])
        data = _data(6_000, seed=nd)
        p = LzmaParams(dict_size=1 << 11, fast_bytes=16)
        blob = encode_blocks_mesh(data, p, block_size=1 << 11, mesh=mesh)
        assert decode_blocks_mesh(blob, mesh=mesh) == data


def test_mesh_decode_pallas_ring(mesh, triton_interpret):
    """The Triton decode kernel runs per shard under shard_map
    (interpret mode on the CPU mesh), same container, same bytes."""
    data = _data(9_000, seed=9)
    p = LzmaParams(dict_size=1 << 11, fast_bytes=16)
    blob = encode_blocks_mesh(data, p, block_size=1 << 11, mesh=mesh)
    assert decode_blocks_mesh(blob, mesh=mesh) == data


def test_mesh_decode_pallas_ring_dictionary(mesh, triton_interpret):
    """LZTB v3 stored dictionary broadcast + per-shard Triton decode."""
    data = _data(9_000, seed=10)
    p = LzmaParams(dict_size=1 << 11, fast_bytes=16)
    blob = encode_blocks_mesh(data, p, block_size=1 << 11, mesh=mesh,
                              dictionary=data[:512])
    assert decode_blocks_mesh(blob, mesh=mesh) == data


def test_mesh_encode_pallas_serializer(mesh, request):
    """Each shard's range coding runs the Triton kernel (interpret mode
    on the CPU mesh); the container is identical to the XLA coder's."""
    data = _data(9_000, seed=11)
    p = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    blob_xla = encode_blocks_mesh(data, p, block_size=1 << 11, mesh=mesh)
    request.getfixturevalue("triton_interpret")
    blob = encode_blocks_mesh(data, p, block_size=1 << 11, mesh=mesh)
    assert blk.decode_blocks(blob) == data
    assert blob == blob_xla


def test_mesh_encode_pallas_dictionary(mesh, triton_interpret):
    data = _data(9_000, seed=12)
    p = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    blob = encode_blocks_mesh(data, p, block_size=1 << 11, mesh=mesh,
                              dictionary=data[:512])
    assert blk.decode_blocks(blob) == data


def test_mesh_gather_true_single_process(mesh):
    """The multi-host gather-to-all path (gather=True: all_gather of the
    ragged results) must stay covered by a single-process test — before
    round 3 only the 3 KB two-process test exercised it at all
   ."""
    data = _data(20_000, seed=7)
    p = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    blob_g = encode_blocks_mesh(data, p, block_size=1 << 11, mesh=mesh,
                                gather=True)
    blob_s = encode_blocks_mesh(data, p, block_size=1 << 11, mesh=mesh,
                                gather=False)
    # both gather designs must produce the identical container
    assert blob_g == blob_s
    assert decode_blocks_mesh(blob_g, mesh=mesh, gather=True) == data
    assert decode_blocks_mesh(blob_g, mesh=mesh, gather=False) == data


def test_mesh_hybrid_optimal_flagship(mesh):
    """The flagship encode over the mesh: sharded candidate search +
    host optimal parse.  Must produce the IDENTICAL container to the
    single-device hybrid-optimal encoder (same lists, same parse), and
    decode everywhere."""
    pytest.importorskip("jax")
    from lzma_tpu.runtime import native

    if not native.available():
        pytest.skip("needs the native runtime")
    from lzma_tpu.ops.hybrid import encode_blocks_hybrid_optimal
    from lzma_tpu.parallel.mesh import encode_blocks_mesh_hybrid

    data = _data(40_000, seed=11)
    p = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    blob_m = encode_blocks_mesh_hybrid(data, p, block_size=1 << 12,
                                       mesh=mesh)
    blob_1 = encode_blocks_hybrid_optimal(data, p, block_size=1 << 12)
    assert blob_m == blob_1
    assert blk.decode_blocks(blob_m) == data
    # gather=True (the multi-host path) must produce the same container
    blob_g = encode_blocks_mesh_hybrid(data, p, block_size=1 << 12,
                                       mesh=mesh, gather=True)
    assert blob_g == blob_m


def test_mesh_optimal_parse_container_identical(mesh):
    """parse="optimal" over the mesh: the DP tokenizer runs inside
    shard_map and the container is BYTE-IDENTICAL to the single-device
    device backend at the same parse (container-identity across
    mesh/single)."""
    from lzma_tpu.ops import api as dev

    data = _data(16_000, seed=9)
    p = LzmaParams(dict_size=1 << 11, fast_bytes=16)
    blob_mesh = encode_blocks_mesh(data, p, block_size=1 << 11, mesh=mesh,
                                   parse="optimal")
    assert decode_blocks_mesh(blob_mesh, mesh=mesh) == data
    blob_single = dev.encode_blocks(data, p, block_size=1 << 11,
                                    parse="optimal")
    assert blob_mesh == blob_single
    # (no ratio assertion here: at 2 KB blocks the per-block empirical
    # statistics are too thin and the DP can lose to lazy — its wins are
    # measured at realistic block sizes)
