"""Preset-dictionary support (LZTB v2 shared dictionary).

The reference has no preset API (SURVEY.md §0 non-goals); this is the
shared-dictionary half of the block-parallel scaling design: blocks stay
independent (parallel decode preserved) while a broadcast preset window
recovers ratio lost to chunking.  Scalar and native implementations must
be byte-identical and cross-decodable.
"""

import pytest

from lzma_tpu.codec.decoder import decode_stream as s_dec
from lzma_tpu.codec.encoder import encode_stream as s_enc
from lzma_tpu.core.rangecoder import CorruptStreamError
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.parallel import blocks as blk


def _repetitive(n=60_000, seed=5, period=97):
    import numpy as np

    rng = np.random.default_rng(seed)
    word = rng.integers(0, 256, period, dtype=np.uint8).tobytes()
    return (word * (n // period + 1))[:n]


def _mixed(n=60_000, seed=6):
    import numpy as np

    rng = np.random.default_rng(seed)
    rep = _repetitive(n // 2, seed=seed)
    rnd = rng.integers(0, 256, n - len(rep), dtype=np.uint8).tobytes()
    return rep + rnd


def _native_or_skip():
    native = pytest.importorskip("lzma_tpu.runtime.native")
    if not native.available():
        pytest.skip("native runtime unavailable")
    return native


PARAMS = LzmaParams(dict_size=1 << 16, fast_bytes=32)


@pytest.mark.parametrize("mf,mode", [
    ("bt4", "optimal"), ("bt2", "optimal"), ("hc4", "greedy"), ("bt4", "lazy"),
])
def test_scalar_preset_round_trip(mf, mode):
    p = LzmaParams(dict_size=1 << 16, fast_bytes=32, match_finder=mf)
    data = _mixed(20_000)
    preset = _repetitive(4_000)
    comp = s_enc(data, p, mode=mode, preset=preset)
    assert s_dec(comp, p, out_size=len(data), preset=preset) == data
    # a preset built from the data itself must shrink the stream
    comp2 = s_enc(data, p, mode=mode, preset=data[:4096])
    assert len(comp2) < len(s_enc(data, p, mode=mode))
    assert s_dec(comp2, p, out_size=len(data), preset=data[:4096]) == data


def test_scalar_preset_eos_round_trip():
    p = LzmaParams(dict_size=1 << 16, fast_bytes=32, write_eos=True)
    data = _mixed(10_000)
    preset = data[:2048]
    comp = s_enc(data, p, preset=preset)
    assert s_dec(comp, p, out_size=-1, preset=preset) == data


def test_empty_preset_is_plain_stream():
    data = _mixed(5_000)
    assert s_enc(data, PARAMS, preset=b"") == s_enc(data, PARAMS)


@pytest.mark.parametrize("mf,mode", [
    ("bt4", "optimal"), ("bt2", "optimal"), ("hc4", "greedy"), ("bt4", "lazy"),
])
def test_native_matches_scalar(mf, mode):
    native = _native_or_skip()
    p = LzmaParams(dict_size=1 << 16, fast_bytes=32, match_finder=mf)
    data = _mixed(30_000)
    preset = _repetitive(5_000, seed=11)
    a = s_enc(data, p, mode=mode, preset=preset)
    b = native.encode_stream(data, p, mode=mode, preset=preset)
    assert a == b
    assert native.decode_stream(a, p, len(data), preset=preset) == data
    assert s_dec(b, p, out_size=len(data), preset=preset) == data


def test_native_preset_wrong_preset_fails_or_differs():
    native = _native_or_skip()
    data = _repetitive(20_000)
    preset = data[:4096]
    comp = native.encode_stream(data, PARAMS, preset=preset)
    try:
        wrong = native.decode_stream(comp, PARAMS, len(data), preset=bytes(4096))
        assert wrong != data  # garbage in, garbage (or error) out
    except CorruptStreamError:
        pass


def test_container_v2_round_trip_native():
    native = _native_or_skip()
    data = _repetitive(200_000)
    plain = native.encode_blocks(data, PARAMS, block_size=1 << 15)
    pre = native.encode_blocks(data, PARAMS, block_size=1 << 15, preset_len=1 << 14)
    assert pre[4] == blk.VERSION_PRESET
    assert len(pre) < len(plain)  # shared dictionary must pay for itself here
    assert native.decode_blocks(pre) == data
    assert native.decode_blocks(pre, num_threads=2) == data


def test_container_v2_scalar_native_identical():
    native = _native_or_skip()
    data = _mixed(120_000)
    a = blk.encode_blocks(data, PARAMS, block_size=1 << 15, preset_len=1 << 13)
    b = native.encode_blocks(data, PARAMS, block_size=1 << 15, preset_len=1 << 13)
    assert a == b
    assert blk.decode_blocks(b, num_threads=2) == data
    assert native.decode_blocks(a) == data


def test_container_v2_parse_fields():
    data = _mixed(100_000)
    pre = blk.encode_blocks(data, PARAMS, block_size=1 << 15, preset_len=1 << 13)
    frame = blk.parse_container(pre)
    assert frame.preset_len == 1 << 13
    assert frame.block_size == 1 << 15
    assert frame.total_size == len(data)


def test_preset_len_clamped_to_block0():
    data = _mixed(50_000)
    pre = blk.encode_blocks(data, PARAMS, block_size=1 << 14, preset_len=1 << 20)
    frame = blk.parse_container(pre)
    assert frame.preset_len == 1 << 14  # clamped to one block
    assert blk.decode_blocks(pre) == data


def test_corrupt_preset_len_rejected():
    data = _mixed(50_000)
    pre = bytearray(blk.encode_blocks(data, PARAMS, block_size=1 << 14,
                                      preset_len=1 << 12))
    # preset_len field sits right after the fixed header
    blk._PRESET_FIELD.pack_into(pre, blk._HEAD.size, (1 << 14) + 1)
    with pytest.raises(CorruptStreamError):
        blk.parse_container(bytes(pre))


def test_v1_still_parses():
    data = _mixed(40_000)
    v1 = blk.encode_blocks(data, PARAMS, block_size=1 << 14)
    assert v1[4] == blk.VERSION
    frame = blk.parse_container(v1)
    assert frame.preset_len == 0
    assert blk.decode_blocks(v1) == data


def test_device_backend_decodes_preset_containers():
    p = LzmaParams(dict_size=1 << 14, fast_bytes=32)
    data = _repetitive(30_000, seed=13)
    pre = blk.encode_blocks(data, p, block_size=1 << 12, preset_len=1 << 11)
    from lzma_tpu.ops import api as dev

    assert dev.decode_blocks(pre) == data


def test_hybrid_preset_round_trip():
    native = _native_or_skip()
    from lzma_tpu.ops import api as dev
    from lzma_tpu.ops.hybrid import encode_blocks_hybrid

    p = LzmaParams(dict_size=1 << 14, fast_bytes=32)
    data = _repetitive(30_000, seed=21)
    v2 = encode_blocks_hybrid(data, p, block_size=1 << 12, preset_len=1 << 11)
    assert v2[4] == blk.VERSION_PRESET
    assert native.decode_blocks(v2) == data
    assert blk.decode_blocks(v2) == data
    v1 = encode_blocks_hybrid(data, p, block_size=1 << 12)
    assert len(v2) < len(v1)
    # same tokens, same serializer semantics: hybrid == all-device output
    assert v2 == dev.encode_blocks(data, p, block_size=1 << 12,
                                   preset_len=1 << 11)


def test_pallas_preset_round_trip(triton_interpret):
    p = LzmaParams(dict_size=1 << 13, fast_bytes=32)
    data = _repetitive(16_000, seed=19)
    from lzma_tpu.ops import api as dev

    v2 = dev.encode_blocks(data, p, block_size=1 << 12, preset_len=1 << 11)
    assert v2[4] == blk.VERSION_PRESET
    assert dev.decode_blocks(v2) == data
    assert blk.decode_blocks(v2) == data


def test_mesh_decodes_preset_containers():
    p = LzmaParams(dict_size=1 << 14, fast_bytes=32)
    data = _repetitive(30_000, seed=14)
    pre = blk.encode_blocks(data, p, block_size=1 << 12, preset_len=1 << 11)
    from lzma_tpu.parallel.mesh import decode_blocks_mesh

    assert decode_blocks_mesh(pre) == data


def test_device_decode_batch_preset_bit_exact():
    from lzma_tpu.ops.device_decoder import decode_batch

    p = LzmaParams(dict_size=1 << 14, fast_bytes=32)
    preset = _repetitive(2_000, seed=15)
    blocks = [_mixed(3_000 + 577 * i, seed=20 + i) for i in range(3)]
    streams = [s_enc(b, p, preset=preset) for b in blocks]
    outs = decode_batch(streams, p, [len(b) for b in blocks], preset=preset)
    assert outs == blocks


def test_device_encode_batch_preset_cross_decodes():
    from lzma_tpu.ops.device_encoder import encode_batch

    p = LzmaParams(dict_size=1 << 14, fast_bytes=32)
    preset = _repetitive(1_500, seed=16)
    blocks = [_repetitive(2_500 + 333 * i, seed=16) for i in range(3)]
    plain = encode_batch(blocks, p)
    pre = encode_batch(blocks, p, preset=preset)
    assert sum(map(len, pre)) < sum(map(len, plain))
    for s, b in zip(pre, blocks):
        assert s_dec(s, p, out_size=len(b), preset=preset) == b
    native = _native_or_skip()
    for s, b in zip(pre, blocks):
        assert native.decode_stream(s, p, len(b), preset=preset) == b


def test_device_api_preset_container_round_trip():
    from lzma_tpu.ops import api as dev

    p = LzmaParams(dict_size=1 << 14, fast_bytes=32)
    data = _repetitive(30_000, seed=17)
    v2 = dev.encode_blocks(data, p, block_size=1 << 12, preset_len=1 << 11)
    assert v2[4] == blk.VERSION_PRESET
    assert dev.decode_blocks(v2) == data
    v1 = dev.encode_blocks(data, p, block_size=1 << 12)
    assert len(v2) < len(v1)
    native = _native_or_skip()
    assert native.decode_blocks(v2) == data


def test_mesh_preset_encode_round_trip():
    from lzma_tpu.parallel.mesh import decode_blocks_mesh, encode_blocks_mesh

    p = LzmaParams(dict_size=1 << 14, fast_bytes=32)
    data = _repetitive(30_000, seed=18)
    v2 = encode_blocks_mesh(data, p, block_size=1 << 12, preset_len=1 << 11)
    assert v2[4] == blk.VERSION_PRESET
    assert decode_blocks_mesh(v2) == data
    assert blk.decode_blocks(v2) == data


def test_filestream_preset(tmp_path):
    data = _repetitive(300_000, seed=7)
    src = tmp_path / "in.bin"
    a = tmp_path / "plain.lztb"
    b = tmp_path / "preset.lztb"
    out = tmp_path / "out.bin"
    src.write_bytes(data)
    from lzma_tpu.parallel import filestream

    filestream.encode_file(src, a, PARAMS, block_size=1 << 15, batch_bytes=1 << 16)
    filestream.encode_file(src, b, PARAMS, block_size=1 << 15, batch_bytes=1 << 16,
                           preset_len=1 << 14)
    assert b.stat().st_size < a.stat().st_size
    # streamed v2 must equal the in-memory v2 container byte for byte
    try:
        from lzma_tpu.runtime import native

        expect = native.encode_blocks(data, PARAMS, block_size=1 << 15,
                                      preset_len=1 << 14)
    except Exception:
        expect = blk.encode_blocks(data, PARAMS, block_size=1 << 15,
                                   preset_len=1 << 14)
    assert b.read_bytes() == expect
    assert filestream.decode_file(b, out, batch_bytes=1 << 16) == len(data)
    assert out.read_bytes() == data


def test_cli_preset_switch(tmp_path):
    from lzma_tpu.cli import main

    data = _repetitive(150_000, seed=8)
    src = tmp_path / "in.bin"
    mid = tmp_path / "c.lztb"
    out = tmp_path / "o.bin"
    src.write_bytes(data)
    assert main(["e", "-d16", "-bs16384", "-ps8192", "-q",
                 str(src), str(mid)]) == 0
    assert mid.read_bytes()[4] == blk.VERSION_PRESET
    assert main(["d", "-q", str(mid), str(out)]) == 0
    assert out.read_bytes() == data


def test_native_eos_preset_decode():
    native = _native_or_skip()
    p = LzmaParams(dict_size=1 << 14, fast_bytes=32, write_eos=True)
    data = _mixed(8_000, seed=22)
    preset = data[:2048]
    comp = s_enc(data, p, preset=preset)
    assert native.decode_stream(comp, p, -1, preset=preset) == data
    assert native.encode_stream(data, p, preset=preset) == comp


@pytest.mark.parametrize("lc,lp,pb", [(0, 2, 1), (2, 1, 0), (8, 0, 4), (0, 4, 2)])
def test_preset_nonzero_lp_pb_all_backends(lc, lp, pb):
    """Preset position-context shifting must hold for lp/pb != defaults —
    the coded-position arithmetic (pos - preset_len) feeds both the
    posState and literal-position contexts on every backend."""
    p = LzmaParams(lc=lc, lp=lp, pb=pb, dict_size=1 << 13, fast_bytes=16)
    data = _mixed(6_000, seed=40 + lc + lp + pb)
    preset = _repetitive(1_500, seed=41)
    comp = s_enc(data, p, preset=preset)
    assert s_dec(comp, p, out_size=len(data), preset=preset) == data
    native = _native_or_skip()
    assert native.encode_stream(data, p, preset=preset) == comp
    assert native.decode_stream(comp, p, len(data), preset=preset) == data
    # device lanes: encode and decode with shifted contexts
    from lzma_tpu.ops.device_decoder import decode_batch
    from lzma_tpu.ops.device_encoder import encode_batch

    (dev_stream,) = encode_batch([data], p, preset=preset)
    assert s_dec(dev_stream, p, out_size=len(data), preset=preset) == data
    (out,) = decode_batch([comp], p, [len(data)], preset=preset)
    assert out == data
