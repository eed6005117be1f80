"""Trained-dictionary builder (utils/dicttrain.py) + LZTB v3 container.

The reference has no dictionary machinery at all (SURVEY.md §0); v3 is
the trained half of our preset design: a fastcover-style dictionary is
stored as its own compressed stream and primes EVERY block, so decode is
fully parallel (v2 serializes on block 0).  Scalar and native containers
must be byte-identical and cross-decodable; every backend must read v3.
"""

import random
import struct

import pytest

from lzma_tpu.core.rangecoder import CorruptStreamError
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.parallel import blocks as blk
from lzma_tpu.utils.dicttrain import train_dictionary

PARAMS = LzmaParams(dict_size=1 << 16, fast_bytes=32)


def _records(n_bytes=120_000, seed=0, n_shapes=30, rec=40):
    """Redundancy dispersed across the whole input (NOT front-loaded):
    the case a trained dictionary exists for and a v2 prefix misses."""
    rng = random.Random(seed)
    shapes = [bytes(rng.randrange(256) for _ in range(rec))
              for _ in range(n_shapes)]
    out = bytearray()
    while len(out) < n_bytes:
        out += shapes[rng.randrange(n_shapes)]
        out.append(rng.randrange(256))
    return bytes(out[:n_bytes])


def _native_or_skip():
    native = pytest.importorskip("lzma_tpu.runtime.native")
    if not native.available():
        pytest.skip("native runtime unavailable")
    return native


# ---------------------------------------------------------------- trainer

def test_trainer_deterministic_and_bounded():
    data = _records(80_000)
    d1 = train_dictionary(data, 4096)
    d2 = train_dictionary(data, 4096)
    assert d1 == d2
    assert 0 < len(d1) <= 4096


def test_trainer_small_corpus_is_identity():
    data = b"hello world"
    assert train_dictionary(data, 4096) == data


def test_trainer_accepts_samples_list():
    samples = [_records(10_000, seed=s) for s in range(4)]
    d = train_dictionary(samples, 2048)
    assert 0 < len(d) <= 2048


def test_trainer_rejects_bad_size():
    with pytest.raises(ValueError):
        train_dictionary(b"x" * 100, 0)


def test_trained_dict_captures_dispersed_redundancy():
    # heterogeneous input: block 0 is incompressible junk, the repeated
    # record shapes live in the rest — the v2 prefix preset samples the
    # wrong content while the trained dictionary finds the records
    # (the measured v3 use case)
    rng = random.Random(99)
    junk = bytes(rng.randrange(256) for _ in range(1 << 13))
    data = junk + _records(150_000)
    d = train_dictionary(data, 4096)
    v1 = blk.encode_blocks(data, PARAMS, block_size=1 << 13)
    v2 = blk.encode_blocks(data, PARAMS, block_size=1 << 13,
                           preset_len=1 << 12)
    v3 = blk.encode_blocks(data, PARAMS, block_size=1 << 13, dictionary=d)
    assert len(v3) < 0.9 * len(v1)
    assert len(v3) < len(v2)
    assert blk.decode_blocks(v3) == data


def test_select_dictionary_auto_sizes():
    from lzma_tpu.utils.dicttrain import select_dictionary

    _native_or_skip()
    p = LzmaParams(dict_size=1 << 16, fast_bytes=16)
    # no-redundancy corpus: a stored dictionary can never pay -> none
    rng = random.Random(42)
    rand = bytes(rng.randrange(256) for _ in range(1 << 17))
    assert select_dictionary(rand, p, block_size=1 << 13,
                             max_size=1 << 12) == b""
    # dispersed records: a dictionary pays and the selection must beat
    # the plain container when actually used
    data = _records(160_000)
    d = select_dictionary(data, p, block_size=1 << 13, max_size=1 << 12)
    assert d
    v1 = blk.encode_blocks(data, p, block_size=1 << 13)
    v3 = blk.encode_blocks(data, p, block_size=1 << 13, dictionary=d)
    assert len(v3) < len(v1)


def test_compress_file_train_dict_auto(tmp_path):
    _native_or_skip()
    import lzma_tpu

    data = _records(120_000)
    src = tmp_path / "src"
    src.write_bytes(data)
    dst = tmp_path / "auto.lztb"
    lzma_tpu.compress_file(str(src), str(dst), dict_size=1 << 16,
                           block_size=1 << 13, train_dict="auto")
    assert blk.parse_container(dst.read_bytes()).dict_len > 0
    back = tmp_path / "back"
    assert lzma_tpu.decompress_file(str(dst), str(back)) == len(data)
    assert back.read_bytes() == data


# ------------------------------------------------------------- container

def test_v3_scalar_round_trip_and_threads():
    data = _records(60_000)
    d = train_dictionary(data, 2048)
    blob = blk.encode_blocks(data, PARAMS, block_size=1 << 13, dictionary=d)
    frame = blk.parse_container(blob)
    assert frame.dict_len == len(d)
    assert frame.preset_len == 0
    assert blk.decode_blocks(blob) == data
    assert blk.decode_blocks(blob, num_threads=4) == data


def test_v3_native_byte_identical_and_cross_decodable():
    native = _native_or_skip()
    data = _records(60_000)
    d = train_dictionary(data, 2048)
    sv3 = blk.encode_blocks(data, PARAMS, block_size=1 << 13, dictionary=d)
    nv3 = native.encode_blocks(data, PARAMS, block_size=1 << 13, dictionary=d)
    assert sv3 == nv3
    assert native.decode_blocks(sv3) == data
    assert blk.decode_blocks(nv3) == data


def test_v3_single_block_still_primed():
    native = _native_or_skip()
    data = _records(6_000)
    d = train_dictionary(_records(60_000, seed=0), 2048)
    blob = native.encode_blocks(data, PARAMS, block_size=1 << 20, dictionary=d)
    assert blk.parse_container(blob).dict_len == len(d)
    assert native.decode_blocks(blob) == data
    assert blk.decode_blocks(blob) == data


def test_v3_empty_input_writes_plain_container():
    blob = blk.encode_blocks(b"", PARAMS, block_size=1 << 13,
                             dictionary=b"abc")
    assert blk.parse_container(blob).dict_len == 0
    assert blk.decode_blocks(blob) == b""


def test_dictionary_and_preset_len_are_exclusive():
    data = _records(30_000)
    with pytest.raises(ValueError):
        blk.encode_blocks(data, PARAMS, block_size=1 << 13,
                          preset_len=128, dictionary=b"abc")


def test_v3_corrupt_headers_rejected():
    data = _records(30_000)
    d = train_dictionary(data, 1024)
    blob = bytearray(
        blk.encode_blocks(data, PARAMS, block_size=1 << 13, dictionary=d)
    )
    head_end = blk._HEAD.size

    def patched(dict_len=None, dict_comp=None):
        b = bytearray(blob)
        dl, dc = struct.unpack_from("<II", b, head_end)
        struct.pack_into("<II", b, head_end,
                         dl if dict_len is None else dict_len,
                         dc if dict_comp is None else dict_comp)
        return bytes(b)

    with pytest.raises(CorruptStreamError):
        blk.parse_container(patched(dict_len=0))
    with pytest.raises(CorruptStreamError):
        blk.parse_container(patched(dict_comp=0))
    with pytest.raises(CorruptStreamError):  # forged: impossible expansion
        blk.parse_container(patched(dict_len=blk.MAX_DICT_LEN))
    with pytest.raises(CorruptStreamError):  # dict stream exceeds payload
        blk.parse_container(patched(dict_comp=len(blob)))
    # truncated mid-dict-stream
    frame = blk.parse_container(bytes(blob))
    with pytest.raises(CorruptStreamError):
        blk.decode_blocks(bytes(blob[: frame.payload_offset + 1]))


def test_v3_wrong_dictionary_fails_loud_or_differs():
    native = _native_or_skip()
    data = _records(30_000)
    d = train_dictionary(data, 1024)
    blob = native.encode_blocks(data, PARAMS, block_size=1 << 13, dictionary=d)
    # swap the stored dict stream for one coding different bytes of the
    # same length: decode must not silently return the original data
    other = bytes((x + 1) & 0xFF for x in d)
    frame = blk.parse_container(blob)
    from lzma_tpu.codec.encoder import encode_stream

    ds = encode_stream(other, frame.params)
    b = bytearray(blob)
    if len(ds) == frame.dict_comp:  # rare; else rebuild the container
        b[frame.payload_offset : frame.payload_offset + frame.dict_comp] = ds
        try:
            assert native.decode_blocks(bytes(b)) != data
        except CorruptStreamError:
            pass
    else:
        head = blk.pack_header(frame.params, frame.block_size,
                               frame.total_size, len(frame.comp_sizes),
                               0, len(other), len(ds))
        body = struct.pack(f"<{len(frame.comp_sizes)}I", *frame.comp_sizes)
        forged = head + body + ds + bytes(blob[frame.blocks_offset:])
        try:
            assert native.decode_blocks(forged) != data
        except CorruptStreamError:
            pass


# ------------------------------------------------------------ file paths

def test_v3_filestream_and_fileobj_byte_identical(tmp_path):
    native = _native_or_skip()
    import lzma_tpu

    data = _records(90_000)
    d = train_dictionary(data, 2048)
    ref = native.encode_blocks(data, LzmaParams(dict_size=1 << 16),
                               block_size=1 << 13, dictionary=d)
    src = tmp_path / "src"
    src.write_bytes(data)
    dst = tmp_path / "out.lztb"
    lzma_tpu.compress_file(str(src), str(dst), dict_size=1 << 16,
                           block_size=1 << 13, dictionary=d)
    assert dst.read_bytes() == ref
    back = tmp_path / "back"
    assert lzma_tpu.decompress_file(str(dst), str(back)) == len(data)
    assert back.read_bytes() == data

    w = tmp_path / "w.lztb"
    with lzma_tpu.open(str(w), "wb", dict_size=1 << 16,
                       block_size=1 << 13, dictionary=d) as f:
        for i in range(0, len(data), 7777):
            f.write(data[i : i + 7777])
    assert w.read_bytes() == ref
    with lzma_tpu.open(str(w), "rb") as f:
        assert f.read() == data


def test_v3_train_dict_convenience(tmp_path):
    _native_or_skip()
    import lzma_tpu

    data = _records(90_000)
    src = tmp_path / "src"
    src.write_bytes(data)
    dst = tmp_path / "out.lztb"
    plain = tmp_path / "plain.lztb"
    lzma_tpu.compress_file(str(src), str(dst), dict_size=1 << 16,
                           block_size=1 << 13, train_dict=4096)
    lzma_tpu.compress_file(str(src), str(plain), dict_size=1 << 16,
                           block_size=1 << 13)
    assert dst.stat().st_size < plain.stat().st_size
    back = tmp_path / "back"
    assert lzma_tpu.decompress_file(str(dst), str(back)) == len(data)
    assert back.read_bytes() == data


def test_cli_train_dict(tmp_path, capsys):
    _native_or_skip()
    from lzma_tpu.cli import main

    data = _records(60_000)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    out = tmp_path / "out.lztb"
    back = tmp_path / "back.bin"
    assert main(["e", "-bs8192", "-d16", "-td2048", str(src), str(out)]) == 0
    assert blk.parse_container(out.read_bytes()).dict_len > 0
    assert main(["d", str(out), str(back)]) == 0
    assert back.read_bytes() == data
    # auto-sized dictionary
    assert main(["e", "-bs8192", "-d16", "-tdauto", str(src), str(out)]) == 0
    assert main(["d", str(out), str(back)]) == 0
    assert back.read_bytes() == data
    # -td without -bs is an error
    assert main(["e", "-td2048", str(src), str(out)]) == 1


# -------------------------------------------------------- device backends

def test_v3_device_and_mesh():
    jax = pytest.importorskip("jax")
    native = _native_or_skip()
    from lzma_tpu.ops import api as dev
    from lzma_tpu.parallel import mesh as M

    data = _records(24_000)
    d = train_dictionary(data, 1024)
    p = LzmaParams(dict_size=1 << 14, fast_bytes=16)
    nv3 = native.encode_blocks(data, p, block_size=1 << 12, dictionary=d)

    dv3 = dev.encode_blocks(data, p, block_size=1 << 12, dictionary=d)
    assert native.decode_blocks(dv3) == data
    assert dev.decode_blocks(dv3) == data
    assert dev.decode_blocks(nv3) == data

    mesh = M.make_mesh()
    mv3 = M.encode_blocks_mesh(data, p, block_size=1 << 12, mesh=mesh,
                               dictionary=d)
    assert native.decode_blocks(mv3) == data
    assert M.decode_blocks_mesh(mv3, mesh=mesh) == data
    assert M.decode_blocks_mesh(nv3, mesh=mesh) == data


def test_v3_hybrid():
    pytest.importorskip("jax")
    native = _native_or_skip()
    from lzma_tpu.ops.hybrid import encode_blocks_hybrid

    data = _records(24_000)
    d = train_dictionary(data, 1024)
    p = LzmaParams(dict_size=1 << 14, fast_bytes=16)
    hv3 = encode_blocks_hybrid(data, p, block_size=1 << 12, dictionary=d)
    assert native.decode_blocks(hv3) == data
    assert blk.decode_blocks(hv3) == data
