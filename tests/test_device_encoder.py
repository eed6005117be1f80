"""Device (parallel-phase) encoder: output must be valid LZMA everywhere."""

import lzma

import numpy as np
import pytest

from lzma_tpu.codec.decoder import decode_stream
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.ops.device_encoder import encode_batch
from lzma_tpu.ops.device_decoder import decode_batch


def _corpus(i, n=3000):
    rng = np.random.default_rng(100 + i)
    if i % 4 == 0:
        return (b"lane parallel lzma encoder parse parse parse bits " * 100)[:n]
    if i % 4 == 1:
        out = bytearray(rng.integers(0, 256, 50, dtype=np.uint8).tobytes())
        while len(out) < n:
            if rng.integers(0, 2):
                s = int(rng.integers(0, len(out)))
                out.extend(out[s : s + int(rng.integers(2, 40))])
            else:
                out.append(int(rng.integers(0, 256)))
        return bytes(out[:n])
    if i % 4 == 2:
        return bytes([i & 0xFF]) * n  # runs -> rep-heavy
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_device_encode_scalar_decodes():
    p = LzmaParams(dict_size=1 << 14, fast_bytes=32)
    datas = [_corpus(i) for i in range(5)]
    streams = encode_batch(datas, p)
    for d, s in zip(datas, streams):
        assert decode_stream(s, p, out_size=len(d)) == d


def test_device_encode_liblzma_decodes():
    """Stock liblzma is the strongest validity oracle for our bitstreams."""
    p = LzmaParams(lc=3, lp=0, pb=2, dict_size=1 << 16, fast_bytes=32)
    datas = [_corpus(i, 4000) for i in range(4)]
    streams = encode_batch(datas, p)
    for d, s in zip(datas, streams):
        blob = p.encode_props() + len(d).to_bytes(8, "little") + s
        assert lzma.decompress(blob, format=lzma.FORMAT_ALONE) == d


def test_device_roundtrip_device_decode():
    """Full on-device loop: device encoder -> device decoder."""
    p = LzmaParams(dict_size=1 << 13, fast_bytes=32)
    datas = [_corpus(i, 2000) for i in range(4)]
    streams = encode_batch(datas, p)
    out = decode_batch(streams, p, [len(d) for d in datas])
    for o, d in zip(out, datas):
        assert o == d


@pytest.mark.parametrize("lc,lp,pb", [(0, 0, 0), (1, 1, 1), (4, 0, 2)])
def test_device_encode_param_sweep(lc, lp, pb):
    p = LzmaParams(lc=lc, lp=lp, pb=pb, dict_size=1 << 13, fast_bytes=16)
    datas = [_corpus(i, 1500) for i in range(3)]
    streams = encode_batch(datas, p)
    for d, s in zip(datas, streams):
        assert decode_stream(s, p, out_size=len(d)) == d


@pytest.mark.parametrize("fb", [5, 128, 273])
def test_device_encode_full_fb_range(fb):
    """The device tokenizer honors the reference's full fast-bytes range
    5..273 (Encoder.java:1148-1154) — including the CLI default fb128
    that rounds 1-3 capped at 64.  liblzma is the validity oracle."""
    p = LzmaParams(dict_size=1 << 14, fast_bytes=fb)
    datas = [_corpus(i, 2500) for i in range(4)]
    streams = encode_batch(datas, p)
    for d, s in zip(datas, streams):
        blob = p.encode_props() + len(d).to_bytes(8, "little") + s
        assert lzma.decompress(blob, format=lzma.FORMAT_ALONE) == d


def test_device_fb_validation():
    with pytest.raises(ValueError):
        encode_batch([b"x" * 100], LzmaParams(dict_size=1 << 12), fb=4)
    with pytest.raises(ValueError):
        encode_batch([b"x" * 100], LzmaParams(dict_size=1 << 12), fb=274)


def test_device_deep_fb_improves_long_matches():
    """fb>64 must actually change parse decisions: on data whose best
    matches are ~200 bytes long but whose 64-byte prefixes are ambiguous
    between a near and a far source, deeper compare depth finds the
    longer match (the reason the cap mattered)."""
    rng = np.random.default_rng(7)
    unit = rng.integers(0, 256, 220, dtype=np.uint8).tobytes()
    decoy = unit[:64] + rng.integers(0, 256, 156, dtype=np.uint8).tobytes()
    data = unit + decoy + b"." * 16 + unit + decoy + b"," * 16 + unit
    p64 = LzmaParams(dict_size=1 << 14, fast_bytes=64)
    p273 = LzmaParams(dict_size=1 << 14, fast_bytes=273)
    (s64,) = encode_batch([data], p64, fb=64)
    (s273,) = encode_batch([data], p273, fb=273)
    assert decode_stream(s273, p273, out_size=len(data)) == data
    assert len(s273) <= len(s64)


def test_device_encode_edge_sizes():
    p = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    datas = [b"z", b"ab", b"aaaa", bytes(range(200))]
    streams = encode_batch(datas, p)
    for d, s in zip(datas, streams):
        assert decode_stream(s, p, out_size=len(d)) == d


def test_device_compression_is_real():
    p = LzmaParams(dict_size=1 << 14, fast_bytes=64)
    d = (b"abcdefgh" * 1000)[:6000]
    (s,) = encode_batch([d], p)
    assert len(s) < len(d) // 8  # highly repetitive data must compress hard


def test_device_encode_pallas_serializer_path(triton_interpret):
    """encode_batch through the Triton range coder (interpret mode) must
    equal the XLA coder bit-for-bit on the same tokens."""
    import jax.numpy as jnp

    import lzma_tpu.ops.device_encoder as de
    from lzma_tpu.core.layout import ProbLayout

    p = LzmaParams(dict_size=1 << 12, fast_bytes=32)
    datas = [_corpus(i, 1500) for i in range(3)]
    got = encode_batch(datas, p)
    arr = np.zeros((3, 2048), np.uint8)
    for i, d in enumerate(datas):
        arr[i, :len(d)] = np.frombuffer(d, np.uint8)
    ctx, bits, totals, mo = de.lower_lanes(
        jnp.asarray(arr), jnp.asarray(np.full(3, 1500, np.int32)),
        jnp.int32(2048), lc=3, lp=0, pb=2, fb=32)
    out, lens = de.serialize_xla(ctx, bits, totals,
                                 ProbLayout(3, 0, 2, pos_bits=2).size, mo)
    out, lens = np.asarray(out), np.asarray(lens)
    assert got == [out[i, :lens[i]].tobytes() for i in range(3)]


def test_device_encode_overrun_raises(monkeypatch):
    """A coded stream longer than its output row is an error, never a
    silently truncated stream."""
    from lzma_tpu.ops import kernels

    p = LzmaParams(dict_size=1 << 12, fast_bytes=32)
    datas = [_corpus(i + 7, 1200) for i in range(2)]
    real = kernels.for_platform()

    def overrun(ctx, bits, totals, arena_size, max_out):
        out, lens = real.serialize(ctx, bits, totals, arena_size, max_out)
        return out, lens.at[1].set(max_out + 1)

    monkeypatch.setattr(kernels, "for_platform",
                        lambda: real._replace(serialize=overrun))
    with pytest.raises(RuntimeError, match="overran"):
        encode_batch(datas, p)


def test_device_eos_encode_all_decoders():
    """Device EOS-marker encode (
    capability asymmetry): the lane lowering appends the end-marker token
    (posSlot 63 / 26 one-bits / align 15, WriteEndMarker semantics,
    Encoder.java:818-835) and the .lzma header carries the unknown-size
    field.  Decodes on scalar, device, and stock liblzma."""
    import lzma as _lzma

    import numpy as np

    from lzma_tpu.codec.decoder import decode_alone as scalar_decode_alone
    from lzma_tpu.ops import api as dev

    rng = np.random.default_rng(5)
    words = [rng.integers(0, 256, int(rng.integers(4, 20)),
                          dtype=np.uint8).tobytes() for _ in range(30)]
    data = bytearray()
    while len(data) < 6000:
        data += words[int(rng.integers(0, 30))]
    data = bytes(data[:6000])

    p = LzmaParams(dict_size=1 << 12, fast_bytes=16, write_eos=True)
    blob = dev.encode_alone(data, p)
    assert blob[5:13] == b"\xff" * 8
    assert scalar_decode_alone(blob) == data
    assert _lzma.decompress(blob, format=_lzma.FORMAT_ALONE) == data
    assert dev.decode_alone(blob) == data


def test_device_eos_encode_pallas_serializer(triton_interpret):
    """The EOS marker bits ride the Triton range coder identically."""
    import lzma as _lzma

    from lzma_tpu.ops.device_encoder import encode_batch

    data = (b"triton eos payload " * 200)[:3000]
    p = LzmaParams(dict_size=1 << 12, fast_bytes=16, write_eos=True)
    (s,) = encode_batch([data], p, write_eos=True)
    blob = (p.encode_props() + (0xFFFFFFFFFFFFFFFF).to_bytes(8, "little") + s)
    assert _lzma.decompress(blob, format=_lzma.FORMAT_ALONE) == data
