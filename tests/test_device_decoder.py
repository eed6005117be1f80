"""Device (lane-parallel FSM) decoder vs the scalar oracle and liblzma."""

import lzma

import numpy as np
import pytest

from lzma_tpu.codec.encoder import encode_stream
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.ops.device_decoder import decode_batch


def _corpus(i, n=4000):
    rng = np.random.default_rng(i)
    if i % 3 == 0:
        return (b"some structured text with repeats, repeats, repeats " * 200)[:n]
    if i % 3 == 1:
        out = bytearray(rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
        while len(out) < n:
            if rng.integers(0, 2):
                s = int(rng.integers(0, len(out)))
                out.extend(out[s : s + int(rng.integers(2, 60))])
            else:
                out.append(int(rng.integers(0, 256)))
        return bytes(out[:n])
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_decode_batch_matches_scalar():
    p = LzmaParams(dict_size=1 << 14, fast_bytes=32)
    datas = [_corpus(i) for i in range(6)]
    streams = [encode_stream(d, p) for d in datas]
    out = decode_batch(streams, p, [len(d) for d in datas])
    for o, d in zip(out, datas):
        assert o == d


def test_decode_batch_uneven_sizes():
    p = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    datas = [_corpus(i, n) for i, n in enumerate([1, 17, 4096, 333, 2, 1000])]
    streams = [encode_stream(d, p) for d in datas]
    out = decode_batch(streams, p, [len(d) for d in datas])
    for o, d in zip(out, datas):
        assert o == d


@pytest.mark.parametrize("lc,lp,pb", [(3, 0, 2), (0, 2, 0), (1, 1, 1), (8, 4, 4)])
def test_decode_batch_param_sweep(lc, lp, pb):
    p = LzmaParams(lc=lc, lp=lp, pb=pb, dict_size=1 << 13, fast_bytes=16)
    datas = [_corpus(i, 2500) for i in range(3)]
    streams = [encode_stream(d, p) for d in datas]
    out = decode_batch(streams, p, [len(d) for d in datas])
    for o, d in zip(out, datas):
        assert o == d


def test_decode_batch_liblzma_streams():
    """Device decoder consumes liblzma-encoded raw streams (headerless)."""
    p = LzmaParams(lc=3, lp=0, pb=2, dict_size=1 << 16)
    datas = [_corpus(i, 3000) for i in range(4)]
    filt = {"id": lzma.FILTER_LZMA1, "lc": 3, "lp": 0, "pb": 2, "dict_size": 1 << 16}
    streams = [
        lzma.compress(d, format=lzma.FORMAT_ALONE, filters=[filt])[13:] for d in datas
    ]
    out = decode_batch(streams, p, [len(d) for d in datas])
    for o, d in zip(out, datas):
        assert o == d


def test_decode_batch_corrupt_flagged():
    p = LzmaParams(dict_size=1 << 13, fast_bytes=16)
    data = _corpus(1)
    good = encode_stream(data, p)
    bad = bytearray(good)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(ValueError, match="device decode failed"):
        decode_batch([good, bytes(bad)], p, [len(data), len(data)], max_iters=400_000)


def test_decode_batch_empty_stream_list():
    assert decode_batch([], LzmaParams(), []) == []


def test_decode_batch_zero_length_output():
    """Empty payloads (out_size 0) must decode to b'' — the FSM cannot
    represent them (it always decodes one symbol first), so they
    short-circuit.  Mixed batches keep their lane order."""
    p = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    s_empty = encode_stream(b"", p)
    payload = b"device" * 40
    s_data = encode_stream(payload, p)
    outs = decode_batch([s_empty, s_data, s_empty], p, [0, len(payload), 0])
    assert outs == [b"", payload, b""]
    assert decode_batch([s_empty], p, [0]) == [b""]


def test_decode_batch_rejects_oversize_claims():
    """Size claims past the device's int32 lane range must be a clean
    CorruptStreamError, not a numpy OverflowError."""
    from lzma_tpu.core.rangecoder import CorruptStreamError

    p = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    s = encode_stream(b"x" * 100, p)
    with pytest.raises(CorruptStreamError):
        decode_batch([s], p, [1 << 31])


def test_decode_batch_corrupt_raises_corrupt_stream_error():
    """Same exception type as the scalar/native backends."""
    from lzma_tpu.core.rangecoder import CorruptStreamError

    p = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    payload = b"corrupt-me" * 30
    s = bytearray(encode_stream(payload, p))
    s[10] ^= 0xFF
    with pytest.raises(CorruptStreamError):
        decode_batch([bytes(s)], p, [len(payload)])


def test_device_eos_decode():
    """Unknown-size (EOS marker) streams decode ON-LANE via the negative
    out_sizes sentinel — no host fallback (Decoder.java:219,277-283)."""
    import lzma as _lzma

    from lzma_tpu.ops.device_decoder import decode_batch

    data = bytes(((i * 31) ^ (i >> 3)) & 0xFF for i in range(3000)) * 2
    params = LzmaParams(dict_size=1 << 16, lc=3, lp=0, pb=2)
    # liblzma FORMAT_ALONE always writes size=-1 (EOS-terminated)
    blob = _lzma.compress(data, format=_lzma.FORMAT_ALONE,
                          filters=[dict(id=_lzma.FILTER_LZMA1,
                                        dict_size=1 << 16)])
    (out,) = decode_batch([blob[13:]], params, [-(1 << 16)])
    assert out == data


def test_device_eos_decode_via_api():
    import lzma as _lzma

    from lzma_tpu.ops import api

    data = b"the quick brown fox jumps over the lazy dog " * 200
    blob = _lzma.compress(data, format=_lzma.FORMAT_ALONE, preset=1)
    assert api.decode_alone(blob) == data


def test_device_eos_cap_overrun_raises_cap_exceeded():
    """Reaching the cap without the end marker raises the DISTINGUISHED
    CapExceededError (still a CorruptStreamError subclass) so
    decode_alone can grow the cap instead of bailing to the host."""
    import lzma as _lzma

    import pytest

    from lzma_tpu.ops.device_decoder import CapExceededError, decode_batch

    data = b"growable " * 4000
    params = LzmaParams(dict_size=1 << 16)
    blob = _lzma.compress(data, format=_lzma.FORMAT_ALONE,
                          filters=[dict(id=_lzma.FILTER_LZMA1,
                                        dict_size=1 << 16)])
    with pytest.raises(CapExceededError):
        decode_batch([blob[13:]], params, [-2048])


def test_device_eos_grow_on_overflow():
    """decode_alone's doubling retry: a stream whose
    expansion far exceeds the first cap decodes on the device FSM after
    cap growth — no native fallback (asserted by making it unavailable)."""
    import lzma as _lzma

    from lzma_tpu.ops import api

    # ~200:1 expansion: comp_len ~1 KB -> first cap 64 KB -> must grow
    data = b"a" * 200000 + b"tail-entropy" + bytes(range(256))
    blob = _lzma.compress(data, format=_lzma.FORMAT_ALONE, preset=1)
    assert api.decode_alone(blob) == data


def test_device_eos_multi_doubling_growth():
    """Several cap-growth rounds on one stream: a ~420 KB output behind a
    tiny compressed input starts at the 64 KB floor cap and must grow
    three 4x rounds before the marker lands.  (A >= 16 MB on-FSM decode
    is wall-clock-infeasible by the FSM's own cost model — per-iteration
    masked ops scale with the output bucket —
    so beyond LZMA_TPU_DEVICE_EOS_CEILING decode_alone hands unknown-size
    streams to the native streaming decoder at 80+ MB/s.)"""
    import lzma as _lzma

    from lzma_tpu.ops import api

    data = b"grow" * 104000 + bytes(range(200))   # ~416 KB, tiny stream
    blob = _lzma.compress(data, format=_lzma.FORMAT_ALONE, preset=1)
    assert len(blob) - 13 < (1 << 12)
    assert api.decode_alone(blob) == data


def test_device_eos_cap_overrun_is_clean_error():
    """A stream bigger than the cap must error on-lane (not crash), so
    api.decode_alone can fall back to the streaming decoders."""
    import lzma as _lzma

    import pytest

    from lzma_tpu.core.rangecoder import CorruptStreamError
    from lzma_tpu.ops.device_decoder import decode_batch

    data = bytes(range(256)) * 64
    params = LzmaParams(dict_size=1 << 16)
    blob = _lzma.compress(data, format=_lzma.FORMAT_ALONE,
                          filters=[dict(id=_lzma.FILTER_LZMA1,
                                        dict_size=1 << 16)])
    with pytest.raises(CorruptStreamError):
        decode_batch([blob[13:]], params, [-1024])


def test_device_known_size_rejects_marker():
    """With a known size, dist==-1 stays corruption (reference parity:
    Decoder.java:288-291 path)."""
    import lzma as _lzma

    import pytest

    from lzma_tpu.core.rangecoder import CorruptStreamError
    from lzma_tpu.ops.device_decoder import decode_batch

    data = b"abcabcabc" * 300
    params = LzmaParams(dict_size=1 << 16)
    blob = _lzma.compress(data, format=_lzma.FORMAT_ALONE,
                          filters=[dict(id=_lzma.FILTER_LZMA1,
                                        dict_size=1 << 16)])
    # claim a size PAST the real end: the decoder runs into the EOS
    # marker while a known size is expected -> corruption
    with pytest.raises(CorruptStreamError):
        decode_batch([blob[13:]], params, [len(data) + 64])
