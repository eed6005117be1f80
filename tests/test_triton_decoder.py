"""Triton decode-FSM kernel: bit-exact vs the scalar oracle, liblzma and
the XLA FSM.

CPU runs exercise the kernel in interpret mode through the normal entry
points (device_decoder.decode_batch, ops/api.decode_blocks) via the
`triton_interpret` fixture; a few cases call the kernel directly.
"""

import lzma as pylzma

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lzma_tpu.codec.encoder import encode_stream
from lzma_tpu.core.rangecoder import CorruptStreamError
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.ops.device_decoder import decode_batch, decode_fsm_xla
from lzma_tpu.ops import triton_serializer
from lzma_tpu.ops.triton_decoder import decode_fsm_triton

from conftest import nbytes, traced_arrays


def _corpus(rng, n):
    words = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
             for k in rng.integers(4, 24, 24)]
    b = bytearray()
    while len(b) < n:
        b += words[int(rng.integers(0, len(words)))]
    return bytes(b[:n])


def _mixed_payloads(rng):
    word = rng.integers(0, 256, 17, dtype=np.uint8).tobytes()
    return [
        b"",
        b"a" * 400,
        (word * 40)[:500],
        rng.integers(0, 256, 300, dtype=np.uint8).tobytes(),
        (b"the quick brown fox " * 30)[:450],
    ]


def _padded(streams):
    mi = max(max(len(s) for s in streams), 16)
    comp = np.zeros((len(streams), mi), np.uint8)
    lens = np.zeros(len(streams), np.int32)
    for i, s in enumerate(streams):
        comp[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return jnp.asarray(comp), jnp.asarray(lens)


# ---------------------------------------------------------- ring-window set
@pytest.mark.parametrize("reverse", [False, True])
def test_ring_decode_small_dict(triton_interpret, reverse):
    # dict << block; lanes are independent, so their order is irrelevant
    rng = np.random.default_rng(5)
    params = LzmaParams(dict_size=1 << 11, fast_bytes=16)
    payloads = [_corpus(rng, 5000 - 321 * i) for i in range(3)]
    payloads.append(rng.integers(0, 256, 2500, dtype=np.uint8).tobytes())
    if reverse:
        payloads = payloads[::-1]
    streams = [encode_stream(p, params, mode="greedy") for p in payloads]
    outs = decode_batch(streams, params, [len(p) for p in payloads])
    assert outs == payloads


def test_ring_decode_dict_covers_block(triton_interpret):
    rng = np.random.default_rng(6)
    params = LzmaParams(dict_size=1 << 16, fast_bytes=16)
    payloads = [_corpus(rng, 1800), b"a" * 700]
    streams = [encode_stream(p, params, mode="greedy") for p in payloads]
    outs = decode_batch(streams, params, [len(p) for p in payloads])
    assert outs == payloads


@pytest.mark.parametrize("lc,lp,pb", [(0, 0, 2), (1, 2, 1)])
def test_ring_decode_param_combos(triton_interpret, lc, lp, pb):
    rng = np.random.default_rng(7 + lc * 9 + lp * 3 + pb)
    params = LzmaParams(lc=lc, lp=lp, pb=pb, dict_size=1 << 10, fast_bytes=16)
    payload = _corpus(rng, 2600)
    stream = encode_stream(payload, params, mode="greedy")
    (out,) = decode_batch([stream], params, [len(payload)])
    assert out == payload


def test_ring_decode_preset(triton_interpret):
    # LZTB v2/v3 priming: window pre-filled, contexts shifted
    rng = np.random.default_rng(8)
    params = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    preset = _corpus(rng, 3000)
    payloads = [_corpus(rng, 2000), _corpus(rng, 1500)]
    streams = [encode_stream(p, params, preset=preset, mode="greedy")
               for p in payloads]
    outs = decode_batch(streams, params, [len(p) for p in payloads],
                        preset=preset)
    assert outs == payloads


def test_decode_spans_programs():
    """33 lanes need two 32-lane programs; the second masks its 31
    lanes past N, and the real lanes match the XLA FSM exactly."""
    rng = np.random.default_rng(11)
    params = LzmaParams(dict_size=1 << 11, fast_bytes=16)
    payloads = [_corpus(rng, 120 + 7 * i) for i in range(33)]
    streams = [encode_stream(p, params, mode="greedy") for p in payloads]
    comp, lens = _padded(streams)
    sizes = jnp.asarray(np.array([len(p) for p in payloads], np.int32))
    args = (comp, lens, sizes, np.int64(1 << 11), 3, 0, 2, 512)
    out, ok, _, pos = decode_fsm_triton(*args, interpret=True)
    ref_out, ref_ok, _, ref_pos = decode_fsm_xla(*args)
    assert out.shape == ref_out.shape
    assert np.array_equal(np.asarray(ok), np.asarray(ref_ok))
    assert np.array_equal(np.asarray(pos), np.asarray(ref_pos))
    assert np.array_equal(np.asarray(out), np.asarray(ref_out))
    assert all(np.asarray(out[i, :len(p)]).tobytes() == p
               for i, p in enumerate(payloads))


def test_ring_decode_corrupt_falls_back(triton_interpret):
    rng = np.random.default_rng(9)
    params = LzmaParams(dict_size=1 << 11, fast_bytes=16)
    payload = _corpus(rng, 1200)
    stream = bytearray(encode_stream(payload, params, mode="greedy"))
    stream[8] ^= 0xFF  # corrupt mid-stream
    with pytest.raises(CorruptStreamError):
        decode_batch([bytes(stream)], params, [len(payload)])


@pytest.mark.parametrize("mode", ["optimal", "greedy"])
@pytest.mark.parametrize("fast_bytes", [64, 16])
def test_ring_decode_copy4_modes(mode, fast_bytes):
    """Overlapped match copies are byte-exact: dist==1 RLE runs, dist 2/3
    overlapped copies and ragged tails (Decoder.java:288-294), from two
    encoder modes at two match-length caps."""
    rng = np.random.default_rng(9)
    params = LzmaParams(dict_size=1 << 11, fast_bytes=fast_bytes)
    payloads = [_corpus(rng, 4000)]
    payloads.append(bytes([5]) * 3000)                     # dist==1 RLE
    payloads.append(bytes([1, 2]) * 1500)                  # dist==2
    payloads.append(bytes([1, 2, 3]) * 1000 + b"xy")       # dist==3
    streams = [encode_stream(p, params, mode=mode) for p in payloads]
    comp, lens = _padded(streams)
    mo = max(len(p) for p in payloads)
    out, ok, _, _ = decode_fsm_triton(
        comp, lens, jnp.asarray(np.array([len(p) for p in payloads],
                                         np.int32)),
        np.int64(1 << 11), params.lc, params.lp, params.pb, mo,
        interpret=True)
    assert bool(jnp.all(ok))
    for i, p in enumerate(payloads):
        assert np.asarray(out[i, :len(p)]).tobytes() == p


# ---------------------------------------------------- whole-block set
def test_pallas_decode_matches_oracle_streams(triton_interpret):
    rng = np.random.default_rng(11)
    params = LzmaParams(dict_size=1 << 16, fast_bytes=32)
    payloads = [p for p in _mixed_payloads(rng) if p]
    streams = [encode_stream(p, params) for p in payloads]
    outs = decode_batch(streams, params, [len(p) for p in payloads])
    assert outs == payloads


def test_pallas_decode_liblzma_streams(triton_interpret):
    # cross-oracle: streams produced by stock liblzma
    params = LzmaParams(lc=3, lp=0, pb=2, dict_size=1 << 16)
    filt = [{"id": pylzma.FILTER_LZMA1, "preset": 6, "dict_size": 1 << 16}]
    payloads = [b"hello triton " * 40, bytes(range(256)) * 3]
    streams = []
    for p in payloads:
        blob = pylzma.compress(p, format=pylzma.FORMAT_ALONE, filters=filt)
        streams.append(blob[13:])  # strip 5-byte props + 8-byte size header
    outs = decode_batch(streams, params, [len(p) for p in payloads])
    assert outs == payloads


@pytest.mark.parametrize("lc,lp,pb", [(0, 2, 0), (1, 1, 1)])
def test_pallas_decode_param_combos(triton_interpret, lc, lp, pb):
    rng = np.random.default_rng(7 + lc * 9 + lp * 3 + pb)
    params = LzmaParams(lc=lc, lp=lp, pb=pb, dict_size=1 << 14, fast_bytes=16)
    word = rng.integers(0, 256, 23, dtype=np.uint8).tobytes()
    payload = (word * 30)[:600]
    stream = encode_stream(payload, params)
    (out,) = decode_batch([stream], params, [len(payload)])
    assert out == payload


def test_pallas_decode_corrupt_lane_falls_back_to_typed_error(
        triton_interpret):
    params = LzmaParams(dict_size=1 << 14)
    payload = np.random.default_rng(3).integers(0, 256, 300, dtype=np.uint8).tobytes()
    stream = bytearray(encode_stream(payload, params))
    stream[len(stream) // 2] ^= 0xFF  # corrupt mid-stream
    with pytest.raises(CorruptStreamError):
        decode_batch([bytes(stream)], params, [len(payload)])


def test_api_decode_blocks_use_pallas_roundtrip(triton_interpret):
    from lzma_tpu.ops import api as dev

    rng = np.random.default_rng(21)
    word = rng.integers(0, 256, 29, dtype=np.uint8).tobytes()
    data = (word * 60)[:1500]
    params = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    blob = dev.encode_blocks(data, params, block_size=512)
    assert dev.decode_blocks(blob) == data


def test_pallas_decode_match_heavy_iteration_budget(triton_interpret):
    # highly compressible data decodes far more bits+copies than
    # 8*comp_len: the loop runs until every lane finishes, however long
    params = LzmaParams(dict_size=1 << 13, fast_bytes=64)
    payload = b"\x00" * 8192
    stream = encode_stream(payload, params)
    assert len(stream) < 120  # sanity: the case is genuinely match-heavy
    (out,) = decode_batch([stream], params, [len(payload)])
    assert out == payload


def test_pallas_decode_lane_grouping(triton_interpret):
    """Many lanes of ragged sizes, with and without a shared preset,
    keep their per-lane order and bytes."""
    rng = np.random.default_rng(23)
    params = LzmaParams(dict_size=1 << 14, fast_bytes=16)
    word = rng.integers(0, 256, 13, dtype=np.uint8).tobytes()
    payloads = [(word * 50)[: 200 + 17 * i] for i in range(20)]
    streams = [encode_stream(p, params) for p in payloads]
    sizes = [len(p) for p in payloads]
    assert decode_batch(streams, params, sizes) == payloads
    preset = (word * 10)[:100]
    streams_p = [encode_stream(p, params, preset=preset) for p in payloads]
    assert decode_batch(streams_p, params, sizes, preset=preset) == payloads


def _abstract_args(n, max_in, max_out):
    return ((jax.ShapeDtypeStruct((n, max_in), jnp.uint8),
             jax.ShapeDtypeStruct((n,), jnp.int32),
             jax.ShapeDtypeStruct((n,), jnp.int32)),
            lambda c, l, s: decode_fsm_triton(c, l, s, np.int64(1 << 16), 3,
                                              0, 2, max_out))


def test_decoder_byte_buffers_stay_under_2gib_per_call():
    """Three lanes of 1 GiB output rows would make one 3 GiB output
    buffer, whose offsets pass 2**31: the batch runs as one call per
    lane.  Traced only; nothing is allocated."""
    args, fn = _abstract_args(3, 1 << 16, 1 << 30)
    _, calls = traced_arrays(fn, *args)
    assert len(calls) == 3
    for avals in calls:
        assert all(nbytes(a) < 2**31 for a in avals if a.dtype == jnp.uint8)


def test_decoder_split_batch_matches_xla(monkeypatch):
    """With the per-call byte bound set to two rows, five lanes of
    varied lengths run as three calls and still equal the XLA FSM."""
    rng = np.random.default_rng(12)
    params = LzmaParams(dict_size=1 << 10, fast_bytes=16)
    payloads = [_corpus(rng, 900 + 131 * i) for i in range(5)]
    streams = [encode_stream(p, params, mode="greedy") for p in payloads]
    comp, lens = _padded(streams)
    sizes = jnp.asarray(np.array([len(p) for p in payloads], np.int32))
    args = (comp, lens, sizes, np.int64(1 << 10), 3, 0, 2, 2048)
    monkeypatch.setattr(triton_serializer, "MAX_CALL_BYTES", 2 * 2048)
    jax.clear_caches()
    try:
        _, calls = traced_arrays(lambda *a: decode_fsm_triton(*a, *args[3:]),
                                 *args[:3])
        assert len(calls) == 3
        out, ok, _, pos = decode_fsm_triton(*args, interpret=True)
    finally:
        jax.clear_caches()
    ref_out, ref_ok, _, ref_pos = decode_fsm_xla(*args)
    assert bool(jnp.all(ok))
    assert np.array_equal(np.asarray(pos), np.asarray(ref_pos))
    assert np.array_equal(np.asarray(out), np.asarray(ref_out))


def test_decoder_one_lane_allocates_one_lane():
    """A single-stream decode allocates one lane's buffers, not a
    32-lane program's worth."""
    args, fn = _abstract_args(1, 1 << 16, 1 << 20)
    arrays, calls = traced_arrays(fn, *args)
    assert max(nbytes(a) for a in arrays + sum(calls, [])) == 1 << 20
    assert all(a.shape[0] == 1 for a in sum(calls, []) if a.ndim == 2)
