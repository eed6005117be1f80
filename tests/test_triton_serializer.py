"""Triton range-coder kernel vs the XLA reference (interpret mode).

On the CPU the kernel runs through the Pallas interpreter; the contract
is byte-identical output to device_encoder.serialize_xla, and a lane
that overruns its output row is reported, not silently truncated.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lzma_tpu.core.layout import ProbLayout
from lzma_tpu.ops.device_encoder import (
    check_out_lens,
    classify_tokens,
    lower_tokens,
    serialize_xla,
)
from lzma_tpu.ops.device_matcher import tokenize
from lzma_tpu.ops import triton_serializer
from lzma_tpu.ops.triton_serializer import lane_groups, serialize_triton

from conftest import nbytes, traced_arrays


def _bit_streams(n_lanes=4, max_n=2048, seed=0, lc=3, lp=0, pb=2):
    rng = np.random.default_rng(seed)
    words = [rng.integers(0, 256, int(rng.integers(3, 30)), dtype=np.uint8).tobytes() for _ in range(32)]
    data = np.zeros((n_lanes, max_n), dtype=np.uint8)
    for i in range(n_lanes):
        b = bytearray()
        while len(b) < max_n:
            b.extend(words[int(rng.integers(0, 32))])
        data[i] = np.frombuffer(bytes(b[:max_n]), dtype=np.uint8)
    dj = jnp.asarray(data)
    lens = jnp.full((n_lanes,), max_n, jnp.int32)
    t_pos, t_len, t_dist, t_valid, _ = jax.vmap(
        lambda d, n: tokenize(d, n, max_n, 32, 2)
    )(dj, lens)
    meta = classify_tokens(dj, t_pos, t_len, t_dist, t_valid)
    ctx, bits, totals = lower_tokens(
        dj, meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb, 10 * max_n + 128
    )
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    return ctx, bits, totals, layout.size, max_n + max_n // 4 + 128


def _assert_same(out, lens, ref_out, ref_lens):
    assert np.array_equal(np.asarray(lens), np.asarray(ref_lens))
    po, ro = np.asarray(out), np.asarray(ref_out)
    for i in range(po.shape[0]):
        n = int(ref_lens[i])
        assert po[i, :n].tobytes() == ro[i, :n].tobytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_pallas_serializer_bit_exact(seed):
    ctx, bits, totals, arena, mo = _bit_streams(seed=seed)
    ref_out, ref_lens = serialize_xla(ctx, bits, totals, arena, mo)
    out, lens = serialize_triton(ctx, bits, totals, arena, mo, interpret=True)
    _assert_same(out, lens, ref_out, ref_lens)


@pytest.mark.parametrize("n_lanes", [3, 33])
def test_pallas_serializer_unaligned_lanes(n_lanes):
    """Lane counts that aren't a multiple of the kernel's 32-lane program:
    the last program masks the lanes past N (33 spans two programs), and
    the outputs hold exactly the caller's lanes."""
    ctx, bits, totals, arena, mo = _bit_streams(n_lanes=n_lanes, max_n=512,
                                                seed=5)
    ref_out, ref_lens = serialize_xla(ctx, bits, totals, arena, mo)
    out, lens = serialize_triton(ctx, bits, totals, arena, mo, interpret=True)
    assert out.shape[0] == n_lanes and lens.shape[0] == n_lanes
    _assert_same(out, lens, ref_out, ref_lens)


def test_serializer_overrun_reports_full_length():
    """A max_out too small for the stream: the kernel writes no byte past
    the row, still reports the stream's full length, and check_out_lens
    turns that into an error."""
    ctx, bits, totals, arena, mo = _bit_streams(n_lanes=2, seed=7)
    _, ref_lens = serialize_xla(ctx, bits, totals, arena, mo)
    small = int(np.min(np.asarray(ref_lens))) // 2
    out, lens = serialize_triton(ctx, bits, totals, arena, small,
                                 interpret=True)
    assert out.shape[1] == small
    assert np.array_equal(np.asarray(lens), np.asarray(ref_lens))
    with pytest.raises(RuntimeError, match="overran"):
        check_out_lens(np.asarray(lens), small)


@pytest.mark.parametrize("n,row", [(1, 100), (33, 1 << 20), (4096, 1 << 20),
                                   (5, 2**31 - 1), (0, 64)])
def test_lane_groups_cover_the_batch(n, row):
    groups = lane_groups(n, row)
    assert groups[0][0] == 0 and groups[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    assert all((e - s) * row < 2**31 for s, e in groups)


def test_serializer_byte_buffers_stay_under_2gib_per_call():
    """Three lanes of 1 GiB output rows would make one 3 GiB byte
    buffer, whose offsets pass 2**31: the batch runs as one call per
    lane instead.  Traced only; nothing is allocated."""
    n, B, mo = 3, 1 << 12, 1 << 30
    i32 = jax.ShapeDtypeStruct((n, B), jnp.int32)
    _, calls = traced_arrays(
        lambda c, b, t: serialize_triton(c, b, t, 100, mo), i32, i32,
        jax.ShapeDtypeStruct((n,), jnp.int32))
    assert len(calls) == 3
    for avals in calls:
        assert all(nbytes(a) < 2**31 for a in avals if a.dtype == jnp.uint8)


def test_serializer_split_batch_matches_xla(monkeypatch):
    """With the per-call byte bound set to three rows, seven lanes run
    as three calls and still equal the XLA coder."""
    ctx, bits, totals, arena, mo = _bit_streams(n_lanes=7, max_n=256, seed=2)
    monkeypatch.setattr(triton_serializer, "MAX_CALL_BYTES", 3 * mo)
    jax.clear_caches()
    try:
        _, calls = traced_arrays(
            lambda c, b, t: serialize_triton(c, b, t, arena, mo), ctx, bits,
            totals)
        assert len(calls) == 3
        out, lens = serialize_triton(ctx, bits, totals, arena, mo,
                                     interpret=True)
    finally:
        jax.clear_caches()
    ref_out, ref_lens = serialize_xla(ctx, bits, totals, arena, mo)
    assert out.shape == (7, mo)
    _assert_same(out, lens, ref_out, ref_lens)


def test_serializer_one_lane_allocates_one_lane():
    """A single-stream encode allocates one lane's buffers, not a
    32-lane program's worth."""
    B, arena, mo = 50_000, 7990, 6000
    i32 = jax.ShapeDtypeStruct((1, B), jnp.int32)
    arrays, calls = traced_arrays(
        lambda c, b, t: serialize_triton(c, b, t, arena, mo), i32, i32,
        jax.ShapeDtypeStruct((1,), jnp.int32))
    biggest = max(nbytes(a) for a in arrays + sum(calls, []))
    assert biggest == B * 4
    assert all(a.shape[0] == 1 for a in sum(calls, []) if a.ndim)
