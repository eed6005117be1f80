"""Lane-parallel optimal-parse DP (ops/device_parser): correctness of the
token streams, backend equivalence, and the ratio claim vs the lazy parse."""

import lzma

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.ops.device_encoder import encode_batch
from lzma_tpu.ops.device_parser import tokenize_optimal


def _corpus(i, n=3000):
    rng = np.random.default_rng(100 + i)
    if i % 3 == 0:
        return (b"optimal parse lane dp optimal parse bits " * 200)[:n]
    if i % 3 == 1:
        out = bytearray(rng.integers(0, 256, 50, dtype=np.uint8).tobytes())
        while len(out) < n:
            if rng.integers(0, 2):
                s = int(rng.integers(0, len(out)))
                out.extend(out[s : s + int(rng.integers(2, 40))])
            else:
                out.append(int(rng.integers(0, 256)))
        return bytes(out[:n])
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _tok(arr, lens, N, **kw):
    base = dict(lc=3, lp=0, pb=2, fb=32, n_iter=2)
    base.update(kw)
    return tokenize_optimal(jnp.asarray(arr), jnp.asarray(lens),
                            jnp.int32(N), **base)


def test_token_stream_covers_blocks():
    N, L = 2048, 4
    arr = np.stack([np.frombuffer(_corpus(i, N), np.uint8) for i in range(L)])
    lens = np.full(L, N, np.int32)
    tp, tl, td, tv, ntok = map(np.asarray, _tok(arr, lens, N))
    for i in range(L):
        pos = 0
        for j in range(int(ntok[i])):
            assert tp[i, j] == pos
            assert tl[i, j] >= 1
            if td[i, j] >= 0:
                assert td[i, j] < pos  # distance reaches real history
            pos += tl[i, j]
        assert pos == N


def test_band_matches_naive_dp():
    """The banded scan, the naive plane scan and the Triton kernel
    (interpret mode) are the same algorithm — token-identical."""
    from functools import partial

    from lzma_tpu.ops.device_parser import (dp_parse, dp_parse_band,
                                            dp_parse_triton)

    N, L = 1536, 3
    arr = np.stack([np.frombuffer(_corpus(i, N), np.uint8) for i in range(L)])
    lens = np.array([N, N, N - 400], np.int32)
    a = _tok(arr, lens, N, dp=dp_parse)
    b = _tok(arr, lens, N, dp=dp_parse_band)
    c = _tok(arr, lens, N, dp=partial(dp_parse_triton, interpret=True))
    for x, y, z in zip(a, b, c):
        x, y, z = map(np.asarray, (x, y, z))
        assert np.array_equal(x, y)
        assert np.array_equal(x, z)


def test_dp_kernel_one_lane_is_not_padded():
    """The kernel's buffers are lanes-last and hold exactly the caller's
    lanes: a one-lane scan masks the rest of its program instead of
    padding to DP_KERNEL_LANES, and still equals the band scan."""
    from conftest import traced_arrays

    from lzma_tpu.ops.device_parser import (DP_KERNEL_LANES, dp_parse_band,
                                            dp_parse_triton, dp_scan_inputs)

    N = 512
    arr = jnp.asarray(np.frombuffer(_corpus(1, N), np.uint8)[None, :])
    lens = jnp.asarray([N], jnp.int32)
    ld, dd, model, r0pos, replen = dp_scan_inputs(
        arr, lens, jnp.int32(N), lc=3, lp=0, pb=2, fb=32)

    def scan(dp, **kw):
        return lambda d, n, a, b: dp(d, n, a, b, model, 32, 2, False,
                                     r0pos=r0pos, replen=replen, **kw)

    _, calls = traced_arrays(scan(dp_parse_triton), arr, lens, ld, dd)
    (avals,) = calls
    assert DP_KERNEL_LANES > 1
    assert all(a.shape[-1] == 1 for a in avals)
    got = scan(dp_parse_triton, interpret=True)(arr, lens, ld, dd)
    want = scan(dp_parse_band)(arr, lens, ld, dd)
    for x, y in zip(got, want):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_device_optimal_encode_liblzma_decodes():
    """Streams built from DP tokens (incl. shortRep) must satisfy the
    strongest validity oracle."""
    p = LzmaParams(lc=3, lp=0, pb=2, dict_size=1 << 13, fast_bytes=32)
    datas = [_corpus(i, 4000) for i in range(3)]
    streams = encode_batch(datas, p, parse="optimal")
    for d, s in zip(datas, streams):
        blob = p.encode_props() + len(d).to_bytes(8, "little") + s
        assert lzma.decompress(blob, format=lzma.FORMAT_ALONE) == d


def test_optimal_beats_lazy_ratio():
    p = LzmaParams(dict_size=1 << 13, fast_bytes=32)
    datas = [_corpus(i, 6000) for i in range(3)]
    lazy = encode_batch(datas, p)
    opt = encode_batch(datas, p, parse="optimal")
    assert sum(map(len, opt)) < sum(map(len, lazy))


def test_optimal_parse_ragged_and_eos():
    p = LzmaParams(dict_size=1 << 12, fast_bytes=16, write_eos=True)
    datas = [b"z" * 700, _corpus(1, 1300), b"ab" * 400]
    streams = encode_batch(datas, p, parse="optimal", write_eos=True)
    for d, s in zip(datas, streams):
        blob = p.encode_props() + (0xFFFFFFFFFFFFFFFF).to_bytes(8, "little") + s
        assert lzma.decompress(blob, format=lzma.FORMAT_ALONE) == d


def test_seed_modes_all_valid():
    """Round-4 statistics-seed A/B surface: the list-derived seed (the
    default — no second search) and the legacy lazy-tokenize seed must
    all produce liblzma-valid streams; the default must stay within
    0.5% of the lazy seed's size (measured BETTER on the frozen corpus,
   )."""
    p = LzmaParams(lc=3, lp=0, pb=2, dict_size=1 << 13, fast_bytes=32)
    datas = [_corpus(i, 5000) for i in range(3)]
    sizes = {}
    for seed in ("lists", "lazy", "lists2"):
        streams = encode_batch(datas, p, parse=f"optimal:{seed}")
        for d, s in zip(datas, streams):
            blob = p.encode_props() + len(d).to_bytes(8, "little") + s
            assert lzma.decompress(blob, format=lzma.FORMAT_ALONE) == d
        sizes[seed] = sum(map(len, streams))
    assert sizes["lists"] <= sizes["lazy"] * 1.005
    # bare "optimal" is the lists seed
    assert sum(map(len, encode_batch(datas, p, parse="optimal"))) == \
        sizes["lists"]


def test_rep_lens_rmq_matches_compare_loop_oracle():
    """The suffix-table rep0-length trace (round 5) must equal the
    fb-round compare loop it replaced — the oracle stays in the repo
    exactly for this assertion (PARITY.md's rep0-trace identity claim)."""
    from lzma_tpu.ops.device_matcher import _rmq_search, rep_match_lens_rmq
    from lzma_tpu.ops.device_parser import _rep_match_lens

    rng = np.random.default_rng(21)
    rows = []
    for i in range(3):
        out = bytearray(rng.integers(0, 256, 30, dtype=np.uint8).tobytes())
        while len(out) < 4096:
            if rng.integers(0, 2):
                s = int(rng.integers(0, len(out)))
                out.extend(out[s : s + int(rng.integers(2, 300))])
            else:
                out.append(int(rng.integers(0, 256)))
        rows.append(np.frombuffer(bytes(out[:4096]), np.uint8))
    data = jnp.asarray(np.stack(rows))
    lens = jnp.asarray(np.array([4096, 3000, 4096], np.int32))
    for fb in (16, 32, 273):
        _, _, _, rank, T = jax.vmap(
            lambda d, n: _rmq_search(d, n, jnp.int32(4096), fb, k4=4, k8=2)
        )(data, lens)
        # a mixed rep0 trace: constant, varying, and out-of-range rows
        r0pos = jnp.asarray(np.stack([
            np.full(4096, 7, np.int32),
            (np.arange(4096) % 97).astype(np.int32),
            np.full(4096, 5000, np.int32),   # src < 0 everywhere
        ]))
        a = jax.vmap(lambda r, t, rp, n: rep_match_lens_rmq(r, t, rp, n, fb)
                     )(rank, T, r0pos, lens)
        b = _rep_match_lens(data, lens, r0pos, fb)
        assert np.array_equal(np.asarray(a), np.asarray(b)), fb
