"""Hybrid-OPTIMAL pipeline: device candidate lists -> native optimal
parser.

The plumbing oracle: feeding the native CAND finder the EXACT per-position
match lists of the scalar BT4 BinTree must reproduce the native
bt4-optimal encoder's bytes IDENTICALLY (the parser is the same; only the
list source changes — contract: BinTree.java:152-273)."""

import numpy as np
import pytest

from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.match.bintree import BinTreeMatchFinder

try:
    from lzma_tpu.runtime import native

    HAVE_NATIVE = native.available()
except Exception:
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE, reason="native runtime not built")


def bt4_lists(data: bytes, dict_size: int, fb: int):
    """Exact BT4 (len, dist) lists for every position."""
    mf = BinTreeMatchFinder(data, dict_size, fb, num_hash_bytes=4)
    lens, dists, offs = [], [], [0]
    for _ in range(len(data)):
        pairs = mf.find_matches()
        for ln, d in pairs:
            lens.append(ln)
            dists.append(d)
        offs.append(len(lens))
    return (np.asarray(lens, np.int32), np.asarray(dists, np.int32),
            np.asarray(offs, np.int64))


def test_cand_parser_reproduces_bt4_exactly():
    import sys
    sys.path.insert(0, "tests")
    from conftest import fixture_bytes

    data = fixture_bytes()[: 1 << 14]
    dict_size, fb = 1 << 16, 32
    cl, cd, co = bt4_lists(data, dict_size, fb)
    payload, sizes = native.encode_candidate_blocks(
        np.frombuffer(data, np.uint8), len(data), 3, 0, 2, dict_size, fb,
        cl, cd, co, [0], num_threads=1)
    # reference: the native bt4 optimal block encoder on the same block
    p = LzmaParams(dict_size=dict_size, fast_bytes=fb, match_finder="bt4")
    want = native.encode_stream(data, p, optimal=True)
    assert payload == want
    assert sizes == [len(want)]


def test_cand_parser_roundtrip_blocks():
    from lzma_tpu.bench.datagen import generate_bench_data

    data = generate_bench_data(1 << 16)
    bs, dict_size, fb = 1 << 14, 1 << 14, 16
    n_blocks = len(data) // bs
    cls, cds, cos, pbase = [], [], [], []
    pair_base = 0
    off_base = 0
    for i in range(n_blocks):
        blk = bytes(data[i * bs:(i + 1) * bs])
        cl, cd, co = bt4_lists(blk, dict_size, fb)
        cls.append(cl)
        cds.append(cd)
        cos.append(co + pair_base)
        pbase.append(off_base)
        pair_base += len(cl)
        off_base += len(co)
    payload, sizes = native.encode_candidate_blocks(
        np.frombuffer(bytes(data), np.uint8), bs, 3, 0, 2, dict_size, fb,
        np.concatenate(cls) if cls else np.zeros(0, np.int32),
        np.concatenate(cds) if cds else np.zeros(0, np.int32),
        np.concatenate(cos), pbase, num_threads=2)
    # every stream decodes back
    off = 0
    out = b""
    p = LzmaParams(dict_size=dict_size, fast_bytes=fb)
    for i, sz in enumerate(sizes):
        blk_len = min(bs, len(data) - i * bs)
        out += native.decode_stream(payload[off:off + sz], p, blk_len)
        off += sz
    assert out == data


def test_hybrid_optimal_container_roundtrip():
    from lzma_tpu.bench.datagen import generate_bench_data
    from lzma_tpu.ops.hybrid import encode_blocks_hybrid_optimal

    data = generate_bench_data((1 << 16) + 1234)  # partial last block
    p = LzmaParams(dict_size=1 << 14, fast_bytes=16)
    blob = encode_blocks_hybrid_optimal(data, p, block_size=1 << 14,
                                        num_threads=2)
    assert native.decode_blocks(blob) == data


def test_hybrid_optimal_ratio_near_bt4():
    """Candidate-quality gate: the hybrid-optimal container should land
    close to native bt4-opt (the round-1 gap was ~5% with the K=4 greedy
    finder; the multi-tier lists + optimal parse close most of it)."""
    from lzma_tpu.bench.datagen import generate_bench_data
    from lzma_tpu.ops.hybrid import encode_blocks_hybrid_optimal

    data = generate_bench_data(1 << 17)
    p = LzmaParams(dict_size=1 << 14, fast_bytes=32, match_finder="bt4")
    blob_h = encode_blocks_hybrid_optimal(data, p, block_size=1 << 14)
    blob_bt = native.encode_blocks(data, p, block_size=1 << 14)
    assert native.decode_blocks(blob_h) == data
    # within 3% of bt4-opt on the synthetic corpus (chip sweeps push the
    # candidate count higher)
    assert len(blob_h) <= len(blob_bt) * 1.03, (len(blob_h), len(blob_bt))


def test_hybrid_optimal_preset_variants():
    from lzma_tpu.bench.datagen import generate_bench_data
    from lzma_tpu.ops.hybrid import encode_blocks_hybrid_optimal

    data = generate_bench_data(1 << 16)
    p = LzmaParams(dict_size=1 << 14, fast_bytes=16)
    blob_v2 = encode_blocks_hybrid_optimal(data, p, block_size=1 << 14,
                                           preset_len=1 << 12)
    assert native.decode_blocks(blob_v2) == data
    dictionary = bytes(data[1 << 13 : (1 << 13) + 2048])
    blob_v3 = encode_blocks_hybrid_optimal(data, p, block_size=1 << 14,
                                           dictionary=dictionary)
    assert native.decode_blocks(blob_v3) == data


def test_compress_backend_hybrid_roundtrip():
    """compress(backend="hybrid") is the public hybrid-optimal surface:
    LZTB out, decodable by the standard decoder."""
    import lzma_tpu
    from lzma_tpu.bench.datagen import generate_bench_data

    data = generate_bench_data((1 << 16) + 77)
    blob = lzma_tpu.compress(data, container="lztb", backend="hybrid",
                             block_size=1 << 14, dict_size=1 << 14,
                             fast_bytes=16)
    assert lzma_tpu.decompress(blob) == data
    # hybrid is a block pipeline: the alone container rejects it loudly
    with pytest.raises(ValueError):
        lzma_tpu.compress(data, backend="hybrid")
    with pytest.raises(ValueError):
        lzma_tpu.compress(data, container="lztb", backend="nope")


def test_hybrid_optimal_tiers_kwarg():
    """Tier overrides flow through to the device search; shallow tiers
    still produce a valid (just larger) container."""
    from lzma_tpu.bench.datagen import generate_bench_data
    from lzma_tpu.ops.hybrid import encode_blocks_hybrid_optimal

    data = generate_bench_data(1 << 15)
    p = LzmaParams(dict_size=1 << 14, fast_bytes=16)
    blob_deep = encode_blocks_hybrid_optimal(data, p, block_size=1 << 14)
    blob_shallow = encode_blocks_hybrid_optimal(
        data, p, block_size=1 << 14, tiers=dict(k4=2, k8=1, k16=0))
    assert native.decode_blocks(blob_deep) == data
    assert native.decode_blocks(blob_shallow) == data
    assert len(blob_deep) <= len(blob_shallow)


def test_hybrid_optimal_honors_fb_above_64():
    """fb > 64 must flow through to the candidate compare depth and the
    host parse (the lazy tokenizer caps at 64; this pipeline must not —
    reference fb range 5..273, Encoder.java:1148-1154)."""
    import warnings

    from lzma_tpu.ops.hybrid import encode_blocks_hybrid_optimal

    data = (b"a pattern that repeats well beyond sixty-four bytes! " * 40)
    p = LzmaParams(dict_size=1 << 14, fast_bytes=128)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no clamp warning may fire
        blob = encode_blocks_hybrid_optimal(data, p, block_size=1 << 14)
    assert native.decode_blocks(blob) == data


def test_pack_match_lists_equivalence_and_overflow():
    """Device-side flatten (pack_match_lists) must reproduce the
    host-side flatten byte-for-byte at a generous cap, and degrade by
    CLAMPING counts (consistent offsets, valid streams) when the pair
    budget overflows."""
    import jax.numpy as jnp

    from lzma_tpu.bench.datagen import generate_bench_data
    from lzma_tpu.ops.hybrid import (DEFAULT_TIERS, _flatten_lists,
                                     _flatten_packed, _match_lists_lanes,
                                     _match_lists_lanes_packed)

    bs = 1 << 12
    data = generate_bench_data(bs * 3)
    arr = np.frombuffer(data, np.uint8).reshape(3, bs)
    lens = np.full(3, bs, np.int32)
    cl, cd, counts = _match_lists_lanes(
        jnp.asarray(arr), jnp.asarray(lens), jnp.int32(bs), 32,
        **DEFAULT_TIERS)
    ref = _flatten_lists(np.asarray(cl), np.asarray(cd),
                         np.asarray(counts), lens)
    fl, fd, ce = _match_lists_lanes_packed(
        jnp.asarray(arr), jnp.asarray(lens), jnp.int32(bs), 32, 3 * bs,
        **DEFAULT_TIERS)
    got = _flatten_packed(np.asarray(fl), np.asarray(fd), np.asarray(ce),
                          lens)
    for r, g, name in zip(ref, got, ("lens", "dists", "offs", "base")):
        assert np.array_equal(r, g), name

    # tiny cap: counts clamp, offsets stay consistent with the buffers,
    # and the resulting container still round-trips
    cap = bs // 4
    fl2, fd2, ce2 = _match_lists_lanes_packed(
        jnp.asarray(arr), jnp.asarray(lens), jnp.int32(bs), 32, cap,
        **DEFAULT_TIERS)
    ce2 = np.asarray(ce2)
    assert (ce2.sum(axis=1) <= cap).all()
    l2, d2, o2, b2 = _flatten_packed(np.asarray(fl2), np.asarray(fd2),
                                     ce2, lens)
    payload, sizes = native.encode_candidate_blocks(
        arr.reshape(-1), bs, 3, 0, 2, bs, 32, l2, d2, o2, b2,
        num_threads=1, total_len=len(data))
    off = 0
    out = b""
    for i, sz in enumerate(sizes):
        out += native.decode_stream(payload[off:off + sz],
                                    LzmaParams(dict_size=bs, fast_bytes=32),
                                    bs)
        off += sz
    assert out == data


def _lz_mix_corpus(seed, size):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = bytearray(rng.integers(0, 256, 50, dtype=np.uint8).tobytes())
    while len(out) < size:
        if rng.integers(0, 2):
            s = int(rng.integers(0, len(out)))
            out.extend(out[s : s + int(rng.integers(2, 400))])
        else:
            out.append(int(rng.integers(0, 256)))
    return bytes(out[:size])


def test_rmq_lists_identical_to_compare_loop():
    """The suffix-rank RMQ engine must produce EXACTLY the compare-loop
    lists at EVERY fb (round 5: prefix doubling makes the sort depth
    exact past 32 — it replaces the compare loop on every search path,
    and identity is the safety proof).  Mixed corpora: LZ-structured
    random (long repeats exercise the deep levels), real text, and an
    all-same-byte worst case (every consecutive LCP saturates)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lzma_tpu.bench.corpus import frozen_corpus
    from lzma_tpu.ops.device_matcher import (find_match_lists,
                                             find_match_lists_rmq)

    tiers = dict(k4=12, k6=4, k8=6, k16=3, k32=2)
    lzmix = _lz_mix_corpus(77, 6000)
    text = frozen_corpus()[1 << 16 : (1 << 16) + 8192]
    runs = b"a" * 3000 + b"b" * 3000 + lzmix[:2192]
    for corpus, n, fb, dict_size in (
            (lzmix, 6000, 32, 8192), (lzmix, 8192, 16, 2048),
            (lzmix, 4097, 5, 8192), (lzmix, 6000, 64, 8192),
            (lzmix, 8192, 128, 8192), (lzmix, 6000, 273, 8192),
            (text, 8192, 64, 4096), (text, 8192, 273, 8192),
            (runs, 8192, 128, 8192)):
        arr = jnp.asarray(np.frombuffer(
            (corpus + b"\0" * 8192)[:8192], np.uint8))
        a = find_match_lists(arr, jnp.int32(n), jnp.int32(dict_size),
                             fb, **tiers)
        b = find_match_lists_rmq(arr, jnp.int32(n), jnp.int32(dict_size),
                                 fb, **tiers)
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y)), (n, fb)


def test_best_matches_rmq_identical_to_compare_loop():
    """The lazy tokenizer's RMQ engine must reproduce find_best_matches
    EXACTLY (selection by fb-capped length with nearest tie-break, then
    the 273 extension of the chosen pair) — it replaces the compare +
    extension loops on the default device tokenize path."""
    import jax.numpy as jnp
    import numpy as np

    from lzma_tpu.bench.corpus import frozen_corpus
    from lzma_tpu.ops.device_matcher import (find_best_matches,
                                             find_best_matches_rmq)

    lzmix = _lz_mix_corpus(42, 8000)
    text = frozen_corpus()[1 << 18 : (1 << 18) + 8192]
    runs = b"x" * 4000 + _lz_mix_corpus(7, 4192)
    for corpus, n, fb, ds, k in ((lzmix, 8000, 32, 8192, 4),
                                 (lzmix, 8192, 64, 2048, 4),
                                 (text, 8192, 32, 8192, 2),
                                 (text, 6000, 273, 8192, 4),
                                 (runs, 8192, 16, 8192, 8)):
        arr = jnp.asarray(np.frombuffer(
            (corpus + b"\0" * 8192)[:8192], np.uint8))
        a = find_best_matches(arr, jnp.int32(n), jnp.int32(ds), fb, k)
        b = find_best_matches_rmq(arr, jnp.int32(n), jnp.int32(ds), fb, k)
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y)), (n, fb, k)


def test_rmq_m_cap_lists_valid_subset():
    """With the DP right-sizing cap on, each merged list must be a
    VALID ascending list whose pairs all appear in the uncapped list
    (the cap drops far candidates, never invents or reorders)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lzma_tpu.ops.device_matcher import find_match_lists_rmq

    tiers = dict(k4=12, k6=4, k8=6, k16=3, k32=2)
    data = _lz_mix_corpus(13, 8192)
    arr = jnp.asarray(np.frombuffer(data, np.uint8))
    from lzma_tpu.ops.device_matcher import _rmq_search

    full = find_match_lists_rmq(arr, jnp.int32(8192), jnp.int32(8192),
                                32, **tiers)
    fl, fd, fc = (np.asarray(x) for x in full)
    pairs_full = [set(zip(fl[i, :fc[i]], fd[i, :fc[i]]))
                  for i in range(8192)]
    for kw in (dict(m_cap=8),                      # nearest-first cap
               dict(m_cap=12, m_cap_order="rr")):  # production rr cap
        if "m_cap_order" in kw:
            capped = jax.jit(lambda a: _rmq_search(
                a, jnp.int32(8192), jnp.int32(8192), 32, **tiers,
                **kw)[:3])(arr)
        else:
            capped = find_match_lists_rmq(
                arr, jnp.int32(8192), jnp.int32(8192), 32, **tiers, **kw)
        cl, cd, cc = (np.asarray(x) for x in capped)
        for i in range(8192):
            row_l, row_d = cl[i, :cc[i]], cd[i, :cc[i]]
            assert (np.diff(row_l) > 0).all() and \
                (np.diff(row_d) > 0).all(), i
            for p in zip(row_l, row_d):
                assert p in pairs_full[i], (i, p, kw)
