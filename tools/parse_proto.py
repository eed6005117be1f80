"""Prototype: price-based segment-DP parse over device-matcher candidates.

Measures the container-size effect of replacing the pointwise greedy/lazy
parse decision with a backward dynamic program over STATIC structural
prices (the init-probability cost of each symbol shape), before building
the device scan version.  The DP considers, per position, the literal edge
and a sampled grid of lengths of the best match candidate; segments are
independent (matches truncate at segment ends) so the device version can
run all segments lock-step in one lax.scan.

Usage: python tools/parse_proto.py [corpus]   (cpu jax; exact sizes via
the native TokenEncoder — the same serializer the hybrid pipeline uses)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.runtime import native
from lzma_tpu.ops.device_matcher import find_best_matches, tokenize

# sampled shortening grid (the device scan will gather d[] at these)
LGRID = np.array([2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32, 48, 64, 96, 128,
                  192, 273], dtype=np.int32)
SEG = 1024


def len_bits(l):
    l = np.asarray(l)
    return np.where(l <= 9, 4.0, np.where(l <= 17, 5.0, 10.0))


def dist_bits(d):
    """isMatch + isRep + slot tree + direct/align bits (init probs)."""
    d = np.asarray(d, dtype=np.int64)
    bl = np.zeros_like(d)
    x = d.copy()
    for _ in range(31):
        bl = np.where(x > 0, bl + 1, bl)
        x >>= 1
    slot = np.where(d < 4, d, (2 * (bl - 1)) + ((d >> np.maximum(bl - 2, 0)) & 1))
    extra = np.maximum(slot // 2 - 1, 0)
    return 2.0 + 6.0 + extra.astype(np.float64)


LIT_BITS = 9.0


def dp_parse(best_len, best_dist, n, seg=SEG):
    """Backward segment DP -> (t_len, t_dist) choice per position."""
    L = len(LGRID)
    choice_len = np.ones(n, dtype=np.int32)
    choice_dist = np.full(n, -1, dtype=np.int32)
    mb_cache = dist_bits(np.maximum(best_dist[:n], 0))
    for s in range(0, n, seg):
        e = min(s + seg, n)
        S = e - s
        d = np.zeros(S + 1, dtype=np.float64)
        cl = np.ones(S, dtype=np.int32)
        for i in range(e - 1, s - 1, -1):
            j = i - s
            best = LIT_BITS + d[j + 1]
            bl = min(int(best_len[i]), e - i)
            pick = 1
            if bl >= 2:
                db = mb_cache[i]
                ls = LGRID[LGRID <= bl]
                costs = len_bits(ls) + db + d[j + ls]
                k = int(np.argmin(costs))
                if costs[k] < best:
                    best = float(costs[k])
                    pick = int(ls[k])
            d[j] = best
            cl[j] = pick
        i = s
        while i < e:
            if cl[i - s] > 1:
                choice_len[i] = cl[i - s]
                choice_dist[i] = best_dist[i]
            i += cl[i - s]
    return choice_len, choice_dist


def tokens_from_choice(choice_len, choice_dist, n):
    tp, tl, td = [], [], []
    i = 0
    while i < n:
        tp.append(i)
        tl.append(int(choice_len[i]))
        td.append(int(choice_dist[i]))
        i += max(int(choice_len[i]), 1)
    return (np.asarray(tp, np.int32), np.asarray(tl, np.int32),
            np.asarray(td, np.int32))


def container_size(blocks, tokens, params, bs):
    n = len(blocks)
    arr = np.zeros((n, bs), dtype=np.uint8)
    for i, b in enumerate(blocks):
        arr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    counts = np.asarray([len(t[0]) for t in tokens], dtype=np.int64)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    fp = np.concatenate([t[0] for t in tokens])
    fl = np.concatenate([t[1] for t in tokens])
    fd = np.concatenate([t[2] for t in tokens])
    payload, sizes = native.encode_token_blocks(
        arr.reshape(-1), bs, params.lc, params.lp, params.pb,
        fp, fl, fd, offsets, counts)
    return sum(sizes) + 4 * n


def main():
    from lzma_tpu.bench.datagen import generate_bench_data

    which = sys.argv[1] if len(sys.argv) > 1 else "synthetic"
    if which == "synthetic":
        data = generate_bench_data(4 << 20)
    else:
        import glob
        parts = [open(f, "rb").read() for f in
                 sorted(glob.glob("/usr/local/lib/python3.12/*.py"))]
        data = b"".join(parts)[: 4 << 20]
    bs = 1 << 16
    params = LzmaParams(dict_size=bs, fast_bytes=32)
    blocks = [data[i : i + bs] for i in range(0, len(data), bs)]
    fb, K = 32, 4

    toks_lazy, toks_dp, toks_greedy = [], [], []
    for b in blocks:
        arr = np.zeros(bs, dtype=np.uint8)
        arr[: len(b)] = np.frombuffer(b, dtype=np.uint8)
        n = len(b)
        bl, bd = find_best_matches(jnp.asarray(arr), jnp.int32(n),
                                   jnp.int32(bs), fb, K)
        bl, bd = np.asarray(bl), np.asarray(bd)
        for lazy, dst in ((True, toks_lazy), (False, toks_greedy)):
            tp, tl, td, tv, nt = tokenize(jnp.asarray(arr), jnp.int32(n),
                                          jnp.int32(bs), fb, K, lazy=lazy)
            c = int(nt)
            dst.append((np.asarray(tp)[:c], np.asarray(tl)[:c],
                        np.asarray(td)[:c]))
        cl, cd = dp_parse(bl, bd, n)
        toks_dp.append(tokens_from_choice(cl, cd, n))

    for name, toks in (("greedy", toks_greedy), ("lazy", toks_lazy),
                       ("dp-static", toks_dp)):
        sz = container_size(blocks, toks, params, bs)
        print(f"{name:10s}: {sz:9d} bytes  ratio {len(data)/sz:.4f}")

    # ceiling: native bt4 + live-price optimal parse
    blob = native.encode_blocks(bytes(data), params, block_size=bs)
    print(f"{'bt4-opt':10s}: {len(blob):9d} bytes  ratio {len(data)/len(blob):.4f}")


if __name__ == "__main__":
    main()
