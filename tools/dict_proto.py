#!/usr/bin/env python
"""Trainer-refinement prototype: A/B the fastcover segment selection.

Variants over the SAME scoring machinery as utils/dicttrain.py:
  corpus : epochs processed in corpus order (the shipped behavior)
  score  : epochs processed in descending initial-score order, each
           epoch re-scored against the current (partially zeroed)
           frequency table before acceptance — the lazy-greedy cover
           refinement: an early mediocre segment can no longer steal
           d-mers from a later, better one.
plus a finer k/d sweep around the recorded k=32/d=6 knee.

Metric: LZTB v3 container size delta vs the no-dictionary container
(bt4-optimal, dict 2^20, bs=2^16, D=bs/4), on two real corpora
("text mix", "hetero").
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from lzma_tpu.bench.sweep import mixed_corpus
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.runtime import native
from lzma_tpu.utils.dicttrain import _dmer_index


def train(buf, dict_size, k=32, d=6, table_bits=17, order="corpus"):
    n = len(buf)
    arr = np.frombuffer(buf, dtype=np.uint8)
    idx = _dmer_index(arr, d, table_bits)
    freq = np.bincount(idx, minlength=1 << table_bits).astype(np.int64)
    num_segments = max(1, dict_size // k)
    if n // num_segments < k:
        num_segments = max(1, n // k)
    epoch = n // num_segments
    w = k - d + 1
    min_score = 2 * w

    def best_of(lo, hi):
        eidx = idx[lo : hi - d + 1]
        f = freq[eidx]
        c = np.cumsum(f)
        scores = c[w - 1 :].copy()
        scores[1:] -= c[: len(scores) - 1]
        p = int(np.argmax(scores))
        return int(scores[p]), lo + p

    bounds = []
    for s in range(num_segments):
        lo = s * epoch
        hi = n if s == num_segments - 1 else (s + 1) * epoch
        if hi - lo >= k:
            bounds.append((lo, hi))

    chosen = []
    if order == "corpus":
        for lo, hi in bounds:
            sc, p = best_of(lo, hi)
            if sc < min_score:
                continue
            chosen.append((sc, buf[p : p + k]))
            freq[idx[p : p + w]] = 0
    else:  # score order with re-score before acceptance
        initial = [best_of(lo, hi) + (lo, hi) for lo, hi in bounds]
        initial.sort(key=lambda t: -t[0])
        for _, _, lo, hi in initial:
            sc, p = best_of(lo, hi)  # re-score under current freq
            if sc < min_score:
                continue
            chosen.append((sc, buf[p : p + k]))
            freq[idx[p : p + w]] = 0
    if not chosen:
        return buf[:dict_size]
    chosen.sort(key=lambda t: t[0])
    cat = b"".join(seg for _, seg in chosen)
    return cat[-dict_size:]


def hetero_corpus(target):
    import glob
    bins = []
    for pat in ("/usr/lib/x86_64-linux-gnu/liblzma.so*",):
        for f in sorted(glob.glob(pat))[:2]:
            bins.append(open(f, "rb").read())
    binary = b"".join(bins)[: 1 << 20]
    text = mixed_corpus(target)[: target - len(binary)]
    return (binary + text)[:target]


def main():
    bs = 1 << 16
    D = bs // 4
    p = LzmaParams(dict_size=1 << 20, fast_bytes=32, match_finder="bt4")
    corpora = [("text", mixed_corpus(6 << 20)), ("hetero", hetero_corpus(5 << 20))]
    for name, data in corpora:
        base = len(native.encode_blocks(data, p, block_size=bs, num_threads=0))
        print(f"== {name}: {len(data)/1e6:.1f} MB, no-dict container {base} B")
        rows = []
        for order in ("corpus", "score"):
            for k, d in ((32, 6), (16, 6), (24, 6), (48, 6), (64, 6),
                         (32, 4), (32, 8), (16, 4)):
                t0 = time.perf_counter()
                dct = train(data, D, k=k, d=d, order=order)
                tt = time.perf_counter() - t0
                blob = native.encode_blocks(data, p, block_size=bs,
                                            num_threads=0, dictionary=dct)
                assert native.decode_blocks(blob, num_threads=0) == data
                delta = 100.0 * (len(blob) - base) / base
                rows.append((delta, order, k, d, len(dct), tt))
                print(f"  {order:6s} k={k:3d} d={d}  dict={len(dct):6d}B  "
                      f"container {len(blob):8d}  Δ {delta:+.2f}%  ({tt:.2f}s)")
        best = min(rows)
        print(f"  BEST: {best[1]} k={best[2]} d={best[3]} Δ {best[0]:+.2f}%")


if __name__ == "__main__":
    main()
