"""Candidate-tier sweep for the hybrid-optimal pipeline: measure frozen-corpus container-size delta vs native bt4-opt
for tier configurations of device_matcher.find_match_lists.

The device search runs on CPU here (ratio is backend-independent); the
chip rate for the winning config is measured separately (bench.py /
tools/chip probes).  Host parse time is reported per config because more
pairs/pos costs DP time.

Usage: python tools/cand_sweep.py [size_mb] [--corpus frozen|synthetic]
"""
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    globals().get("__file__", "tools/x.py"))))
sys.path.insert(0, _ROOT)
from lzma_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from lzma_tpu.format.properties import LzmaParams  # noqa: E402
from lzma_tpu.runtime import native  # noqa: E402

CONFIGS = [
    # (label, dict of tier kwargs for _match_lists_lanes)
    ("k4=8 k8=4 k16=2 k32=2", dict(k4=8, k8=4, k16=2, k32=2)),
    ("k4=8 k6=4 k8=4 k16=2 k32=2", dict(k4=8, k6=4, k8=4, k16=2, k32=2)),
    ("k4=16 k8=8 k16=4 k32=2", dict(k4=16, k8=8, k16=4, k32=2)),
    ("k4=16 k6=8 k8=8 k16=4 k32=2", dict(k4=16, k6=8, k8=8, k16=4, k32=2)),
    ("k4=12 k6=4 k8=6 k16=3 k32=2", dict(k4=12, k6=4, k8=6, k16=3, k32=2)),
]


def main(size_mb=2, corpus="frozen", fb=32):
    import jax.numpy as jnp

    from lzma_tpu.ops.hybrid import _flatten_lists, _match_lists_lanes

    total = size_mb << 20
    bs = dict_size = 1 << 18
    if corpus == "frozen":
        from lzma_tpu.bench.corpus import frozen_corpus

        data = frozen_corpus()[:total]
    else:
        from lzma_tpu.bench.datagen import generate_bench_data

        data = generate_bench_data(total)
    n = len(data) // bs
    data = bytes(data[: n * bs])
    arr = np.frombuffer(data, np.uint8).reshape(n, bs)
    lens = np.full(n, bs, np.int32)
    p = LzmaParams(dict_size=dict_size, fast_bytes=fb, match_finder="bt4")

    t0 = time.perf_counter()
    blob_bt = native.encode_blocks(data, p, block_size=bs, num_threads=2)
    t_bt = time.perf_counter() - t0
    print(f"{corpus} {len(data)/1e6:.1f} MB | bt4-opt ratio "
          f"{len(data)/len(blob_bt):.3f} ({len(blob_bt)} B) "
          f"{len(data)/t_bt/1e6:.1f} MB/s", flush=True)

    for label, kw in CONFIGS:
        t0 = time.perf_counter()
        cl, cd, counts = _match_lists_lanes(
            jnp.asarray(arr), jnp.asarray(lens), jnp.int32(dict_size),
            fb, **kw)
        jax.block_until_ready(cl)
        t_dev = time.perf_counter() - t0
        cl, cd, counts = map(np.asarray, (cl, cd, counts))
        fl, fd, fo, pbase = _flatten_lists(cl, cd, counts, lens)
        t0 = time.perf_counter()
        payload, sizes = native.encode_candidate_blocks(
            arr.reshape(-1), bs, 3, 0, 2, dict_size, fb, fl, fd, fo, pbase,
            num_threads=2, total_len=len(data))
        t_host = time.perf_counter() - t0
        delta = (len(payload) - len(blob_bt)) / len(blob_bt) * 100
        print(f"  {label:34s} delta {delta:+.2f}%  host "
              f"{len(data)/t_host/1e6:5.1f} MB/s (x{t_bt/t_host:4.2f})  "
              f"{fl.size/len(data):4.2f} pairs/pos  dev {t_dev:4.1f}s",
              flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("size_mb", nargs="?", type=int, default=2)
    ap.add_argument("--corpus", default="frozen")
    ap.add_argument("--fb", type=int, default=32)
    a = ap.parse_args()
    main(a.size_mb, a.corpus, a.fb)
