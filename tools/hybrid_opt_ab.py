"""Hybrid-optimal A/B: ratio + host-side speed vs native bt4-opt.

Device candidate search runs wherever JAX is (CPU here is fine for ratio;
the chip does it at GB/s — bench.py measures that separately).  The
SPEED comparison isolates the HOST side: optimal parse + serialize over
precomputed lists vs the full bt4 finder + parse + serialize.
"""
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    globals().get("__file__", "tools/x.py"))))
sys.path.insert(0, _ROOT)
from lzma_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
# run on CPU when invoked with --cpu (the chip does the search in prod;
# ratio numbers are identical)
if "--cpu" in sys.argv:
    sys.argv.remove("--cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
import numpy as np

from lzma_tpu.bench.datagen import generate_bench_data
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.runtime import native


def main(size_mb=4, k4=None, k8=None, fb=32):
    import jax
    import jax.numpy as jnp

    from lzma_tpu.ops.hybrid import (DEFAULT_TIERS, _flatten_lists,
                                     _match_lists_lanes)

    tiers = dict(DEFAULT_TIERS)
    if k4 is not None:
        tiers["k4"] = k4
    if k8 is not None:
        tiers["k8"] = k8

    total = size_mb << 20
    bs, dict_size = 1 << 18, 1 << 18
    corpora = [("synthetic", generate_bench_data(total))]
    try:
        from lzma_tpu.bench.corpus import frozen_corpus

        corpora.append(("frozen", frozen_corpus()[:total]))
    except Exception:
        pass
    for name, data in corpora:
        n = len(data) // bs
        data = bytes(data[: n * bs])
        arr = np.frombuffer(data, np.uint8).reshape(n, bs)
        lens = np.full(n, bs, np.int32)
        p = LzmaParams(dict_size=dict_size, fast_bytes=fb, match_finder="bt4")

        t0 = time.perf_counter()
        cl, cd, counts = _match_lists_lanes(
            jnp.asarray(arr), jnp.asarray(lens), jnp.int32(dict_size),
            fb, **tiers)
        jax.block_until_ready(cl)
        t_dev = time.perf_counter() - t0
        cl, cd, counts = map(np.asarray, (cl, cd, counts))
        t0 = time.perf_counter()
        fl, fd, fo, pbase = _flatten_lists(cl, cd, counts, lens)
        t_flat = time.perf_counter() - t0

        # interleaved median-of-3 (host run-to-run band ~±8%)
        t_hosts, t_bts = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            payload, sizes = native.encode_candidate_blocks(
                arr.reshape(-1), bs, 3, 0, 2, dict_size, fb, fl, fd, fo,
                pbase, num_threads=2, total_len=len(data))
            t_hosts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            blob_bt = native.encode_blocks(data, p, block_size=bs,
                                           num_threads=2)
            t_bts.append(time.perf_counter() - t0)
        t_host = sorted(t_hosts)[1]
        t_bt = sorted(t_bts)[1]
        hyb_size = len(payload)
        # container header overhead excluded: compare payload totals
        import struct

        bt_payload = len(blob_bt)  # close enough (tiny header)

        avg_pairs = fl.size / len(data)
        print(f"{name}: bt4-opt {total/ t_bt/1e6:5.1f} MB/s ratio "
              f"{len(data)/bt_payload:5.3f} | hybrid-opt host "
              f"{len(data)/t_host/1e6:5.1f} MB/s ratio "
              f"{len(data)/hyb_size:5.3f} (payload only) | host speedup "
              f"x{t_bt/t_host:4.2f} | size delta "
              f"{(hyb_size - bt_payload)/bt_payload*100:+.2f}% | "
              f"{avg_pairs:.2f} pairs/pos | dev-search {t_dev:.1f}s "
              f"flat {t_flat:.1f}s (this host)")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("size_mb", nargs="?", type=int, default=4)
    ap.add_argument("--k4", type=int, default=None)
    ap.add_argument("--k8", type=int, default=None)
    ap.add_argument("--fb", type=int, default=32)
    a = ap.parse_args()
    main(a.size_mb, a.k4, a.k8, a.fb)
