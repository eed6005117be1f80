"""Host optimal-parse DP shave A/B.

Times the native bt4-optimal single-thread block encode on the frozen
corpus (the host-side cost the hybrid pipeline and bt4-opt both pay).
Median of N interleaved runs; run before/after a lzma_core.cpp change
(rebuild with: python -m lzma_tpu.runtime.build).
"""
import sys
import time

sys.path.insert(0, ".")
from lzma_tpu.bench.corpus import frozen_corpus
from lzma_tpu.bench.datagen import generate_bench_data
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.runtime import native


def med(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def main(trials=5):
    corpora = [("frozen", frozen_corpus()), ("synthetic", generate_bench_data(4 << 20))]
    p = LzmaParams(dict_size=1 << 20, fast_bytes=32, match_finder="bt4")
    for name, data in corpora:
        ts = []
        for _ in range(trials):
            t0 = time.perf_counter()
            blob = native.encode_blocks(data, p, block_size=1 << 20, num_threads=1)
            ts.append(time.perf_counter() - t0)
        t = med(ts)
        assert native.decode_blocks(blob) == data
        print(f"{name}: {len(data)/t/1e6:.2f} MB/s (median of {trials}; "
              f"min {len(data)/max(ts)/1e6:.2f}, max {len(data)/min(ts)/1e6:.2f}) "
              f"ratio {len(data)/len(blob):.3f} size {len(blob)}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5)
