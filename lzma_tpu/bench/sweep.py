"""Parameter-sweep benchmark: BASELINE config 3 without network access.

Sweeps lc/lp/pb combinations and dictionary sizes over a deterministic
mixed text/binary corpus assembled from local files (python stdlib
sources + shared objects — the offline stand-in for Silesia), running the
host-data-parallel native block codec with CRC-verified round trips.

Run: python -m lzma_tpu.bench.sweep [size_mb]
"""

from __future__ import annotations

import glob
import sys
import time

from ..format.properties import LzmaParams
from ..utils.crc import crc32


def mixed_corpus(target: int) -> bytes:
    """Deterministic text+binary mix from files present on any Linux+CPython."""
    parts = []
    for pat in (
        "/usr/local/lib/python3*/*.py",
        "/usr/lib/python3*/*.py",
        "/usr/local/lib/python3*/json/*.py",
        "/usr/local/lib/python3*/email/*.py",
    ):
        for f in sorted(glob.glob(pat))[:200]:
            try:
                with open(f, "rb") as fh:
                    parts.append(fh.read())
            except OSError:
                pass
        if sum(map(len, parts)) >= target // 2:
            break
    text = b"".join(parts)[: target // 2]
    bins = []
    for pat in ("/usr/lib/x86_64-linux-gnu/liblzma.so*", "/usr/lib/x86_64-linux-gnu/libstdc++*",
                "/usr/bin/g++*", "/opt/venv/lib/python3*/site-packages/numpy/_core/*.so"):
        for f in sorted(glob.glob(pat))[:4]:
            try:
                with open(f, "rb") as fh:
                    bins.append(fh.read())
            except OSError:
                pass
        if sum(map(len, bins)) >= target // 2:
            break
    binary = b"".join(bins)[: target - len(text)]
    return (text + binary)[:target]


def _run(data, params, block_size, out=print):
    from ..runtime import native

    digest = crc32(data)
    t0 = time.perf_counter()
    blob = native.encode_blocks(data, params, block_size=block_size, num_threads=0)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = native.decode_blocks(blob, num_threads=0)
    t_dec = time.perf_counter() - t0
    assert crc32(back) == digest, "sweep round-trip CRC mismatch"
    n = len(data)
    return n / len(blob), n / t_enc / 1e6, n / t_dec / 1e6


LCLPPB_GRID = [(3, 0, 2), (0, 2, 0), (1, 1, 1), (4, 0, 2), (2, 0, 0), (0, 0, 0)]
DICT_GRID = [1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24, 1 << 26]


def main(size_mb: int = 8, out=print):
    data = mixed_corpus(size_mb << 20)
    out(f"mixed corpus: {len(data)/1e6:.1f} MB (text+binary), "
        f"host-parallel native blocks\n")
    out("| lc | lp | pb | dict | ratio | enc MB/s | dec MB/s |")
    out("|---|---|---|---|---|---|---|")
    for lc, lp, pb in LCLPPB_GRID:
        p = LzmaParams(lc=lc, lp=lp, pb=pb, dict_size=1 << 20, fast_bytes=32)
        r, e, d = _run(data, p, 1 << 20)
        out(f"| {lc} | {lp} | {pb} | 1M | {r:.3f} | {e:.1f} | {d:.1f} |")
    for dict_size in DICT_GRID:
        p = LzmaParams(dict_size=dict_size, fast_bytes=32)
        bs = max(min(dict_size, 1 << 22), 1 << 16)
        r, e, d = _run(data, p, bs)
        out(f"| 3 | 0 | 2 | {dict_size >> 10}K | {r:.3f} | {e:.1f} | {d:.1f} |")

    # dictionary modes: plain vs v2 prefix preset vs v3 trained (stored)
    # vs v3 auto-sized — the container-size trade (DESIGN-NOTES.md),
    # regenerable here
    from ..runtime import native
    from ..utils.dicttrain import select_dictionary, train_dictionary

    out("\n| container mode (bs=64K, dict=1M) | size | Δ vs plain |")
    out("|---|---|---|")
    p = LzmaParams(dict_size=1 << 20, fast_bytes=32)
    bs = 1 << 16
    base = len(native.encode_blocks(data, p, block_size=bs))
    out(f"| v1 plain | {base} | — |")
    for name, kw in (
        ("v2 prefix preset (D=bs/4)", dict(preset_len=bs // 4)),
        ("v3 trained (D=bs/4)",
         dict(dictionary=train_dictionary(data, bs // 4))),
        ("v3 auto-sized",
         dict(dictionary=select_dictionary(data, p, block_size=bs))),
    ):
        if not kw.get("preset_len") and not kw.get("dictionary"):
            continue  # auto-sizer chose no dictionary
        blob = native.encode_blocks(data, p, block_size=bs, **kw)
        assert crc32(native.decode_blocks(blob)) == crc32(data)
        out(f"| {name} | {len(blob)} | {(len(blob)/base-1)*100:+.2f}% |")


if __name__ == "__main__":
    if len(sys.argv) > 1 and not sys.argv[1].isdigit():
        print(__doc__)
        sys.exit(0)
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
