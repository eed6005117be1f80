"""Automatic lc/lp/pb selection by measured cost on a data sample.

The reference exposes lc/lp/pb as expert switches and leaves choosing
them to the user (Encoder.java:1169-1180); the right values are
data-dependent (text wants literal context bits, word-aligned binary
wants literal POSITION bits — an lc/lp/pb sweep spans a 1%+
container-size spread on real corpora).  This module picks
them the same way `utils/dicttrain.select_dictionary` sizes trained
dictionaries: encode a spread sample with each candidate and keep the
measured-cheapest, with a margin rule so noise never flips away from
the caller's baseline.
"""

from __future__ import annotations

from dataclasses import replace

from ..format.properties import LzmaParams

#: (lc, lp, pb) candidates: the reference default (text), word-aligned
#: binary profiles, and low-state variants that win on simple/periodic
#: data.  The baseline's own triple is
#: always scored first.
DEFAULT_CANDIDATES = ((3, 0, 2), (0, 2, 0), (2, 0, 0), (0, 0, 0), (1, 1, 1))


def select_params(
    data,
    params: LzmaParams | None = None,
    block_size: int = 1 << 20,
    sample_blocks: int = 8,
    sample_size: int = 1 << 16,
    candidates=None,
    margin: float = 0.002,
) -> LzmaParams:
    """Return `params` with lc/lp/pb replaced by the measured-best triple.

    Scores each candidate by actual compressed size of up to
    `sample_blocks` windows of `sample_size` bytes spread across the
    input (one per sampled block, so every ~block of a large input is
    represented).  The baseline triple wins ties and anything within
    `margin` of the best, so the tuner only moves on real signal.
    """
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = bytes(data)
    else:
        buf = b"".join(bytes(s) for s in data)
    params = (params or LzmaParams()).validated_for_encode()
    if not buf:
        return params
    block_size = max(int(block_size), 1)  # 0 is valid for "alone" callers

    try:
        from ..runtime import native

        if not native.available():
            raise RuntimeError
        enc = lambda b, p: native.encode_stream(b, p)  # noqa: E731
    except Exception:
        from ..codec.encoder import encode_stream

        enc = lambda b, p: encode_stream(b, p)  # noqa: E731

    n_blocks = max(1, (len(buf) + block_size - 1) // block_size)
    k = max(1, min(sample_blocks, n_blocks))
    if k == 1:
        idxs = [0]
    else:
        idxs = sorted({round(i * (n_blocks - 1) / (k - 1)) for i in range(k)})
    samples = [buf[i * block_size : i * block_size + sample_size] for i in idxs]
    samples = [s for s in samples if s]

    base = (params.lc, params.lp, params.pb)
    cands = [base] + [c for c in (candidates or DEFAULT_CANDIDATES)
                      if c != base]
    costs = {}
    for lc, lp, pb in cands:
        p = replace(params, lc=lc, lp=lp, pb=pb)
        costs[(lc, lp, pb)] = sum(len(enc(s, p)) for s in samples)
    best = min(cands, key=lambda c: costs[c])
    if costs[base] <= costs[best] * (1.0 + margin):
        best = base
    return replace(params, lc=best[0], lp=best[1], pb=best[2])
