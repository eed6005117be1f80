"""Hybrid encode pipeline: device match search + native serialization.

The split of LZMA between an accelerator and the host:

  * the O(n log n) expensive part — match finding + greedy parse — runs on
    the device as sort/compare/scan vector work (ops/device_matcher.py);
  * the O(compressed-bits) inherently bit-serial part — LZMA state
    machine + adaptive range coding — runs on the host native runtime
    (TokenEncoder in runtime/src/lzma_core.cpp) across a thread pool.

The per-lane data leaving the device is just the compact token stream
(pos, len, dist per parse step), so the host<->device traffic is
~data-sized.
Output is bit-identical to the all-device encoder for the same tokens and
decodes everywhere (scalar/native/device/liblzma).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..format.properties import LzmaParams
from ..parallel import blocks as blk
from ..runtime import native
from .device_matcher import tokenize


@partial(jax.jit, static_argnames=("fb", "num_candidates"))
def _tokenize_lanes(data, lens, dict_size, fb, num_candidates, start=0):
    return jax.vmap(
        lambda d, n: tokenize(d, n, dict_size, fb, num_candidates, start=start)
    )(data, lens)


def encode_blocks_hybrid(
    data: bytes,
    params: LzmaParams | None = None,
    block_size: int = 1 << 18,
    num_threads: int = 0,
    fb: int | None = None,
    num_candidates: int = 4,
    preset_len: int = 0,
    dictionary: bytes = b"",
) -> bytes:
    """Device-search + host-serialize block-parallel encode to LZTB.

    `preset_len > 0` writes LZTB v2: block 0 plain, every other block's
    window primed with block 0's prefix — the device lanes search
    preset||block (parse starting at the boundary) and the native
    TokenEncoder serializes against the same preset.  `dictionary`
    writes LZTB v3: the trained dictionary is stored as its own
    compressed stream and primes EVERY lane (block 0 included).
    """
    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("block container uses known sizes; EOS not supported")
    preset_len = blk.validated_preset_len(preset_len, block_size, len(data))
    dictionary = blk.validated_dictionary(dictionary, preset_len)
    if len(data) <= block_size:
        preset_len = 0  # single block: a preset would be pointless
    blocks = blk.split_blocks(data, block_size)
    if not blocks:
        return blk.build_container(params, block_size, 0, [])
    from .device_encoder import clamp_fb

    fb = clamp_fb(fb if fb is not None else params.fast_bytes)
    n = len(blocks)
    bs = block_size
    arr = np.zeros((n, bs), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, b in enumerate(blocks):
        arr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    preset = dictionary or (data[:preset_len] if preset_len else b"")

    # device: parallel match search + parse
    if dictionary:
        dlen = len(dictionary)
        pre_np = np.frombuffer(dictionary, dtype=np.uint8)
        primed = np.concatenate(
            [np.broadcast_to(pre_np, (n, dlen)), arr], axis=1
        )
        tp, tl, td, tv, ntok = _tokenize_lanes(
            jnp.asarray(np.ascontiguousarray(primed)),
            jnp.asarray(lens + dlen),
            jnp.int32(min(params.dict_size, bs + dlen)),
            fb, num_candidates, start=dlen,
        )
        t_pos = [np.asarray(tp) - dlen]  # block-relative
        t_len, t_dist = [np.asarray(tl)], [np.asarray(td)]
        counts = np.asarray(ntok, dtype=np.int64)

        def tok_row(a, i):
            return a[0][i]
    elif preset_len:
        # block 0 (the preset source) parses plain on one lane; the other
        # lanes search preset||block with the parse starting at the boundary
        p0, l0, d0, v0, nt0 = _tokenize_lanes(
            jnp.asarray(arr[:1]), jnp.asarray(lens[:1]),
            jnp.int32(min(params.dict_size, bs)), fb, num_candidates,
        )
        pre_np = np.frombuffer(preset, dtype=np.uint8)
        primed = np.concatenate(
            [np.broadcast_to(pre_np, (n - 1, preset_len)), arr[1:]], axis=1
        )
        p1, l1, d1, v1, nt1 = _tokenize_lanes(
            jnp.asarray(np.ascontiguousarray(primed)),
            jnp.asarray(lens[1:] + preset_len),
            jnp.int32(min(params.dict_size, bs + preset_len)),
            fb, num_candidates, start=preset_len,
        )
        t_pos = [np.asarray(p0), np.asarray(p1) - preset_len]  # block-relative
        t_len = [np.asarray(l0), np.asarray(l1)]
        t_dist = [np.asarray(d0), np.asarray(d1)]
        counts = np.concatenate([
            np.asarray(nt0, dtype=np.int64), np.asarray(nt1, dtype=np.int64)
        ])

        def tok_row(a, i):
            return a[0][i] if i == 0 else a[1][i - 1]
    else:
        tp, tl, td, tv, ntok = _tokenize_lanes(
            jnp.asarray(arr), jnp.asarray(lens),
            jnp.int32(min(params.dict_size, bs)), fb, num_candidates,
        )
        t_pos, t_len, t_dist = [np.asarray(tp)], [np.asarray(tl)], [np.asarray(td)]
        counts = np.asarray(ntok, dtype=np.int64)

        def tok_row(a, i):
            return a[0][i]

    # host: flatten compacted token prefixes
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    total_tok = int(counts.sum())
    fp = np.empty(total_tok, dtype=np.int32)
    fl = np.empty(total_tok, dtype=np.int32)
    fd = np.empty(total_tok, dtype=np.int32)
    for i in range(n):
        c = int(counts[i])
        o = int(offsets[i])
        fp[o : o + c] = tok_row(t_pos, i)[:c]
        fl[o : o + c] = tok_row(t_len, i)[:c]
        fd[o : o + c] = tok_row(t_dist, i)[:c]

    payload, sizes = native.encode_token_blocks(
        arr.reshape(-1), bs, params.lc, params.lp, params.pb,
        fp, fl, fd, offsets, counts, num_threads=num_threads, preset=preset,
        preset_first=bool(dictionary),
    )
    import struct

    dict_stream = (
        native.encode_stream(dictionary, params) if dictionary else b""
    )
    head = blk.pack_header(params, bs, len(data), n, preset_len,
                           len(dictionary), len(dict_stream))
    return head + struct.pack(f"<{n}I", *sizes) + dict_stream + payload


def _list_engine(fb: int):
    """find_match_lists engine dispatch: the suffix-rank RMQ form
    produces IDENTICAL lists at ANY fb (asserted by tests; round 5
    extends the exact sort depth past 32 via prefix doubling) at a
    fraction of the compare loop's gather volume.  The compare-loop engine remains available as
    the independent oracle the identity tests check against."""
    from .device_matcher import find_match_lists_rmq

    return find_match_lists_rmq


@partial(jax.jit,
         static_argnames=("fb", "k4", "k8", "k2", "k3", "k6", "k16", "k32"))
def _match_lists_lanes(data, lens, dict_size, fb, k4, k8, k2=1, k3=1,
                       k6=0, k16=0, k32=0):
    fn = _list_engine(fb)
    return jax.vmap(
        lambda d, n: fn(d, n, dict_size, fb, k4, k8,
                        k2=k2, k3=k3, k6=k6, k16=k16, k32=k32)
    )(data, lens)


@partial(jax.jit,
         static_argnames=("fb", "cap", "k4", "k8", "k2", "k3", "k6", "k16",
                          "k32"))
def _match_lists_lanes_packed(data, lens, dict_size, fb, cap, k4, k8,
                              k2=1, k3=1, k6=0, k16=0, k32=0):
    """find_match_lists + device-side flatten: the (max_n, M) row padding
    never crosses the device->host wire (pack_match_lists)."""
    from .device_matcher import pack_match_lists

    fn = _list_engine(fb)

    def one(d, n):
        cl, cd, counts = fn(d, n, dict_size, fb, k4, k8,
                            k2=k2, k3=k3, k6=k6, k16=k16, k32=k32)
        return pack_match_lists(cl, cd, counts, cap)

    return jax.vmap(one)(data, lens)


def _match_lists_grouped(arr, lane_lens, dict_size, fb, tiers):
    """Run the candidate search in memory-bounded lane groups, with the
    per-position lists flattened ON DEVICE.

    The batch is chunked to ~2 MB of lane data per dispatch (a fixed
    bound that keeps one dispatch's search intermediates small; not yet
    sized against the card's memory); the last group
    is padded with idle lanes to keep one stable jit shape.  Returns
    numpy (fl (n, cap), fd (n, cap), counts (n, width)) — ~3 pair words
    per position on the wire instead of M (device-side flatten,
    pack_match_lists)."""
    n, width = arr.shape
    group = max(1, (2 << 20) // max(width, 1))
    cap = 3 * width
    fls, fds, cnts = [], [], []
    for i in range(0, n, group):
        g_arr = arr[i : i + group]
        g_lens = lane_lens[i : i + group]
        pad = group - g_arr.shape[0] if n > group else 0
        if pad > 0:
            g_arr = np.concatenate(
                [g_arr, np.zeros((pad, width), g_arr.dtype)], axis=0)
            g_lens = np.concatenate([g_lens, np.zeros(pad, g_lens.dtype)])
        fl, fd, counts = _match_lists_lanes_packed(
            jnp.asarray(np.ascontiguousarray(g_arr)), jnp.asarray(g_lens),
            dict_size, fb, cap, **tiers)
        m = g_arr.shape[0] - pad
        fls.append(np.asarray(fl)[:m])
        fds.append(np.asarray(fd)[:m])
        cnts.append(np.asarray(counts)[:m])
    return (np.concatenate(fls), np.concatenate(fds), np.concatenate(cnts))


def _flatten_packed(fl, fd, counts, n_pos_per_lane):
    """Packed per-lane pair buffers -> flat arrays + offset tables for
    native.encode_candidate_blocks.  `counts` rows are already zero past
    each lane's length (invalid tail positions form no hash groups), and
    the packed pair buffers were laid out from exactly these counts on
    device — no host-side re-masking may alter them or the offsets
    desync from the buffers."""
    n_lanes, cap = fl.shape
    max_n = counts.shape[1]
    c = counts.astype(np.int64)
    used = c.sum(axis=1)                                    # pairs per lane
    m = np.arange(cap, dtype=np.int64)[None, :] < used[:, None]
    flat_l = np.ascontiguousarray(fl[m])
    flat_d = np.ascontiguousarray(fd[m])
    npos = np.asarray(n_pos_per_lane, dtype=np.int64)
    G = np.zeros(n_lanes * max_n + 1, dtype=np.int64)
    np.cumsum(c.reshape(-1), out=G[1:])
    j = np.arange(max_n + 1, dtype=np.int64)[None, :]
    sel = j <= npos[:, None]
    gidx = np.arange(n_lanes, dtype=np.int64)[:, None] * max_n + j
    flat_off = G[gidx[sel]]
    pos_base = np.zeros(n_lanes, dtype=np.int64)
    np.cumsum(npos[:-1] + 1, out=pos_base[1:])
    return flat_l, flat_d, flat_off, pos_base


def _flatten_lists(cl, cd, counts, n_pos_per_lane):
    """Per-lane (max_n, M) candidate arrays -> flat pair arrays + offset
    tables for native.encode_candidate_blocks.

    Fully vectorized: one boolean gather for the
    pairs and one global cumsum for the offset tables — no per-lane
    Python loop (the old loop cost ~0.5 s per 2 MB, slower than the
    native parse it feeds)."""
    n_lanes, max_n, M = cl.shape
    if n_lanes == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.int64), np.zeros(0, np.int64))
    npos = np.asarray(n_pos_per_lane, dtype=np.int64)
    pos_valid = np.arange(max_n, dtype=np.int64)[None, :] < npos[:, None]
    c = np.where(pos_valid, counts, 0)                      # (n_lanes, max_n)
    mask = np.arange(M)[None, None, :] < c[:, :, None]      # (n_lanes, max_n, M)
    flat_l = np.ascontiguousarray(cl[mask])                 # row-major order ==
    flat_d = np.ascontiguousarray(cd[mask])                 # lane, pos, pair
    # G[k] = pairs before flat (lane, pos) index k; lane i's offset row is
    # G[i*max_n + j] for j in [0, npos_i] (counts past npos are zeroed, so
    # G at j == npos_i equals the next lane's pair base)
    G = np.zeros(n_lanes * max_n + 1, dtype=np.int64)
    np.cumsum(c.reshape(-1), out=G[1:])
    j = np.arange(max_n + 1, dtype=np.int64)[None, :]
    sel = j <= npos[:, None]                                # (n_lanes, max_n+1)
    gidx = np.arange(n_lanes, dtype=np.int64)[:, None] * max_n + j
    flat_off = G[gidx[sel]]
    pos_base = np.zeros(n_lanes, dtype=np.int64)
    np.cumsum(npos[:-1] + 1, out=pos_base[1:])
    return flat_l, flat_d, flat_off, pos_base


#: Candidate-tier depths for the hybrid-optimal pipeline: the measured
#: ratio knee on the frozen corpus (tools/cand_sweep.py; +0.38% vs
#: native bt4-opt, deeper tiers +0.31% — DESIGN-NOTES.md "Ratio knees").
DEFAULT_TIERS = dict(k4=12, k6=4, k8=6, k16=3, k32=2)


def encode_blocks_hybrid_optimal(
    data: bytes,
    params: LzmaParams | None = None,
    block_size: int = 1 << 18,
    num_threads: int = 0,
    fb: int | None = None,
    tiers: dict | None = None,
    preset_len: int = 0,
    dictionary: bytes = b"",
) -> bytes:
    """Device multi-tier candidate search + host OPTIMAL parse: the
    device builds ascending (len, dist) lists per position
    (device_matcher.find_match_lists) and the native optimal DP runs over
    them with zero finder work — skip is pure position advance.  Ratio
    approaches native bt4-opt (candidate quality sets the gap); the
    host-side cost drops to parse + serialize only.
    """
    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("block container uses known sizes; EOS not supported")
    preset_len = blk.validated_preset_len(preset_len, block_size, len(data))
    dictionary = blk.validated_dictionary(dictionary, preset_len)
    if len(data) <= block_size:
        preset_len = 0
    blocks = blk.split_blocks(data, block_size)
    if not blocks:
        return blk.build_container(params, block_size, 0, [])
    # Unlike the lazy tokenizer (static 64-byte compare window), the
    # candidate-list compare depth is a static loop bound — the full
    # reference fb range 5..273 (Encoder.java:1148-1154) is honored here,
    # on both the device compare loop and the host optimal parse.
    fb = int(fb if fb is not None else params.fast_bytes)
    tiers = dict(DEFAULT_TIERS) if tiers is None else dict(tiers)
    tiers.setdefault("k4", DEFAULT_TIERS["k4"])
    tiers.setdefault("k8", DEFAULT_TIERS["k8"])
    n = len(blocks)
    bs = block_size
    arr = np.zeros((n, bs), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, b in enumerate(blocks):
        arr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    preset = dictionary or (data[:preset_len] if preset_len else b"")
    plen = len(preset)
    preset_first = bool(dictionary)

    if plen:
        pre_np = np.frombuffer(preset, dtype=np.uint8)
        first = 0 if preset_first else 1
        primed = np.concatenate(
            [np.broadcast_to(pre_np, (n - first, plen)), arr[first:]], axis=1)
        if first:
            # v2: block 0 (the preset source) searches plain; pad its row
            # to the primed width so one device batch covers all lanes
            row0 = np.concatenate(
                [arr[:1], np.zeros((1, plen), np.uint8)], axis=1)
            primed = np.concatenate([row0, primed], axis=0)
            lane_lens = np.concatenate([lens[:1], lens[1:] + plen])
        else:
            lane_lens = lens + plen
        fl, fd, counts = _match_lists_grouped(
            primed, lane_lens,
            jnp.int32(min(params.dict_size, bs + plen)), fb, tiers)
        n_pos = lane_lens
    else:
        fl, fd, counts = _match_lists_grouped(
            arr, lens, jnp.int32(min(params.dict_size, bs)), fb, tiers)
        n_pos = lens
        first = 0

    flat_l, flat_d, flat_off, pos_base = _flatten_packed(fl, fd, counts, n_pos)

    payload, sizes = native.encode_candidate_blocks(
        arr.reshape(-1), bs, params.lc, params.lp, params.pb,
        min(params.dict_size, 1 << 29), fb, flat_l, flat_d, flat_off,
        pos_base, num_threads=num_threads, preset=preset,
        preset_first=preset_first,
        total_len=(n - 1) * bs + int(lens[-1]),
    )
    import struct

    dict_stream = (
        native.encode_stream(dictionary, params) if dictionary else b""
    )
    head = blk.pack_header(params, bs, len(data), n, preset_len,
                           len(dictionary), len(dict_stream))
    return head + struct.pack(f"<{n}I", *sizes) + dict_stream + payload


def encode_stream_hybrid_optimal(
    data: bytes,
    params: LzmaParams | None = None,
    fb: int | None = None,
    tiers: dict | None = None,
) -> bytes:
    """One raw LZMA stream via the hybrid-optimal pipeline (single lane:
    device candidate search + host optimal parse).  Decodes with any
    backend's decode_stream; used by the CLI benchmark to rate the
    hybrid backend with LzmaBench round-trip semantics."""
    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("raw hybrid streams use known sizes; EOS not supported")
    fb = int(fb if fb is not None else params.fast_bytes)
    tiers = dict(DEFAULT_TIERS) if tiers is None else dict(tiers)
    tiers.setdefault("k4", DEFAULT_TIERS["k4"])
    tiers.setdefault("k8", DEFAULT_TIERS["k8"])
    n = len(data)
    width = max(n, 16)
    arr = np.zeros((1, width), dtype=np.uint8)
    arr[0, :n] = np.frombuffer(data, dtype=np.uint8)
    lens = np.array([n], dtype=np.int32)
    fl, fd, ce = _match_lists_grouped(
        arr, lens, jnp.int32(min(params.dict_size, width)), fb, tiers)
    flat_l, flat_d, flat_off, pos_base = _flatten_packed(fl, fd, ce, lens)
    payload, sizes = native.encode_candidate_blocks(
        arr.reshape(-1)[:width], width, params.lc, params.lp, params.pb,
        min(params.dict_size, 1 << 29), fb, flat_l, flat_d, flat_off,
        pos_base, num_threads=1, total_len=n)
    return payload
