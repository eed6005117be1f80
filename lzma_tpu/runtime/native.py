"""ctypes binding to the native runtime (liblzma_tpu_native.so).

Exposes the same surface as the scalar codec — encode/decode of raw
streams, `.lzma` containers and block-parallel LZTB containers — backed by
the multithreaded C++ core.  Output is byte-identical to the scalar
oracle (asserted by tests/test_native.py).  Builds on demand; every entry
point raises NativeUnavailable if no compiler is present, so callers can
fall back to the scalar path.
"""

from __future__ import annotations

import ctypes
import os
import struct

from ..format.properties import LzmaParams, decode_props
from ..core.rangecoder import CorruptStreamError
from ..parallel import blocks as blk

_MF_INDEX = {"bt2": 0, "bt4": 1, "hc4": 2, "fast4": 3}
_MODE_INDEX = {"greedy": 0, "optimal": 1, "lazy": 2}


def _mode_flag(optimal, mode):
    if mode is not None:
        return _MODE_INDEX[mode]
    return 1 if optimal else 0


class NativeUnavailable(RuntimeError):
    pass


#: [lib, NativeUnavailable] — failures are memoized too: lru_cache only
#: caches successes, so a missing compiler would re-run the multi-second
#: build attempt on every available() probe (several per CLI run)
_LIB_STATE: list = [None, None]


def _lib():
    if _LIB_STATE[0] is not None:
        return _LIB_STATE[0]
    if _LIB_STATE[1] is not None:
        raise _LIB_STATE[1]
    from . import build

    try:
        path = build.build()
        lib = ctypes.CDLL(path)
    except Exception as e:  # no compiler / build failure
        exc = NativeUnavailable(str(e))
        exc.__cause__ = e
        _LIB_STATE[1] = exc
        raise exc
    _lib_bind(lib)
    _LIB_STATE[0] = lib
    return lib


def _lib_bind(lib):
    lib.lzt_encode.restype = ctypes.c_int64
    lib.lzt_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.lzt_encode_bound.restype = ctypes.c_int64
    lib.lzt_encode_bound.argtypes = [ctypes.c_int64]
    lib.lzt_decode.restype = ctypes.c_int
    lib.lzt_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.lzt_decode_eos.restype = ctypes.c_int64
    lib.lzt_decode_eos.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.lzt_encode_stream.restype = ctypes.c_int64
    lib.lzt_encode_stream.argtypes = [
        _READCB, ctypes.c_void_p, _WRITECB, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.lzt_decode_stream.restype = ctypes.c_int64
    lib.lzt_decode_stream.argtypes = [
        _READCB, ctypes.c_void_p, _WRITECB, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int64,
    ]
    lib.lzt_encode_blocks.restype = ctypes.c_int64
    lib.lzt_encode_blocks.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.lzt_decode_blocks.restype = ctypes.c_int
    lib.lzt_decode_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,  # void*: offset pointers, no copy
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.lzt_encode_pre.restype = ctypes.c_int64
    lib.lzt_encode_pre.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.lzt_decode_pre.restype = ctypes.c_int
    lib.lzt_decode_pre.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.lzt_decode_eos_pre.restype = ctypes.c_int64
    lib.lzt_decode_eos_pre.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.lzt_encode_blocks_pre.restype = ctypes.c_int64
    lib.lzt_encode_blocks_pre.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.lzt_decode_blocks_pre.restype = ctypes.c_int
    lib.lzt_decode_blocks_pre.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,  # void*: offset pointers, no copy
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.lzt_encode_token_blocks.restype = ctypes.c_int64
    lib.lzt_encode_token_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
    ]
    lib.lzt_encode_candidate_blocks.restype = ctypes.c_int64
    lib.lzt_encode_candidate_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
    ]
    return lib


def encode_token_blocks(
    data_padded, block_size: int, lc: int, lp: int, pb: int,
    t_pos, t_len, t_dist, tok_offsets, tok_counts, num_threads: int = 0,
    preset: bytes = b"", preset_first: bool = False,
):
    """Serialize precomputed per-block token streams (hybrid pipeline).

    data_padded: contiguous uint8 buffer, block i at [i*block_size:...].
    t_*: flat int32 arrays with BLOCK-RELATIVE positions;
    tok_offsets/tok_counts: int64 per block.  `preset` primes the window
    of every block AFTER block 0 (the LZTB v2 shared-dictionary policy —
    block 0 is the preset source and encodes plain); `preset_first`
    primes block 0 too (LZTB v3, stored trained dictionary).
    Returns (payload bytes, [sizes]).
    """
    import numpy as np

    lib = _lib()
    num_blocks = len(tok_counts)
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    n = len(data_padded)
    cap = lib.lzt_encode_bound(n) + 4096 * num_blocks
    out = ctypes.create_string_buffer(cap)
    sizes = (ctypes.c_uint32 * num_blocks)()
    t_pos = np.ascontiguousarray(t_pos, dtype=np.int32)
    t_len = np.ascontiguousarray(t_len, dtype=np.int32)
    t_dist = np.ascontiguousarray(t_dist, dtype=np.int32)
    offs = np.ascontiguousarray(tok_offsets, dtype=np.int64)
    cnts = np.ascontiguousarray(tok_counts, dtype=np.int64)
    data_padded = np.ascontiguousarray(data_padded, dtype=np.uint8)
    total = lib.lzt_encode_token_blocks(
        data_padded.ctypes.data, n, block_size, lc, lp, pb,
        t_pos.ctypes.data, t_len.ctypes.data, t_dist.ctypes.data,
        offs.ctypes.data, cnts.ctypes.data, num_blocks,
        num_threads, out, cap, sizes, preset, len(preset),
        1 if preset_first else 0,
    )
    if total < 0:
        raise ValueError(f"native token serialize failed: {total}")
    return out.raw[:total], list(sizes)


def encode_candidate_blocks(
    data_padded, block_size: int, lc: int, lp: int, pb: int,
    dict_size: int, fb: int, cand_len, cand_dist, cand_off, pos_base,
    num_threads: int = 0, preset: bytes = b"", preset_first: bool = False,
    total_len: int | None = None,
):
    """Hybrid-OPTIMAL encode: the device's per-position ascending
    (len, dist) candidate lists drive the native optimal parser
    (contract: BinTree.fillMatches semantics, BinTree.java:152-273).

    data_padded: contiguous uint8, block i at [i*block_size:...].
    cand_len/cand_dist: flat int32 pair arrays; cand_off: int64, for
    block i the table slice starts at pos_base[i] and has
    (primed_len_i + 1) entries of ABSOLUTE pair indices.
    Returns (payload bytes, [sizes])."""
    import numpy as np

    lib = _lib()
    num_blocks = len(pos_base)
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    # total_len trims the padded tail of the LAST block (blocks sit at
    # i*block_size in data_padded; intermediate blocks are full)
    n = len(data_padded) if total_len is None else int(total_len)
    cap = lib.lzt_encode_bound(len(data_padded)) + 4096 * num_blocks
    out = ctypes.create_string_buffer(cap)
    sizes = (ctypes.c_uint32 * num_blocks)()
    cl = np.ascontiguousarray(cand_len, dtype=np.int32)
    cd = np.ascontiguousarray(cand_dist, dtype=np.int32)
    co = np.ascontiguousarray(cand_off, dtype=np.int64)
    pbase = np.ascontiguousarray(pos_base, dtype=np.int64)
    data_padded = np.ascontiguousarray(data_padded, dtype=np.uint8)
    total = lib.lzt_encode_candidate_blocks(
        data_padded.ctypes.data, n, block_size, lc, lp, pb,
        dict_size, fb,
        cl.ctypes.data, cd.ctypes.data, co.ctypes.data, pbase.ctypes.data,
        num_blocks, num_threads, out, cap, sizes, preset, len(preset),
        1 if preset_first else 0,
    )
    if total < 0:
        raise ValueError(f"native candidate encode failed: {total}")
    return out.raw[:total], list(sizes)


def available() -> bool:
    try:
        _lib()
        return True
    except NativeUnavailable:
        return False


#: single-stream ceiling: the match finder indexes positions as int32
#: (like the reference's int positions, BinTree.java:19); larger inputs
#: go through the block APIs, which is also the faster path for them
MAX_STREAM = (1 << 31) - (1 << 20)


# callback signatures for the O(window) streaming codec
_READCB = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64)
_WRITECB = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64)


def _stream_cbs(read, write):
    """Wrap Python `read(cap)->bytes` / `write(bytes)` as C callbacks.

    Exceptions raised inside a callback must not unwind through C; they
    are stashed and re-raised after the native call returns.
    """
    errors: list[BaseException] = []

    def _read(_ctx, buf, cap):
        try:
            b = read(int(cap))
            if not b:
                return 0
            if len(b) > cap:
                b = b[:cap]
            ctypes.memmove(buf, b, len(b))
            return len(b)
        except BaseException as e:  # noqa: BLE001 - re-raised by caller
            errors.append(e)
            return -1

    def _write(_ctx, buf, ln):
        try:
            write(ctypes.string_at(buf, int(ln)))
            return int(ln)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
            return -1

    return _READCB(_read), _WRITECB(_write), errors


def encode_stream_io(read, write, params: LzmaParams, optimal: bool = True,
                     mode: str | None = None) -> int:
    """Stream-encode `read(cap)->bytes` (b'' = EOF) into `write(bytes)`.

    O(dict) resident memory, unbounded input length (the native finder
    rebases its window positions every 2^30 bytes) — the reference's
    primary InputStream->OutputStream operating mode (InWindow.java:24-63).
    Output is byte-identical to encode_stream on the same bytes.  Returns
    the number of compressed bytes written.
    """
    params = params.validated_for_encode()
    lib = _lib()
    rcb, wcb, errors = _stream_cbs(read, write)
    n = lib.lzt_encode_stream(
        rcb, None, wcb, None, params.lc, params.lp, params.pb,
        params.dict_size, params.fast_bytes, _MF_INDEX[params.match_finder],
        1 if params.write_eos else 0, _mode_flag(optimal, mode),
    )
    if errors:
        raise errors[0]
    if n < 0:
        raise ValueError(f"native stream encode failed: {n}")
    return int(n)


def decode_stream_io(read, write, params: LzmaParams, out_size: int) -> int:
    """Stream-decode `read(cap)->bytes` into `write(bytes)` in
    max(dict,4K)+chunk memory (the reference's circular OutWindow,
    OutWindow.java:41-67).  out_size < 0 decodes until the EOS marker.
    Returns the number of decoded bytes."""
    lib = _lib()
    rcb, wcb, errors = _stream_cbs(read, write)
    n = lib.lzt_decode_stream(
        rcb, None, wcb, None, params.lc, params.lp, params.pb,
        params.dict_size, out_size,
    )
    if errors:
        raise errors[0]
    if n < 0:
        raise CorruptStreamError(f"native stream decode failed: {n}")
    return int(n)


def encode_stream(data: bytes, params: LzmaParams, optimal: bool = True,
                  mode: str | None = None, preset: bytes = b"") -> bytes:
    if len(data) + len(preset) > MAX_STREAM:
        raise ValueError(
            "single LZMA stream too large for int32 window positions; "
            "use encode_blocks/compress_file"
        )
    params = params.validated_for_encode()
    lib = _lib()
    cap = lib.lzt_encode_bound(len(data))
    out = ctypes.create_string_buffer(cap)
    if preset:
        buf = preset + data
        n = lib.lzt_encode_pre(
            buf, len(buf), len(preset), params.lc, params.lp, params.pb,
            params.dict_size, params.fast_bytes, _MF_INDEX[params.match_finder],
            1 if params.write_eos else 0, _mode_flag(optimal, mode), out, cap,
        )
    else:
        n = lib.lzt_encode(
            data, len(data), params.lc, params.lp, params.pb, params.dict_size,
            params.fast_bytes, _MF_INDEX[params.match_finder],
            1 if params.write_eos else 0, _mode_flag(optimal, mode), out, cap,
        )
    if n < 0:
        raise ValueError(f"native encode failed: {n}")
    return out.raw[:n]


def decode_stream(comp: bytes, params: LzmaParams, out_size: int,
                  preset: bytes = b"") -> bytes:
    if out_size < 0:
        return decode_stream_eos(comp, params, preset=preset)
    lib = _lib()
    out = ctypes.create_string_buffer(max(out_size, 1))
    if preset:
        rc = lib.lzt_decode_pre(
            comp, len(comp), params.lc, params.lp, params.pb, params.dict_size,
            preset, len(preset), out, out_size,
        )
    else:
        rc = lib.lzt_decode(
            comp, len(comp), params.lc, params.lp, params.pb, params.dict_size,
            out, out_size,
        )
    if rc != 0:
        raise CorruptStreamError(f"native decode failed: {rc}")
    return ctypes.string_at(out, out_size)


def decode_stream_eos(comp: bytes, params: LzmaParams,
                      size_limit: int = 1 << 33, preset: bytes = b"") -> bytes:
    """Decode an EOS-terminated stream, growing the buffer as needed.

    size_limit (~8 GB default) bounds both the allocation and the decode
    work against corrupt never-ending streams; it is enforced BEFORE each
    allocation so a huge input cannot trigger an outsized first buffer.
    """
    lib = _lib()
    cap = min(max(16 * len(comp), 1 << 16), size_limit)
    while True:
        out = ctypes.create_string_buffer(cap)
        if preset:
            n = lib.lzt_decode_eos_pre(
                comp, len(comp), params.lc, params.lp, params.pb,
                params.dict_size, preset, len(preset), out, cap,
            )
        else:
            n = lib.lzt_decode_eos(
                comp, len(comp), params.lc, params.lp, params.pb,
                params.dict_size, out, cap,
            )
        if n >= 0:
            return ctypes.string_at(out, int(n))
        if n != -6:
            raise CorruptStreamError(f"native decode failed: {n}")
        if cap >= size_limit:
            raise CorruptStreamError("EOS stream exceeds decode size limit")
        cap = min(cap * 4, size_limit)


def encode_alone(data: bytes, params: LzmaParams, optimal: bool = True,
                 mode: str | None = None) -> bytes:
    size = (-1 if params.write_eos else len(data)) & 0xFFFFFFFFFFFFFFFF
    return (
        params.encode_props()
        + size.to_bytes(8, "little")
        + encode_stream(data, params, optimal=optimal, mode=mode)
    )


def decode_alone(data: bytes) -> bytes:
    if len(data) < 13:
        raise CorruptStreamError(".lzma input too short")
    params = decode_props(data[:5])
    out_size = int.from_bytes(data[5:13], "little")
    if out_size == 0xFFFFFFFFFFFFFFFF:  # EOS-terminated (unknown size)
        # the ring streaming decoder sizes memory to the real output as it
        # goes — no oversized zero-filled guess buffer, no grow-and-retry
        # (liblzma's FORMAT_ALONE output always uses this unknown-size mode)
        import io as _io

        limit = 1 << 33
        sink = _io.BytesIO()

        def _write(b: bytes) -> None:
            if sink.tell() + len(b) > limit:
                raise CorruptStreamError("EOS stream exceeds decode size limit")
            sink.write(b)

        src = memoryview(data)[13:]
        pos = [0]

        def _read(cap: int) -> bytes:
            chunk = bytes(src[pos[0] : pos[0] + cap])
            pos[0] += len(chunk)
            return chunk

        decode_stream_io(_read, _write, params, -1)
        return sink.getvalue()
    # a forged size field must not drive the upfront output allocation
    # (same guard as filestream.decode_file_alone / blocks.parse_container)
    from ..format.properties import validate_alone_size

    validate_alone_size(out_size, len(data) - 13)
    return decode_stream(data[13:], params, out_size)


def encode_block_payload(
    data: bytes,
    params: LzmaParams,
    block_size: int,
    num_threads: int = 0,
    optimal: bool = True,
    mode: str | None = None,
):
    """Encode `data` as independent block streams (no container framing).

    Returns `(payload, sizes)` — the concatenated raw LZMA streams and the
    per-block compressed sizes.  The building block for both the in-memory
    LZTB container and the constant-memory file streamer
    (parallel/filestream.py), which feeds batches of blocks through here.
    """
    if block_size < 1:
        raise ValueError("block_size must be positive")
    params = params.validated_for_encode()
    lib = _lib()
    num_blocks = (len(data) + block_size - 1) // block_size
    if num_blocks == 0:
        return b"", []
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    cap = lib.lzt_encode_bound(len(data)) + 4096 * num_blocks
    out = ctypes.create_string_buffer(cap)
    sizes = (ctypes.c_uint32 * num_blocks)()
    n = lib.lzt_encode_blocks(
        data, len(data), params.lc, params.lp, params.pb, params.dict_size,
        params.fast_bytes, _MF_INDEX[params.match_finder], _mode_flag(optimal, mode),
        block_size, num_threads, out, cap, sizes,
    )
    if n < 0:
        raise ValueError(f"native block encode failed: {n}")
    return out.raw[:n], list(sizes)


def _payload_ptr(payload, off: int = 0):
    """(arg, length) for passing payload[off:] to a native call WITHOUT
    copying.  bytes: ctypes borrows the buffer (pointer arithmetic for
    the offset); bytearray: a from_buffer char array; anything else
    (e.g. a memoryview) falls back to one bytes() copy.  The caller must
    keep `payload` referenced until the native call returns."""
    if isinstance(payload, bytes):
        if not off:
            return payload, len(payload)
        base = ctypes.cast(ctypes.c_char_p(payload), ctypes.c_void_p).value
        return ctypes.c_void_p(base + off), len(payload) - off
    if isinstance(payload, bytearray):
        n = len(payload) - off
        return (ctypes.c_char * n).from_buffer(payload, off), n
    payload = bytes(payload)
    return _payload_ptr(payload, off)


def decode_block_payload(
    payload,
    params: LzmaParams,
    block_size: int,
    total_size: int,
    comp_sizes,
    num_threads: int = 0,
    payload_off: int = 0,
) -> bytes:
    """Decode concatenated block streams (no container framing).

    `total_size` sizes the final block: every block decodes to
    `block_size` bytes except the last, which gets the remainder.
    `payload_off` decodes from payload[payload_off:] without slicing
    (no copy — the payload is nearly the whole container).
    """
    n = len(comp_sizes)
    if n == 0:
        return b""
    lib = _lib()
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    ptr, plen = _payload_ptr(payload, payload_off)
    sizes = (ctypes.c_uint32 * n)(*comp_sizes)
    out = ctypes.create_string_buffer(max(total_size, 1))
    rc = lib.lzt_decode_blocks(
        ptr, plen, params.lc, params.lp, params.pb,
        params.dict_size, block_size, total_size, sizes, n, num_threads, out,
    )
    if rc != 0:
        raise CorruptStreamError(f"native block decode failed: {rc}")
    return out.raw[:total_size]


def encode_block_payload_pre(
    data: bytes,
    preset: bytes,
    params: LzmaParams,
    block_size: int,
    num_threads: int = 0,
    optimal: bool = True,
    mode: str | None = None,
):
    """Encode blocks that ALL share one preset dictionary (no framing).

    Returns `(payload, sizes)`.  Pass `preset=b""` for plain blocks.
    """
    if not preset:
        return encode_block_payload(
            data, params, block_size, num_threads, optimal=optimal, mode=mode
        )
    if block_size < 1:
        raise ValueError("block_size must be positive")
    params = params.validated_for_encode()
    lib = _lib()
    num_blocks = (len(data) + block_size - 1) // block_size
    if num_blocks == 0:
        return b"", []
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    cap = lib.lzt_encode_bound(len(data)) + 4096 * num_blocks
    out = ctypes.create_string_buffer(cap)
    sizes = (ctypes.c_uint32 * num_blocks)()
    n = lib.lzt_encode_blocks_pre(
        data, len(data), preset, len(preset),
        params.lc, params.lp, params.pb, params.dict_size,
        params.fast_bytes, _MF_INDEX[params.match_finder], _mode_flag(optimal, mode),
        block_size, num_threads, out, cap, sizes,
    )
    if n < 0:
        raise ValueError(f"native block encode failed: {n}")
    return out.raw[:n], list(sizes)


def decode_block_payload_pre(
    payload,
    preset: bytes,
    params: LzmaParams,
    block_size: int,
    total_size: int,
    comp_sizes,
    num_threads: int = 0,
    out_buffer=None,
    out_offset: int = 0,
    payload_off: int = 0,
) -> bytes:
    """Decode blocks that all share one preset dictionary (no framing).

    `out_buffer`/`out_offset` let callers decode into a larger buffer
    in place (used by the v2 container path to stitch block 0 + rest);
    `payload_off` decodes from payload[payload_off:] without a copy.
    """
    n = len(comp_sizes)
    own = out_buffer is None
    if own:
        out_buffer = ctypes.create_string_buffer(max(total_size, 1))
        out_offset = 0
    if n == 0:
        return b"" if own else None
    lib = _lib()
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    ptr, plen = _payload_ptr(payload, payload_off)
    sizes = (ctypes.c_uint32 * n)(*comp_sizes)
    dst = ctypes.addressof(out_buffer) + out_offset
    if preset:
        rc = lib.lzt_decode_blocks_pre(
            ptr, plen, preset, len(preset),
            params.lc, params.lp, params.pb, params.dict_size,
            block_size, total_size, sizes, n, num_threads, dst,
        )
    else:
        rc = lib.lzt_decode_blocks(
            ptr, plen, params.lc, params.lp, params.pb,
            params.dict_size, block_size, total_size, sizes, n, num_threads, dst,
        )
    if rc != 0:
        raise CorruptStreamError(f"native block decode failed: {rc}")
    return out_buffer.raw[:total_size] if own else None


def encode_blocks(
    data: bytes,
    params: LzmaParams | None = None,
    block_size: int = blk.DEFAULT_BLOCK_SIZE,
    num_threads: int = 0,
    optimal: bool = True,
    mode: str | None = None,
    preset_len: int = 0,
    dictionary: bytes = b"",
) -> bytes:
    """Multithreaded block-parallel encode to an LZTB container.

    `preset_len > 0` writes LZTB v2: the first preset_len bytes of the
    data (a prefix of block 0) prime every other block's window.
    `dictionary` writes LZTB v3: the trained dictionary is stored as its
    own compressed stream and primes EVERY block (utils/dicttrain.py).
    """
    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("block container uses known sizes; EOS not supported")
    preset_len = blk.validated_preset_len(preset_len, block_size, len(data))
    dictionary = blk.validated_dictionary(dictionary, preset_len)
    if dictionary and data:
        payload, sizes = encode_block_payload_pre(
            data, dictionary, params, block_size, num_threads,
            optimal=optimal, mode=mode,
        )
        dict_stream = encode_stream(dictionary, params)
        head = blk.pack_header(params, block_size, len(data), len(sizes),
                               0, len(dictionary), len(dict_stream))
        return (head + struct.pack(f"<{len(sizes)}I", *sizes)
                + dict_stream + payload)
    if preset_len and len(data) > block_size:
        b0, rest = data[:block_size], data[block_size:]
        preset = data[:preset_len]
        p0, s0 = encode_block_payload(
            b0, params, block_size, num_threads, optimal=optimal, mode=mode
        )
        p1, s1 = encode_block_payload_pre(
            rest, preset, params, block_size, num_threads, optimal=optimal, mode=mode
        )
        payload, sizes = p0 + p1, s0 + s1
    else:
        preset_len = 0  # single block: a preset would be pointless
        payload, sizes = encode_block_payload(
            data, params, block_size, num_threads, optimal=optimal, mode=mode
        )
    if not sizes:
        return blk.build_container(params, block_size, 0, [])
    head = blk.pack_header(params, block_size, len(data), len(sizes), preset_len)
    return head + struct.pack(f"<{len(sizes)}I", *sizes) + payload


def decode_blocks(blob: bytes, num_threads: int = 0) -> bytes:
    """Multithreaded block-parallel decode of an LZTB container.

    LZTB v2 (shared preset): block 0 decodes first, then every other
    block decodes in parallel against the shared preset window.  LZTB v3
    (stored dictionary): the dict stream decodes first, then ALL blocks
    in parallel against it.
    """
    frame = blk.parse_container(blob)
    if not frame.comp_sizes:
        return b""
    if frame.dict_len:
        dictionary = decode_stream(
            bytes(blob[frame.payload_offset : frame.blocks_offset]),
            frame.params, frame.dict_len,
        )
        return decode_block_payload_pre(
            blob, dictionary, frame.params,
            frame.block_size, frame.total_size, frame.comp_sizes, num_threads,
            payload_off=frame.blocks_offset,
        )
    # zero-copy: the payload (nearly the whole blob) is passed as the
    # original buffer + an offset — no slice materialization
    if not frame.preset_len:
        return decode_block_payload(
            blob, frame.params, frame.block_size,
            frame.total_size, frame.comp_sizes, num_threads,
            payload_off=frame.payload_offset,
        )
    out = ctypes.create_string_buffer(max(frame.total_size, 1))
    b0_size = min(frame.block_size, frame.total_size)
    decode_block_payload_pre(
        blob, b"", frame.params, frame.block_size,
        b0_size, frame.comp_sizes[:1], num_threads,
        out_buffer=out, out_offset=0, payload_off=frame.payload_offset,
    )
    preset = out[: frame.preset_len]  # slices only the preset bytes
    decode_block_payload_pre(
        blob, preset, frame.params, frame.block_size,
        frame.total_size - b0_size, frame.comp_sizes[1:], num_threads,
        out_buffer=out, out_offset=b0_size,
        payload_off=frame.payload_offset + frame.comp_sizes[0],
    )
    return out.raw[: frame.total_size]
