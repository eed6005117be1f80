"""Block-parallel multi-stream container — the scaling unit of the framework.

One LZMA stream is inherently bit-serial (the reference's decode loop is a
strict chain, Decoder.java:219-296), so throughput scaling comes from
chunking input into independent streams ("blocks"), encoding/decoding them
data-parallel — across host threads (runtime/), device lanes (ops/) and mesh
devices (parallel/mesh.py) — and concatenating results in order.  This is
the LZMA analogue of data parallelism called for by SURVEY.md §5.7/§5.8.

Container layout (all little-endian):

    magic  b"LZTB"                      4
    version u8 = 1 | 2 | 3              1
    props   5 bytes (lc/lp/pb + dict)   5   -- shared by every block
    block_size u32                      4   -- uncompressed bytes per block
    total_size u64                      8   -- original length
    num_blocks u32                      4
    preset_len u32                      4   -- version 2 only
    comp_sizes u32[num_blocks]          4*n -- ragged-gather size table
    payload: concatenated raw LZMA streams (no per-block headers)

Each block is a fresh LZMA stream with its own dictionary window, known
uncompressed size (block_size, except possibly the last), no EOS marker.

Version 2 adds a SHARED preset dictionary: the first `preset_len` bytes
of the original data (a prefix of block 0) prime the window of every
block i >= 1.  Block 0 itself is coded plain, so decode order is:
block 0 first, then all other blocks in parallel — full decode
parallelism is preserved while independent blocks recover most of the
ratio lost to chunking.  This is the "broadcast preset dictionary" of
the scaling design (SURVEY.md §5.8): on a mesh the preset is exactly
the buffer broadcast to every device.

Version 3 stores a TRAINED dictionary (utils/dicttrain.py) as its own
compressed stream between the size table and the block payload:

    dict_len  u32   uncompressed dictionary length (>= 1)
    dict_comp u32   compressed dictionary stream size

replace the v2 preset_len field.  EVERY block (including block 0) is
coded against the dictionary, so decode is fully parallel — the tiny
dict stream decodes first, then all blocks at once.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from ..codec.decoder import decode_stream
from ..codec.encoder import encode_stream
from ..core.rangecoder import CorruptStreamError
from ..format.properties import MAX_EXPANSION as _MAX_EXPANSION
from ..format.properties import LzmaParams, decode_props

MAGIC = b"LZTB"
VERSION = 1
VERSION_PRESET = 2
VERSION_TRAINED = 3
_HEAD = struct.Struct("<4sB5sIQI")
_PRESET_FIELD = struct.Struct("<I")
_DICT_FIELD = struct.Struct("<II")
DEFAULT_BLOCK_SIZE = 1 << 20
#: hard ceiling on stored-dictionary length (int32 window positions)
MAX_DICT_LEN = 1 << 27


@dataclass(frozen=True)
class BlockFrame:
    """Parsed container header + payload offsets."""

    params: LzmaParams
    block_size: int
    total_size: int
    comp_sizes: tuple
    payload_offset: int  # v3: the stored dict stream starts here
    preset_len: int = 0
    dict_len: int = 0  # v3 only: uncompressed stored-dictionary length
    dict_comp: int = 0  # v3 only: compressed dict stream size

    @property
    def blocks_offset(self) -> int:
        """Offset of the first block stream (skips the v3 dict stream)."""
        return self.payload_offset + self.dict_comp

    def stream_extents(self, blob_len: int):
        """(offsets, out_sizes) for the block streams: block i's
        compressed bytes live at [offsets[i], offsets[i+1]) and decode
        to out_sizes[i] bytes.  The ONE implementation of the framing
        arithmetic (scalar, device and mesh decoders all call this).
        Raises CorruptStreamError when the payload is truncated."""
        offsets = [self.blocks_offset]
        for s in self.comp_sizes:
            offsets.append(offsets[-1] + s)
        if offsets[-1] > blob_len:
            raise CorruptStreamError("container payload truncated")
        n = len(self.comp_sizes)
        sizes = [self.block_size] * n
        if n:
            sizes[-1] = self.total_size - self.block_size * (n - 1)
        return offsets, sizes


def split_blocks(data: bytes, block_size: int):
    return [data[i : i + block_size] for i in range(0, len(data), block_size)]


def validated_preset_len(preset_len: int, block_size: int, total_size: int) -> int:
    """Clamp-and-check a requested shared-preset length: it must be a
    prefix of block 0, so at most min(block_size, total_size)."""
    if preset_len < 0:
        raise ValueError("preset_len must be >= 0")
    return min(preset_len, block_size, total_size)


def validated_dictionary(dictionary, preset_len: int = 0) -> bytes:
    """Check a stored-dictionary request (LZTB v3) against the format's
    bounds and its exclusivity with the v2 prefix preset."""
    dictionary = bytes(dictionary or b"")
    if dictionary and preset_len:
        raise ValueError("preset_len and a stored dictionary are exclusive")
    if len(dictionary) > MAX_DICT_LEN:
        raise ValueError(f"dictionary exceeds {MAX_DICT_LEN} bytes")
    return dictionary


def decode_stored_dict(blob, frame: "BlockFrame") -> bytes:
    """Decode a v3 container's stored dictionary stream (scalar path)."""
    return decode_stream(
        blob, frame.params, out_size=frame.dict_len,
        start=frame.payload_offset,
        end=frame.payload_offset + frame.dict_comp,
    )


def pack_header(params: LzmaParams, block_size: int, total_size: int,
                num_blocks: int, preset_len: int = 0,
                dict_len: int = 0, dict_comp: int = 0) -> bytes:
    """Fixed container header (everything before the size table) — the ONE
    place the header layout is written; build_container, the native
    runtime, and the file streamer all call this.  `dict_len`/`dict_comp`
    nonzero writes version 3 (stored trained dictionary); mutually
    exclusive with `preset_len` (version 2)."""
    if dict_len and preset_len:
        raise ValueError("preset_len and a stored dictionary are exclusive")
    version = (VERSION_TRAINED if dict_len
               else VERSION_PRESET if preset_len else VERSION)
    head = _HEAD.pack(
        MAGIC, version, params.encode_props(), block_size, total_size, num_blocks
    )
    if dict_len:
        head += _DICT_FIELD.pack(dict_len, dict_comp)
    elif preset_len:
        head += _PRESET_FIELD.pack(preset_len)
    return head


def build_container(params: LzmaParams, block_size: int, total_size: int,
                    streams, preset_len: int = 0,
                    dict_stream: bytes = b"", dict_len: int = 0) -> bytes:
    head = pack_header(params, block_size, total_size, len(streams),
                       preset_len, dict_len, len(dict_stream))
    sizes = struct.pack(f"<{len(streams)}I", *(len(s) for s in streams))
    return head + sizes + dict_stream + b"".join(streams)


def read_header(fileobj):
    """Stream-parse the fixed header from a file object — the reading twin
    of pack_header.  Returns (params, block_size, total_size, num_blocks,
    preset_len, dict_len, dict_comp, header_size).  Raises
    CorruptStreamError like parse_container."""
    head = fileobj.read(_HEAD.size)
    if len(head) < _HEAD.size or head[:4] != MAGIC:
        raise CorruptStreamError("not an LZTB container")
    magic, version, props, block_size, total_size, n = _HEAD.unpack(head)
    preset_len = dict_len = dict_comp = 0
    header_size = _HEAD.size
    if version == VERSION_PRESET:
        field = fileobj.read(_PRESET_FIELD.size)
        if len(field) < _PRESET_FIELD.size:
            raise CorruptStreamError("LZTB v2 header truncated")
        (preset_len,) = _PRESET_FIELD.unpack(field)
        header_size += _PRESET_FIELD.size
        if preset_len > min(block_size, max(total_size, 1)):
            raise CorruptStreamError("preset_len exceeds block 0")
    elif version == VERSION_TRAINED:
        field = fileobj.read(_DICT_FIELD.size)
        if len(field) < _DICT_FIELD.size:
            raise CorruptStreamError("LZTB v3 header truncated")
        dict_len, dict_comp = _DICT_FIELD.unpack(field)
        header_size += _DICT_FIELD.size
        if not (1 <= dict_len <= MAX_DICT_LEN) or dict_comp < 1:
            raise CorruptStreamError("LZTB v3 dictionary geometry invalid")
        # anti-DoS: dict_len drives an allocation before any decode, so a
        # forged length must be impossible for the claimed stream size
        if dict_len > dict_comp * MAX_EXPANSION + (1 << 16):
            raise CorruptStreamError(
                "claimed dict_len is impossible for this dict stream"
            )
    elif version != VERSION:
        raise CorruptStreamError(f"unsupported LZTB version {version}")
    # geometry sanity: decoders write block i at i*block_size into a
    # total_size buffer, so forged counts must die here, not there
    if block_size < 1:
        raise CorruptStreamError("block_size must be positive")
    if n != (total_size + block_size - 1) // block_size and not (
        total_size == 0 and n == 0
    ):
        raise CorruptStreamError("block count inconsistent with total_size")
    return (decode_props(props), block_size, total_size, n, preset_len,
            dict_len, dict_comp, header_size)


#: Bound used to reject forged total_size headers BEFORE allocating —
#: shared with the `.lzma` guard (see the derivation at
#: format.properties.MAX_EXPANSION; the true worst case is ~6800x, and
#: this codec measures ~4690x on all-zero input, so the old 4096 bound
#: rejected the encoder's own output).
MAX_EXPANSION = _MAX_EXPANSION


def parse_container(blob) -> BlockFrame:
    import io

    head = io.BytesIO(bytes(blob[: _HEAD.size + _DICT_FIELD.size]))
    (params, block_size, total_size, n, preset_len,
     dict_len, dict_comp, off) = read_header(head)
    if len(blob) < off + 4 * n:
        raise CorruptStreamError("container size table truncated")
    if total_size > (len(blob) - off) * MAX_EXPANSION + (1 << 16):
        raise CorruptStreamError(
            "claimed total_size is impossible for this payload"
        )
    if dict_comp > len(blob) - off - 4 * n:
        raise CorruptStreamError("container dict stream truncated")
    sizes = struct.unpack_from(f"<{n}I", blob, off)
    return BlockFrame(
        params=params,
        block_size=block_size,
        total_size=total_size,
        comp_sizes=sizes,
        payload_offset=off + 4 * n,
        preset_len=preset_len,
        dict_len=dict_len,
        dict_comp=dict_comp,
    )


def encode_blocks(
    data: bytes,
    params: LzmaParams | None = None,
    block_size: int = DEFAULT_BLOCK_SIZE,
    num_threads: int = 1,
    optimal: bool = True,
    encode_fn=None,
    preset_len: int = 0,
    dictionary: bytes = b"",
) -> bytes:
    """Chunk + encode data-parallel + ordered concat.

    `encode_fn(block_bytes) -> stream_bytes` lets callers swap the backend
    (native C++ / device lanes) while reusing the framing.  `preset_len`
    shares the first bytes of block 0 as a preset dictionary for every
    other block (LZTB v2); `dictionary` stores a trained dictionary
    (utils/dicttrain.py) as its own compressed stream and primes EVERY
    block with it (LZTB v3).  Only the default scalar backend supports
    either.
    """
    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("block container uses known sizes; EOS not supported")
    preset_len = validated_preset_len(preset_len, block_size, len(data))
    dictionary = validated_dictionary(dictionary, preset_len)
    if len(data) <= block_size:
        preset_len = 0  # single block: a prefix preset would be pointless
    if not data:
        dictionary = b""
    if (preset_len or dictionary) and encode_fn is not None:
        raise ValueError("preset dictionaries require the default scalar backend")
    blocks = split_blocks(data, block_size)
    preset = dictionary or (data[:preset_len] if preset_len else b"")
    fn = encode_fn or (
        lambda b, pre=b"": encode_stream(b, params, optimal=optimal, preset=pre)
    )

    def job(ib):
        i, b = ib
        if dictionary:
            return fn(b, preset)
        return fn(b, preset if i else b"") if preset_len else fn(b)

    if num_threads > 1 and len(blocks) > 1:
        with ThreadPoolExecutor(num_threads) as ex:
            streams = list(ex.map(job, enumerate(blocks)))
    else:
        streams = [job(ib) for ib in enumerate(blocks)]
    dict_stream = (
        encode_stream(dictionary, params, optimal=True) if dictionary else b""
    )
    return build_container(params, block_size, len(data), streams, preset_len,
                           dict_stream, len(dictionary))


def decode_blocks(blob, num_threads: int = 1, decode_fn=None) -> bytes:
    """Parse + decode data-parallel + ordered concat.

    LZTB v2 (shared preset): block 0 decodes first, yielding the preset
    for every other block, which then decode in parallel.  LZTB v3
    (stored dictionary): the dict stream decodes first, then ALL blocks
    in parallel.
    """
    frame = parse_container(blob)
    n = len(frame.comp_sizes)
    offsets, sizes = frame.stream_extents(len(blob))

    def out_size(i: int) -> int:
        return sizes[i]

    if (frame.preset_len or frame.dict_len) and decode_fn is not None:
        raise ValueError("preset containers require the default scalar backend")

    preset = decode_stored_dict(blob, frame) if frame.dict_len else b""

    def default_fn(i: int) -> bytes:
        return decode_stream(
            blob, frame.params, out_size=out_size(i),
            start=offsets[i], end=offsets[i + 1],
            preset=preset if (i or frame.dict_len) else b"",
        )

    fn = decode_fn or default_fn
    first = 0
    parts = []
    if frame.preset_len and n > 0:
        parts.append(fn(0))  # the preset source must exist first
        preset = parts[0][: frame.preset_len]
        first = 1
    if num_threads > 1 and n - first > 1:
        with ThreadPoolExecutor(num_threads) as ex:
            parts.extend(ex.map(fn, range(first, n)))
    else:
        parts.extend(fn(i) for i in range(first, n))
    out = b"".join(parts)
    if len(out) != frame.total_size:
        raise CorruptStreamError("decoded size mismatch")
    return out
