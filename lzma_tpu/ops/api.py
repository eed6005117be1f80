"""Device-backend codec surface matching the scalar/native backends.

Single-stream helpers route through the lane-parallel device kernels with
one lane; the block APIs batch blocks across lanes (the intended use —
device throughput comes from lane parallelism, see parallel/mesh.py for
the multi-chip version).
"""

from __future__ import annotations

from ..core.rangecoder import CorruptStreamError
from ..format.properties import LzmaParams, decode_props
from ..parallel import blocks as blk
from .device_decoder import decode_batch
from .device_encoder import encode_batch


def encode_stream(data: bytes, params: LzmaParams) -> bytes:
    (s,) = encode_batch([data], params, write_eos=params.write_eos)
    return s


def decode_stream(comp: bytes, params: LzmaParams, out_size: int) -> bytes:
    (d,) = decode_batch([comp], params, [out_size])
    return d


def encode_alone(data: bytes, params: LzmaParams) -> bytes:
    # EOS-marker streams (unknown-size header, Encoder.java:1182-1184):
    # the lane lowering appends the end-marker token (device_encoder
    # EOS_DIST)
    size = (0xFFFFFFFFFFFFFFFF if params.write_eos else len(data))
    return (
        params.encode_props()
        + size.to_bytes(8, "little")
        + encode_stream(data, params)
    )


def decode_alone(data: bytes) -> bytes:
    if len(data) < 13:
        raise CorruptStreamError(".lzma input too short")
    params = decode_props(data[:5])
    out_size = int.from_bytes(data[5:13], "little")
    if out_size == 0xFFFFFFFFFFFFFFFF:
        # EOS-terminated (unknown size): the lane FSM detects the end
        # marker (dist == -1, Decoder.java:277-283) under an expansion
        # cap that GROWS on overflow: the first attempt sizes for a
        # typical expansion; a lane that reaches the cap without the
        # marker raises CapExceededError and retries 4x bigger (each cap
        # is a pow2 jit bucket) up to the LZMA expansion bound or the
        # device ceiling — only streams whose output cannot fit the
        # ceiling reach the native/scalar streaming decoders.
        import os

        from .device_decoder import CapExceededError

        comp_len = len(data) - 13
        ceiling = min(273 * comp_len + 512,
                      int(os.environ.get("LZMA_TPU_DEVICE_EOS_CEILING",
                                         1 << 25)))
        cap = min(max(16 * comp_len, 1 << 16), ceiling)
        while True:
            try:
                (d,) = decode_batch([data[13:]], params, [-cap])
                return d
            except CapExceededError:
                if cap >= ceiling:
                    break  # valid output cannot fit the ceiling: corrupt
                           # or oversized — the streaming decoders decide
                cap = min(cap * 4, ceiling)
        from ..runtime import native

        if native.available():
            return native.decode_alone(data)
        from ..codec.decoder import decode_stream as py_decode

        return py_decode(data, params, out_size=-1, start=13)
    # a forged size field must not size the device output buffers
    from ..format.properties import validate_alone_size

    validate_alone_size(out_size, len(data) - 13)
    return decode_stream(data[13:], params, out_size)


def encode_blocks(
    data: bytes,
    params: LzmaParams | None = None,
    block_size: int = 1 << 18,
    preset_len: int = 0,
    dictionary: bytes = b"",
    parse: str = "lazy",
) -> bytes:
    """Lane-parallel block encode to an LZTB container.

    `preset_len > 0` writes LZTB v2: block 0 plain, every other lane's
    window primed with block 0's prefix.  `dictionary` writes LZTB v3:
    the trained dictionary is stored as its own compressed stream and
    primes EVERY lane.
    parse="optimal" tokenizes with the lane-parallel optimal-parse DP
    (ops/device_parser); preset-primed lanes keep the lazy parse.
    """
    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("block container uses known sizes; EOS not supported")
    preset_len = blk.validated_preset_len(preset_len, block_size, len(data))
    dictionary = blk.validated_dictionary(dictionary, preset_len)
    if len(data) <= block_size:
        preset_len = 0  # single block: a preset would be pointless
    if not data:
        dictionary = b""
    blocks = blk.split_blocks(data, block_size)
    dict_stream = b""
    if dictionary:
        streams = encode_batch(blocks, params, preset=dictionary)
        (dict_stream,) = encode_batch([dictionary], params, parse=parse)
    elif preset_len:
        streams = encode_batch(blocks[:1], params, parse=parse)
        streams += encode_batch(blocks[1:], params, preset=data[:preset_len])
    else:
        streams = (encode_batch(blocks, params, parse=parse)
                   if blocks else [])
    return blk.build_container(params, block_size, len(data), streams,
                               preset_len, dict_stream, len(dictionary))


def decode_blocks(blob) -> bytes:
    """Lane-parallel block decode of an LZTB container."""
    frame = blk.parse_container(blob)
    n = len(frame.comp_sizes)
    if n == 0:
        return b""
    offsets, sizes = frame.stream_extents(len(blob))
    streams = [bytes(blob[offsets[i] : offsets[i + 1]]) for i in range(n)]
    if frame.dict_len:
        # LZTB v3: decode the (tiny) stored dictionary on one lane, then
        # ALL blocks in parallel against it
        (dictionary,) = decode_batch(
            [bytes(blob[frame.payload_offset : frame.blocks_offset])],
            frame.params, [frame.dict_len],
        )
        parts = decode_batch(streams, frame.params, sizes, preset=dictionary)
    elif frame.preset_len:
        # LZTB v2: block 0 decodes plain and IS the preset source; the
        # remaining lanes then decode in parallel against its prefix.
        head = decode_batch(streams[:1], frame.params, sizes[:1])
        preset = head[0][: frame.preset_len]
        rest = (
            decode_batch(streams[1:], frame.params, sizes[1:], preset=preset)
            if n > 1 else []
        )
        parts = head + rest
    else:
        parts = decode_batch(streams, frame.params, sizes)
    out = b"".join(parts)
    if len(out) != frame.total_size:
        raise CorruptStreamError("decoded size mismatch")
    return out
