"""lzma_tpu — an LZMA codec framework with a JAX device path.

Capability parity with the reference Java LZMA SDK (rfalke/lzma-java),
re-architected for lane-parallel devices:

- ``core``     format constants, state machine, price model, flat prob arena
- ``codec``    scalar encoder (BT2/BT4/HC4 + optimal parse) / decoder oracles
- ``match``    match finders
- ``ops``      JAX device path: lane-parallel range-coder FSMs (Pallas-
               Triton kernels on a GPU), sort-based parallel match finding
- ``parallel`` block-parallel framing + mesh/shard_map multi-chip pipeline
- ``runtime``  native C++ multithreaded block codec (ctypes)
- ``bench``    LzmaBench-equivalent synthetic benchmark + ratings
- ``cli``      LzmaAlone-compatible command line (python -m lzma_tpu)
"""

from .format.properties import LzmaParams, decode_props  # noqa: F401
from .codec.encoder import encode_alone, encode_stream  # noqa: F401
from .codec.decoder import decode_alone, decode_stream  # noqa: F401
from .utils.dicttrain import train_dictionary  # noqa: F401

__version__ = "0.1.0"


_NATIVE_PROBE = [None, False]  # [module_or_None, probed]


def _native_or_none():
    # cache the probe: a failed build must not re-spawn the compiler on
    # every compress()/decompress() call
    if not _NATIVE_PROBE[1]:
        _NATIVE_PROBE[1] = True
        try:
            from .runtime import native

            if native.available():
                _NATIVE_PROBE[0] = native
        except Exception:
            pass
    return _NATIVE_PROBE[0]


def compress(data: bytes, params: LzmaParams | None = None,
             container: str = "alone", block_size: int = 1 << 20,
             num_threads: int = 0, preset_len: int = 0,
             dictionary: bytes = b"", train_dict=0,
             backend: str | None = None, **kw) -> bytes:
    """Compress in memory.  container="alone" (default): one `.lzma`
    (LZMA_Alone) stream — the reference's container, liblzma-decodable.
    container="lztb": the block-parallel LZTB container (all host
    threads; `preset_len`/`dictionary`/`train_dict` as in
    :func:`compress_file`).

    Routes through the native runtime when built (byte-identical to the
    scalar oracle — pinned by tests), scalar otherwise.
    backend="hybrid" (LZTB only) runs the hybrid-OPTIMAL pipeline:
    device multi-tier candidate search + host optimal parse/serialize
    (ops/hybrid.encode_blocks_hybrid_optimal) — ratio ~ native bt4-opt
    at a fraction of the host cost, with the search on the accelerator.

    params="auto" picks lc/lp/pb by measured cost on a spread sample of
    the input (utils/autotune.py); other fields keep their defaults or
    keyword overrides.
    """
    if params == "auto":
        from .utils.autotune import select_params

        params = select_params(
            data, LzmaParams(**kw) if kw else None, block_size=block_size)
        kw = {}
    params = params or (LzmaParams(**kw) if kw else None)
    if backend not in (None, "native", "scalar", "hybrid", "device"):
        raise ValueError(f"unknown backend: {backend!r}")
    native = _native_or_none()
    if backend == "native" and native is None:
        raise ValueError('backend="native" requested but the native '
                         "runtime is not available")
    if container == "lztb":
        if train_dict:
            if dictionary:
                raise ValueError(
                    "pass either dictionary= or train_dict=, not both"
                )
            if train_dict == "auto":
                from .utils.dicttrain import select_dictionary

                dictionary = select_dictionary(data, params,
                                               block_size=block_size)
            else:
                dictionary = train_dictionary(data, train_dict)
        if backend == "hybrid":
            from .ops.hybrid import encode_blocks_hybrid_optimal

            return encode_blocks_hybrid_optimal(
                data, params, block_size=block_size,
                num_threads=num_threads, preset_len=preset_len,
                dictionary=dictionary,
            )
        if backend == "device":
            # the all-device lane pipeline with the round-4 optimal-parse
            # DP tokenizer (ops/device_parser) — ratio ~bt4-opt class;
            # demonstration-grade throughput (DESIGN-NOTES.md physics)
            from .ops import api as _dev

            return _dev.encode_blocks(
                data, params or LzmaParams(), block_size=block_size,
                preset_len=preset_len, dictionary=dictionary,
                parse="optimal",
            )
        if native is not None and backend != "scalar":
            return native.encode_blocks(
                data, params, block_size=block_size, num_threads=num_threads,
                preset_len=preset_len, dictionary=dictionary,
            )
        import os as _os

        from .parallel import blocks as _blk

        return _blk.encode_blocks(
            data, params, block_size=block_size,
            num_threads=num_threads or (_os.cpu_count() or 1),
            preset_len=preset_len, dictionary=dictionary,
        )
    if container != "alone":
        raise ValueError(f"unknown container: {container!r}")
    if preset_len or dictionary or train_dict:
        raise ValueError("preset dictionaries apply to the LZTB container only")
    if backend in ("hybrid", "device"):
        raise ValueError(
            f'backend="{backend}" encodes the block-parallel LZTB '
            'container; pass container="lztb"'
        )
    params = params or LzmaParams()
    if native is not None and backend != "scalar":
        return native.encode_alone(data, params)
    return encode_alone(data, params)


def decompress(data: bytes) -> bytes:
    """Decompress a `.lzma` (LZMA_Alone) or LZTB block-parallel container
    (auto-detected by magic)."""
    native = _native_or_none()
    if data[:4] == b"LZTB":
        if native is not None:
            return native.decode_blocks(data)
        from .parallel import blocks as _blk

        return _blk.decode_blocks(data)
    if native is not None:
        return native.decode_alone(data)
    return decode_alone(data)


def compress_file(src, dst, params: LzmaParams | None = None,
                  block_size: int = 1 << 20, num_threads: int = 0,
                  preset_len: int = 0, dictionary: bytes = b"",
                  train_dict: int = 0, container: str = "lztb", **kw) -> int:
    """Stream-compress a file with constant memory.  Returns the container
    size in bytes.

    container="lztb" (default): block-parallel LZTB container, O(batch)
    memory, all host threads; `preset_len` shares the file's first bytes
    as a dictionary for every block after block 0 (LZTB v2);
    `dictionary` stores a trained dictionary that primes every block
    (LZTB v3); `train_dict=N` trains an N-byte dictionary from the
    file's first batch (utils/dicttrain.py) and uses it as `dictionary`;
    `train_dict="auto"` also auto-sizes it against its storage cost
    (possibly choosing no dictionary at all).
    container="alone": one `.lzma` (LZMA_Alone) single stream, O(dict)
    memory via the native sliding window — the reference's own container,
    decodable by stock liblzma and best compression ratio (no block
    boundaries).
    params="auto" picks lc/lp/pb by measured cost on the file's first
    batch (utils/autotune.py)."""
    import builtins

    from .parallel import filestream

    if params is not None and kw and params != "auto":
        raise TypeError(
            f"pass either params= or keyword overrides, not both: {sorted(kw)}"
        )
    if params == "auto":
        from .utils.autotune import select_params

        with builtins.open(src, "rb") as f:
            sample = f.read(filestream.DEFAULT_BATCH_BYTES)
        params = select_params(sample, LzmaParams(**kw) if kw else None,
                               block_size=block_size)
        kw = {}
    params = params or (LzmaParams(**kw) if kw else None)
    if container == "alone":
        if preset_len or dictionary or train_dict:
            raise ValueError(
                "preset dictionaries apply to the LZTB container only"
            )
        return filestream.encode_file_alone(src, dst, params)
    if container != "lztb":
        raise ValueError(f"unknown container: {container!r}")
    if train_dict:
        if dictionary:
            raise ValueError("pass either dictionary= or train_dict=, not both")
        with builtins.open(src, "rb") as f:
            sample = f.read(filestream.DEFAULT_BATCH_BYTES)
        if train_dict == "auto":
            from .utils.dicttrain import select_dictionary

            dictionary = select_dictionary(sample, params,
                                           block_size=block_size)
        else:
            dictionary = train_dictionary(sample, train_dict)
    return filestream.encode_file(
        src, dst, params, block_size=block_size, num_threads=num_threads,
        preset_len=preset_len, dictionary=dictionary,
    )


def open(path, mode: str = "rb", container: str = "lztb", **kw):  # noqa: A001
    """Open a compressed file for streaming IO (mirrors lzma.open).

    `path` is a filename or a binary file object (readable for 'rb',
    writable for 'wb'; auto-detecting a file-object read requires it to
    be seekable).  'wb' returns a writer accepting incremental write()
    with constant memory and unknown final size; 'rb' a reader with
    incremental read().
    container="lztb" (default for writing): block-parallel LZTB.
    container="alone": one `.lzma` single stream (O(dict) memory,
    EOS-terminated since the size is unknown while writing).  Readers
    auto-detect the container from the file's magic regardless of the
    argument.  Keyword args: params/block_size/num_threads/mode/preset_len/
    dictionary (LZTB writer), num_threads/batch_bytes (LZTB), optimal/mode (alone
    writer); LzmaParams fields (dict_size=..., fast_bytes=..., ...) are
    accepted directly like in :func:`compress`."""
    import builtins
    import dataclasses

    from .parallel.fileobj import AloneReader, AloneWriter, open_lztb

    fields = {f.name for f in dataclasses.fields(LzmaParams)}
    param_kw = {k: kw.pop(k) for k in list(kw) if k in fields}
    if param_kw:
        if kw.get("params") is not None:
            raise TypeError(
                f"pass either params= or field overrides, not both: "
                f"{sorted(param_kw)}"
            )
        kw["params"] = LzmaParams(**param_kw)
    if mode in ("rb", "r"):
        # auto-detect: LZTB magic vs raw .lzma props header
        if hasattr(path, "read"):
            pos = path.tell()
            magic = path.read(4)
            path.seek(pos)
        else:
            with builtins.open(path, "rb") as f:
                magic = f.read(4)
        if magic != b"LZTB":
            if kw:
                raise TypeError(f"unsupported kwargs for .lzma reads: {sorted(kw)}")
            return AloneReader(path)
        return open_lztb(path, mode, **kw)
    if mode in ("wb", "w") and container == "alone":
        return AloneWriter(path, **kw)
    if container != "lztb":
        raise ValueError(f"unknown container: {container!r}")
    return open_lztb(path, mode, **kw)


def decompress_file(src, dst, num_threads: int = 0) -> int:
    """Stream-decompress a compressed file to `dst` with constant memory:
    LZTB containers decode block-parallel with O(batch) memory, `.lzma`
    (LZMA_Alone) single streams decode through the native runtime's
    circular window with O(dict) memory.  Returns the decompressed size."""
    import builtins

    # NB: this module defines `open` (the streaming file-object API), so
    # plain file IO here must name the builtin explicitly
    with builtins.open(src, "rb") as f:
        magic = f.read(4)
    from .parallel import filestream

    if magic == b"LZTB":
        return filestream.decode_file(src, dst, num_threads=num_threads)
    try:
        return filestream.decode_file_alone(src, dst)
    except Exception as e:
        from .core.rangecoder import CorruptStreamError
        from .runtime.native import NativeUnavailable

        if isinstance(e, CorruptStreamError):
            raise
        if not isinstance(e, NativeUnavailable):
            raise
    # no compiler: whole-buffer scalar fallback (small files only)
    with builtins.open(src, "rb") as f:
        out = decompress(f.read())
    with builtins.open(dst, "wb") as f:
        f.write(out)
    return len(out)
