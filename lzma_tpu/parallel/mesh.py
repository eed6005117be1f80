"""Multi-chip block-parallel codec over a jax.sharding.Mesh.

The scaling design from SURVEY.md §5.7/§5.8: input chunked into
independent LZMA block streams, sharded over the mesh's "blocks" axis
(data parallelism — the only axis that makes sense for a codec whose
streams are serial), each device running the lane-parallel kernels
(ops/device_*.py) on its local shard, then an ordered ragged gather:
compressed sizes first (tiny all_gather), then the padded
payload buffers (one all_gather), with the host doing the final ordered
concat + container framing.  Multi-host works unchanged: jax.distributed
initializes the global mesh and the same all_gathers cross hosts.  The
cards of one host are joined all to all, so the mesh is one flat
("blocks",) axis.

Replaces: nothing in the reference — it is single-threaded end to end
(SURVEY.md §2 "Parallelism inventory: none").
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..format.properties import LzmaParams
from ..parallel import blocks as blk
from ..ops.device_encoder import check_out_lens, encode_lanes
from ..ops import kernels

BLOCK_AXIS = "blocks"


def make_mesh(devices=None, axis: str = BLOCK_AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _pad_lanes(num: int, num_devices: int) -> int:
    return ((num + num_devices - 1) // num_devices) * num_devices


@partial(jax.jit, static_argnames=("lc", "lp", "pb", "fb", "mesh_holder",
                                   "gather", "parse"))
def _encode_step(data, lens, dict_size, *, lc, lp, pb, fb, mesh_holder,
                 gather=True, parse="lazy"):
    """One sharded encode step: local lane-parallel encode + ordered gather.

    gather=True replicates the ragged results to every device with an
    all_gather (required on multi-host, where only addressable shards can
    be read back); gather=False leaves them block-sharded — the host
    reads each shard once over PCIe with NO collective at all, removing
    the O(devices x total) replication traffic (the single-host
    default).
    """
    mesh = mesh_holder.mesh

    def local(data_l, lens_l):
        comp, comp_lens = encode_lanes(
            data_l, lens_l, dict_size, lc=lc, lp=lp, pb=pb, fb=fb,
            parse=parse,
        )
        if not gather:
            return comp, comp_lens
        # ordered ragged gather: sizes first, then padded payloads
        all_lens = jax.lax.all_gather(comp_lens, BLOCK_AXIS, tiled=True)
        all_comp = jax.lax.all_gather(comp, BLOCK_AXIS, tiled=True)
        return all_comp, all_lens

    out_specs = ((P(None, None), P(None)) if gather
                 else (P(BLOCK_AXIS, None), P(BLOCK_AXIS)))
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS, None), P(BLOCK_AXIS)),
        out_specs=out_specs,
        check_vma=False,  # loop carries start replicated, become device-varying
    )(data, lens)


@partial(jax.jit, static_argnames=("lc", "lp", "pb", "fb", "mesh_holder",
                                   "gather"))
def _encode_step_preset(data, lens, preset, dict_size, *, lc, lp, pb, fb,
                        mesh_holder, gather=True):
    """Sharded encode with a SHARED preset dictionary (LZTB v2).

    `preset` is replicated (in_specs P(None)): XLA broadcasts the
    dictionary to every device; each device then primes its
    local lanes' windows with it (SURVEY.md §5.8's broadcast).
    """
    mesh = mesh_holder.mesh

    def local(data_l, lens_l, preset_r):
        comp, comp_lens = encode_lanes(
            data_l, lens_l, dict_size, lc=lc, lp=lp, pb=pb, fb=fb,
            preset=preset_r,
        )
        if not gather:
            return comp, comp_lens
        all_lens = jax.lax.all_gather(comp_lens, BLOCK_AXIS, tiled=True)
        all_comp = jax.lax.all_gather(comp, BLOCK_AXIS, tiled=True)
        return all_comp, all_lens

    out_specs = ((P(None, None), P(None)) if gather
                 else (P(BLOCK_AXIS, None), P(BLOCK_AXIS)))
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS, None), P(BLOCK_AXIS), P(None)),
        out_specs=out_specs,
        check_vma=False,  # loop carries start replicated, become device-varying
    )(data, lens, preset)


@partial(jax.jit, static_argnames=("lc", "lp", "pb", "max_out", "mesh_holder",
                                   "gather"))
def _decode_step(comp, comp_lens, out_sizes, dict_size, *, lc, lp, pb,
                 max_out, mesh_holder, gather=True):
    """One sharded decode step: local FSM decode + ordered gather."""
    mesh = mesh_holder.mesh

    def local(comp_l, lens_l, sizes_l):
        out, ok, _, _pos = kernels.for_platform().decode_fsm(
            comp_l, lens_l, sizes_l, dict_size, lc, lp, pb, max_out, 0
        )
        if not gather:
            return out, ok
        all_out = jax.lax.all_gather(out, BLOCK_AXIS, tiled=True)
        all_ok = jax.lax.all_gather(ok, BLOCK_AXIS, tiled=True)
        return all_out, all_ok

    out_specs = ((P(None, None), P(None)) if gather
                 else (P(BLOCK_AXIS, None), P(BLOCK_AXIS)))
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS, None), P(BLOCK_AXIS), P(BLOCK_AXIS)),
        out_specs=out_specs,
        check_vma=False,  # loop carries start replicated, become device-varying
    )(comp, comp_lens, out_sizes)


@partial(jax.jit, static_argnames=("lc", "lp", "pb", "max_out", "mesh_holder",
                                   "gather"))
def _decode_step_preset(comp, comp_lens, out_sizes, preset, dict_size, *,
                        lc, lp, pb, max_out, mesh_holder, gather=True):
    """Sharded decode with a SHARED preset dictionary (LZTB v2).

    `preset` rides with in_specs P(None) — replicated, i.e. XLA
    broadcasts the dictionary to every device before the
    device-local FSMs start: exactly the "broadcast preset dictionaries"
    collective of the scaling design (SURVEY.md §5.8).
    """
    mesh = mesh_holder.mesh

    def local(comp_l, lens_l, sizes_l, preset_r):
        out, ok, _, _pos = kernels.for_platform().decode_fsm(
            comp_l, lens_l, sizes_l, dict_size, lc, lp, pb, max_out, 0,
            preset=preset_r,
        )
        if not gather:
            return out, ok
        all_out = jax.lax.all_gather(out, BLOCK_AXIS, tiled=True)
        all_ok = jax.lax.all_gather(ok, BLOCK_AXIS, tiled=True)
        return all_out, all_ok

    out_specs = ((P(None, None), P(None)) if gather
                 else (P(BLOCK_AXIS, None), P(BLOCK_AXIS)))
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS, None), P(BLOCK_AXIS), P(BLOCK_AXIS), P(None)),
        out_specs=out_specs,
        check_vma=False,  # loop carries start replicated, become device-varying
    )(comp, comp_lens, out_sizes, preset)


@partial(jax.jit, static_argnames=("fb", "cap", "tiers_key", "mesh_holder",
                                   "gather"))
def _hybrid_search_step(data, lens, dict_size, *, fb, cap, tiers_key,
                        mesh_holder, gather=False):
    """Sharded half of the FLAGSHIP encode: every device runs the
    multi-tier candidate search + device-side flatten on its local block
    shard (ops/device_matcher.find_match_lists + pack_match_lists); the
    packed fixed-shape results either stay block-sharded (single-host
    default — the host reads each shard once) or all_gather for
    multi-host coordinators, exactly like the other mesh steps."""
    from ..ops.device_matcher import pack_match_lists
    from ..ops.hybrid import _list_engine

    find_lists = _list_engine(fb)
    mesh = mesh_holder.mesh
    tiers = dict(tiers_key)

    def local(data_l, lens_l):
        def one(d, n):
            cl, cd, counts = find_lists(d, n, dict_size, fb, **tiers)
            return pack_match_lists(cl, cd, counts, cap)

        # Memory-bounded grouping: the local lane batch is chunked to the
        # same ~2 MB-of-lane-data bound as ops/hybrid._match_lists_grouped
        # (a fixed bound, not yet sized against the card's memory).
        # lax.map lowers to a sequential loop, so only ONE group's search
        # intermediates are live at a time; idle zero lanes pad the last
        # group to a single stable shape.
        L, width = data_l.shape
        group = max(1, (2 << 20) // max(width, 1))
        if L <= group:
            fl, fd, ce = jax.vmap(one)(data_l, lens_l)
        else:
            ng = -(-L // group)
            pad = ng * group - L
            dp = jnp.concatenate(
                [data_l, jnp.zeros((pad, width), data_l.dtype)], axis=0)
            lp = jnp.concatenate([lens_l, jnp.zeros(pad, lens_l.dtype)])
            fl, fd, ce = jax.lax.map(
                lambda g: jax.vmap(one)(g[0], g[1]),
                (dp.reshape(ng, group, width), lp.reshape(ng, group)))
            fl = fl.reshape(ng * group, -1)[:L]
            fd = fd.reshape(ng * group, -1)[:L]
            ce = ce.reshape(ng * group, -1)[:L]
        if not gather:
            return fl, fd, ce
        return (jax.lax.all_gather(fl, BLOCK_AXIS, tiled=True),
                jax.lax.all_gather(fd, BLOCK_AXIS, tiled=True),
                jax.lax.all_gather(ce, BLOCK_AXIS, tiled=True))

    out_specs = ((P(None, None),) * 3 if gather
                 else (P(BLOCK_AXIS, None),) * 3)
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS, None), P(BLOCK_AXIS)),
        out_specs=out_specs,
        check_vma=False,
    )(data, lens)


def encode_blocks_mesh_hybrid(
    data: bytes,
    params: LzmaParams | None = None,
    block_size: int = 1 << 18,
    mesh: Mesh | None = None,
    fb: int | None = None,
    tiers: dict | None = None,
    num_threads: int = 0,
    gather: bool | None = None,
) -> bytes:
    """The hybrid encode over a device mesh: block-data-parallel
    candidate search on every device (hybrid-optimal pipeline,
    ops/hybrid.encode_blocks_hybrid_optimal semantics) + host-parallel
    optimal parse/serialize of the local results.  Ratio is identical to
    the single-device hybrid-optimal encoder (same lists, same parse).
    """
    from ..ops.hybrid import DEFAULT_TIERS, _flatten_packed
    from ..runtime import native

    params = (params or LzmaParams()).validated_for_encode()
    if params.write_eos:
        raise ValueError("block container uses known sizes; EOS not supported")
    mesh = mesh or make_mesh()
    d = mesh.devices.size
    blocks = blk.split_blocks(data, block_size)
    if not blocks:
        return blk.build_container(params, block_size, 0, [])
    fb = int(fb if fb is not None else params.fast_bytes)
    tiers = dict(DEFAULT_TIERS) if tiers is None else dict(tiers)
    tiers.setdefault("k4", DEFAULT_TIERS["k4"])
    tiers.setdefault("k8", DEFAULT_TIERS["k8"])
    n = len(blocks)
    bs = block_size
    lanes = _pad_lanes(n, d)
    arr = np.zeros((lanes, bs), dtype=np.uint8)
    lens = np.zeros(lanes, dtype=np.int32)
    for i, b in enumerate(blocks):
        arr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    if gather is None:
        gather = jax.process_count() > 1
    fl, fd, ce = _hybrid_search_step(
        jnp.asarray(arr), jnp.asarray(lens),
        jnp.int32(min(params.dict_size, bs)),
        fb=fb, cap=3 * bs, tiers_key=tuple(sorted(tiers.items())),
        mesh_holder=_MeshHolder(mesh), gather=gather)
    flat_l, flat_d, flat_off, pos_base = _flatten_packed(
        np.asarray(fl)[:n], np.asarray(fd)[:n], np.asarray(ce)[:n], lens[:n])
    payload, sizes = native.encode_candidate_blocks(
        arr[:n].reshape(-1), bs, params.lc, params.lp, params.pb,
        min(params.dict_size, 1 << 29), fb, flat_l, flat_d, flat_off,
        pos_base, num_threads=num_threads,
        total_len=(n - 1) * bs + int(lens[n - 1]),
    )
    import struct

    head = blk.pack_header(params, bs, len(data), n, 0, 0, 0)
    return head + struct.pack(f"<{n}I", *sizes) + payload


class _MeshHolder:
    """Hashable wrapper so a Mesh can ride a static jit arg."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __hash__(self):
        return hash(tuple(d.id for d in self.mesh.devices.flat))

    def __eq__(self, other):
        return isinstance(other, _MeshHolder) and self.mesh == other.mesh


def encode_blocks_mesh(
    data: bytes,
    params: LzmaParams | None = None,
    block_size: int = 1 << 18,
    mesh: Mesh | None = None,
    fb: int | None = None,
    preset_len: int = 0,
    dictionary: bytes = b"",
    gather: bool | None = None,
    parse: str = "lazy",
) -> bytes:
    """Data-parallel block encode over every device in the mesh.

    Each device runs ops/device_encoder.encode_lanes on its shard (the
    Triton range coder and DP scan on GPUs).  `preset_len > 0` writes LZTB v2: block 0 encodes plain on one lane,
    then its prefix is broadcast to every device (replicated shard_map
    operand) and all remaining blocks encode against it.  `dictionary`
    writes LZTB v3: the trained dictionary is stored as its own
    compressed stream and broadcast to every device, priming EVERY lane.
    """
    params = (params or LzmaParams()).validated_for_encode()
    mesh = mesh or make_mesh()
    d = mesh.devices.size
    preset_len = blk.validated_preset_len(preset_len, block_size, len(data))
    dictionary = blk.validated_dictionary(dictionary, preset_len)
    if len(data) <= block_size:
        preset_len = 0  # single block: a preset would be pointless
    if not data:
        dictionary = b""
    blocks = blk.split_blocks(data, block_size)
    if not blocks:
        return blk.build_container(params, block_size, 0, [])
    n = len(blocks)
    from ..ops.device_encoder import clamp_fb

    fb = clamp_fb(fb if fb is not None else params.fast_bytes)
    # single-host: skip the payload all_gather entirely (results stay
    # block-sharded; the host reads each shard once).  Multi-host needs
    # the replication so the coordinator can read every block.  The
    # explicit override exists for tests and A/Bs of the gather designs.
    if gather is None:
        gather = jax.process_count() > 1
    common = dict(
        lc=params.lc, lp=params.lp, pb=params.pb, fb=fb,
        mesh_holder=_MeshHolder(mesh), gather=gather,
    )

    first = 0
    streams = []
    dict_stream = b""
    if dictionary:
        from ..ops.device_encoder import encode_batch

        (dict_stream,) = encode_batch([dictionary], params, fb=fb)
    elif preset_len:
        from ..ops.device_encoder import encode_batch

        streams.append(encode_batch(blocks[:1], params, fb=fb)[0])
        first = 1

    pre_bytes = dictionary or (data[:preset_len] if preset_len else b"")
    m = n - first
    lanes = _pad_lanes(m, d)
    max_n = max(block_size, 16)
    arr = np.zeros((lanes, max_n), dtype=np.uint8)
    lens = np.zeros(lanes, dtype=np.int32)
    for i in range(first, n):
        b = blocks[i]
        arr[i - first, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i - first] = len(b)
    dict_size = jnp.int32(min(params.dict_size, max_n + len(pre_bytes)))
    preset = (np.frombuffer(pre_bytes, dtype=np.uint8) if pre_bytes else None)
    if pre_bytes:
        comp, comp_lens = _encode_step_preset(
            jnp.asarray(arr), jnp.asarray(lens), jnp.asarray(preset),
            dict_size, **common,
        )
    else:
        comp, comp_lens = _encode_step(
            jnp.asarray(arr), jnp.asarray(lens), dict_size, parse=parse,
            **common,
        )
    comp = np.asarray(comp)
    comp_lens = np.asarray(comp_lens)
    check_out_lens(comp_lens[:m], comp.shape[1])
    streams.extend(comp[i, : comp_lens[i]].tobytes() for i in range(m))
    return blk.build_container(params, block_size, len(data), streams,
                               preset_len, dict_stream, len(dictionary))


def decode_blocks_mesh(blob, mesh: Mesh | None = None,
                       gather: bool | None = None) -> bytes:
    """Data-parallel block decode over every device in the mesh.

    LZTB v2 (shared preset): block 0 decodes first (one lane), its
    prefix is broadcast to every device as a replicated array, then all
    remaining blocks decode data-parallel against it.
    """
    frame = blk.parse_container(blob)
    mesh = mesh or make_mesh()
    d = mesh.devices.size
    n = len(frame.comp_sizes)
    if n == 0:
        return b""
    offsets, _ext_sizes = frame.stream_extents(len(blob))

    def block_out_size(i):
        return _ext_sizes[i]

    first = 0
    parts = []
    preset = None
    plen = 0
    if frame.dict_len:
        # LZTB v3: decode the stored dictionary on one lane, broadcast it
        # to every device, then ALL blocks decode data-parallel against it
        from ..ops.device_decoder import decode_batch

        (dictionary,) = decode_batch(
            [bytes(blob[frame.payload_offset : frame.blocks_offset])],
            frame.params, [frame.dict_len],
        )
        preset = np.frombuffer(dictionary, dtype=np.uint8)
        plen = frame.dict_len
    elif frame.preset_len:
        from ..ops.device_decoder import decode_batch

        head = decode_batch(
            [bytes(blob[offsets[0] : offsets[1]])], frame.params,
            [block_out_size(0)],
        )
        parts.append(head[0])
        preset = np.frombuffer(head[0][: frame.preset_len], dtype=np.uint8)
        plen = frame.preset_len
        first = 1
        if n == 1:
            return parts[0]

    lanes = _pad_lanes(n - first, d)
    max_in = max(max(frame.comp_sizes[first:]), 16)
    comp = np.zeros((lanes, max_in), dtype=np.uint8)
    lens = np.zeros(lanes, dtype=np.int32)
    sizes = np.zeros(lanes, dtype=np.int32)
    for i in range(first, n):
        s = bytes(blob[offsets[i] : offsets[i + 1]])
        comp[i - first, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        lens[i - first] = len(s)
        sizes[i - first] = block_out_size(i)
    common = dict(
        lc=frame.params.lc,
        lp=frame.params.lp,
        pb=frame.params.pb,
        mesh_holder=_MeshHolder(mesh),
        # see encode_blocks_mesh; override for tests/A-Bs
        gather=(jax.process_count() > 1) if gather is None else gather,
    )
    dict_size = np.int64(min(frame.params.dict_size, 2**31 - 1))
    if preset is not None:
        out, ok = _decode_step_preset(
            jnp.asarray(comp),
            jnp.asarray(lens),
            jnp.asarray(sizes + plen),  # absolute end positions
            jnp.asarray(preset),
            dict_size,
            max_out=max(frame.block_size, 1) + plen,
            **common,
        )
    else:
        out, ok = _decode_step(
            jnp.asarray(comp),
            jnp.asarray(lens),
            jnp.asarray(sizes),
            dict_size,
            max_out=max(frame.block_size, 1),
            **common,
        )
    out = np.asarray(out)
    ok = np.asarray(ok)
    m = n - first
    if not ok[:m].all():
        bad = int(np.argmin(ok[:m])) + first
        raise ValueError(f"mesh decode failed for block {bad}")
    skip = plen if preset is not None else 0
    parts.extend(out[i, skip : skip + sizes[i]].tobytes() for i in range(m))
    return b"".join(parts)
