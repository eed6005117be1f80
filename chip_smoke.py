#!/usr/bin/env python
"""Smoke run of the device codec on an NVIDIA GPU, through the entry
points a user calls.

Deployment: squashfs-style blocks — the committed 3 MiB text corpus
(`lzma_tpu.bench.corpus.text_part()`) in 128 KiB blocks (mksquashfs's
default block size for xz), library default parameters (lc3 lp0 pb2,
fb 32, dictionary clamped to the block).  One process, one card:

  encode      lzma_tpu.compress(..., container="lztb", backend="device")
  decode      the CLI's device backend, in-process (cli.main d)
  interop     native and scalar decoders read the device's container;
              liblzma reads a device-written .lzma (CLI e, no -bs);
              the device reads a liblzma-written .lzma (EOS marker)
  hybrid      compress(..., backend="hybrid"), decoded natively
  kernels     each Pallas-Triton kernel of the path against its plain
              XLA form at the same full-width inputs: DP scan tokens,
              range-coder bytes, decoder bytes
  pin         a small container must equal the CPU's byte for byte
              (PIN_SHA256, also checked by tests/test_chip_smoke.py)
  gpu tests   the `gpu`-marked tests in tests/test_gpu_kernels.py, after
              the main path's peak memory is printed

`--four` runs only the mesh path on four cards: encode_blocks_mesh and
decode_blocks_mesh against the single-device encode of the same data.

Run: python chip_smoke.py [--four].  Exits non-zero, printing no
result, when JAX finds no GPU or any check fails.  The last line is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import hashlib
import json
import lzma
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BLOCK = 1 << 17

#: sha256 of compress(text_part()[:PIN_BYTES], container="lztb",
#: backend="device", block_size=PIN_BLOCK) — the same on every backend
PIN_BYTES = 1 << 17
PIN_BLOCK = 1 << 15
PIN_SHA256 = "470348306093661856f7df6767784b680f1b43e4c20b2c0bc5da5d0089363f82"


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(msg):
    print(msg, flush=True)


def timed_phase(name, fn, runs=2):
    """Run fn `runs` times (the first compiles); print cold and warm
    wall times, each closed by block_until_ready; return the last
    result."""
    import jax

    times = []
    out = None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    warm = f", warm {times[1]:.3f} s" if runs > 1 else ""
    log(f"phase {name}: cold {times[0]:.3f} s{warm}")
    return out


def lanes_of(data, block):
    import numpy as np

    from lzma_tpu.parallel import blocks as blk

    blocks = blk.split_blocks(data, block)
    arr = np.zeros((len(blocks), block), np.uint8)
    lens = np.array([len(b) for b in blocks], np.int32)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
    return blocks, arr, lens


def one_card(data):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import lzma_tpu
    from lzma_tpu import cli
    from lzma_tpu.core.layout import ProbLayout
    from lzma_tpu.format.properties import LzmaParams
    from lzma_tpu.ops import api, device_decoder, device_encoder
    from lzma_tpu.ops import device_parser as dp
    from lzma_tpu.ops.triton_decoder import decode_fsm_triton
    from lzma_tpu.ops.triton_serializer import serialize_triton
    from lzma_tpu.parallel import blocks as blk
    from lzma_tpu.runtime import native

    params = LzmaParams()
    blocks, arr, lens = lanes_of(data, BLOCK)
    log(f"sizes: input {len(data)} bytes, {len(blocks)} blocks of {BLOCK} "
        f"bytes, lc{params.lc} lp{params.lp} pb{params.pb} "
        f"fb{params.fast_bytes} dict {min(params.dict_size, BLOCK)}")

    # -- encode through the library entry point
    blob = timed_phase("encode compress(backend=device)", lambda: lzma_tpu.compress(
        data, container="lztb", backend="device", block_size=BLOCK))
    check(lzma_tpu.compress(data, container="lztb", backend="device",
                            block_size=BLOCK) == blob, "encode not repeatable")
    ref = native.encode_blocks(data, params, block_size=BLOCK)
    log(f"compressed: device {len(blob)} bytes (ratio "
        f"{len(data) / len(blob):.4f}), native bt4-optimal {len(ref)} bytes; "
        f"device/native {len(blob) / len(ref):.4f}")
    log(f"container sha256 {hashlib.sha256(blob).hexdigest()}")

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.lztb")
        dst = os.path.join(tmp, "out.bin")
        with open(src, "wb") as f:
            f.write(blob)

        # -- decode on the device through the CLI, in-process
        def cli_decode():
            rc = cli.main(["d", "-backenddevice", "-q", src, dst])
            check(rc == 0, f"CLI device decode exit {rc}")
            with open(dst, "rb") as f:
                return f.read()

        check(timed_phase("decode cli d -backenddevice", cli_decode) == data,
              "device decode mismatch")

        # -- interop: native and scalar decoders read the device container
        check(timed_phase("decode native", lambda: lzma_tpu.decompress(blob),
                          runs=1) == data, "native decode mismatch")
        check(timed_phase("decode scalar oracle",
                          lambda: blk.decode_blocks(blob, num_threads=4),
                          runs=1) == data, "scalar decode mismatch")

        # -- the device writes a single .lzma stream; liblzma reads it
        one = data[:BLOCK]
        raw = os.path.join(tmp, "one.bin")
        alone = os.path.join(tmp, "one.lzma")
        with open(raw, "wb") as f:
            f.write(one)

        def cli_encode():
            rc = cli.main(["e", "-backenddevice", "-q", raw, alone])
            check(rc == 0, f"CLI device encode exit {rc}")
            with open(alone, "rb") as f:
                return f.read()

        stream = timed_phase("encode cli e -backenddevice (.lzma)",
                             cli_encode)
        check(lzma.decompress(stream, format=lzma.FORMAT_ALONE) == one,
              "liblzma cannot read the device's .lzma")
        log(f".lzma: {len(one)} -> {len(stream)} bytes, read by liblzma")

    # -- liblzma writes a .lzma with an end marker; the device reads it
    theirs = lzma.compress(one, format=lzma.FORMAT_ALONE)
    check(theirs[5:13] == b"\xff" * 8, "liblzma stream has a known size")
    check(timed_phase("decode liblzma .lzma (EOS) on device",
                      lambda: api.decode_alone(theirs)) == one,
          "device decode of liblzma's .lzma mismatch")

    # -- hybrid: device candidate search + native optimal parse
    hyb = timed_phase("encode compress(backend=hybrid)", lambda: lzma_tpu.compress(
        data, container="lztb", backend="hybrid", block_size=BLOCK))
    check(lzma_tpu.decompress(hyb) == data, "hybrid container mismatch")
    log(f"hybrid: {len(hyb)} bytes")

    # -- each kernel against its plain XLA form on identical inputs
    dj, lj = jnp.asarray(arr), jnp.asarray(lens)
    dict_j = jnp.int32(min(params.dict_size, BLOCK))
    fb, pb = params.fast_bytes, params.pb
    ld, dd, model, r0pos, replen = dp.dp_scan_inputs(
        dj, lj, dict_j, lc=params.lc, lp=params.lp, pb=pb, fb=fb)

    def scan(fn):
        return lambda: fn(dj, lj, ld, dd, model, fb, pb, False,
                          r0pos=r0pos, replen=replen)

    k = timed_phase("kernel dp_parse_triton", scan(dp.dp_parse_triton))
    x = timed_phase("xla dp_parse_band", scan(dp.dp_parse_band))
    check(all(np.array_equal(np.asarray(a), np.asarray(b))
              for a, b in zip(k, x)), "DP kernel tokens differ from XLA")

    ctx, bits, totals, max_out = device_encoder.lower_lanes(
        dj, lj, dict_j, lc=params.lc, lp=params.lp, pb=pb, fb=fb,
        parse="optimal")
    arena = ProbLayout(params.lc, params.lp, pb, pos_bits=pb).size
    k = timed_phase("kernel serialize_triton", lambda: serialize_triton(
        ctx, bits, totals, arena, max_out))
    x = timed_phase("xla serialize_xla", lambda: device_encoder.serialize_xla(
        ctx, bits, totals, arena, max_out))
    check(np.array_equal(np.asarray(k[1]), np.asarray(x[1]))
          and np.array_equal(np.asarray(k[0]), np.asarray(x[0])),
          "range-coder kernel bytes differ from XLA")

    out, olens = np.asarray(k[0]), np.asarray(k[1])
    streams = [out[i, :olens[i]].tobytes() for i in range(len(blocks))]
    mi = 1 << (max(len(s) for s in streams) - 1).bit_length()
    comp = np.zeros((len(streams), mi), np.uint8)
    for i, s in enumerate(streams):
        comp[i, :len(s)] = np.frombuffer(s, np.uint8)
    cl = jnp.asarray(np.array([len(s) for s in streams], np.int32))
    args = (jnp.asarray(comp), cl, lj, np.int64(min(params.dict_size, BLOCK)),
            params.lc, params.lp, pb, BLOCK)
    k = timed_phase("kernel decode_fsm_triton", lambda: decode_fsm_triton(*args))
    x = timed_phase("xla decode_fsm_xla", lambda: device_decoder.decode_fsm_xla(
        *args))
    check(all(np.array_equal(np.asarray(a), np.asarray(b))
              for a, b in (zip(k[:2], x[:2]))) and
          np.array_equal(np.asarray(k[3]), np.asarray(x[3])),
          "decoder kernel output differs from XLA")
    check(bool(np.all(np.asarray(k[1]))), "decoder kernel lanes failed")
    dec = np.asarray(k[0])
    check(all(dec[i, :len(b)].tobytes() == b for i, b in enumerate(blocks)),
          "decoder kernel bytes differ from the input")

    # -- the pinned container: identical on the CPU (tests/test_chip_smoke.py)
    small = lzma_tpu.compress(data[:PIN_BYTES], container="lztb",
                              backend="device", block_size=PIN_BLOCK)
    check(hashlib.sha256(small).hexdigest() == PIN_SHA256,
          "pinned container differs from the CPU's")
    log(f"pinned container sha256 matches ({len(small)} bytes)")


def gpu_tests():
    """The gpu-marked tests: what the phases above do not cover (the
    platform choice, ragged lanes with a small dictionary, masked lanes,
    a byte buffer past 2**31 bytes)."""
    import pytest

    os.environ["LZMA_TPU_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(ROOT, "tests", "test_gpu_kernels.py")])
    check(rc == 0, f"gpu tests failed (pytest exit {int(rc)})")


def four_cards(data):
    import jax

    from lzma_tpu.format.properties import LzmaParams
    from lzma_tpu.ops import api
    from lzma_tpu.parallel.mesh import (decode_blocks_mesh,
                                        encode_blocks_mesh, make_mesh)

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 GPUs, found {len(devs)}")
    mesh = make_mesh(devs[:4])
    params = LzmaParams()
    log(f"sizes: input {len(data)} bytes, {-(-len(data) // BLOCK)} blocks "
        f"of {BLOCK} bytes over a 4-card ('blocks',) mesh")
    single = timed_phase("encode single device", lambda: api.encode_blocks(
        data, params, block_size=BLOCK, parse="optimal"), runs=1)
    meshed = timed_phase("encode encode_blocks_mesh", lambda: encode_blocks_mesh(
        data, params, block_size=BLOCK, mesh=mesh, parse="optimal"))
    check(meshed == single, "mesh container differs from single-device")
    log(f"mesh container == single-device container ({len(meshed)} bytes, "
        f"sha256 {hashlib.sha256(meshed).hexdigest()})")
    check(timed_phase("decode decode_blocks_mesh",
                      lambda: decode_blocks_mesh(meshed, mesh=mesh)) == data,
          "mesh decode mismatch")


def main(argv):
    four = "--four" in argv
    sys.path.insert(0, ROOT)
    try:
        import jax

        import lzma_tpu  # noqa: F401
        from lzma_tpu.bench.corpus import text_part
        from lzma_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the codec next to this script: {e}",
              file=sys.stderr)
        return 2
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r}); "
              "refusing to run on another device", file=sys.stderr)
        return 3
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    log(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"jax.devices(): {devs}")
    data = text_part()
    used = devs[:4] if four else devs[:1]
    try:
        if four:
            four_cards(data)
        else:
            one_card(data)
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                 for d in used]
        log(f"peak_bytes_in_use: {peaks}")
        if not four:
            gpu_tests()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
