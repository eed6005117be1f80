"""What chip_smoke.py's full-width kernel phase does not cover, on the
card: the platform choice, lanes of varied lengths with a dictionary
smaller than the lane, programs whose last lanes are masked, and a byte
buffer past 2**31 bytes.  Marked `gpu`: they skip without a GPU and run
in chip_smoke.py's last phase."""

import lzma

import numpy as np
import pytest

import jax.numpy as jnp

from lzma_tpu.core.layout import ProbLayout
from lzma_tpu.ops import device_decoder, device_encoder, kernels

pytestmark = pytest.mark.gpu


def _text(n, skip=0):
    from lzma_tpu.bench.corpus import text_part

    return text_part()[skip:skip + n]


def _raw_streams(payloads, dict_size):
    """liblzma's raw LZMA streams (the .lzma header stripped)."""
    filt = [{"id": lzma.FILTER_LZMA1, "preset": 6, "dict_size": dict_size}]
    return [lzma.compress(p, format=lzma.FORMAT_ALONE, filters=filt)[13:]
            for p in payloads]


def _padded(streams):
    mi = 1 << (max(len(s) for s in streams) - 1).bit_length()
    comp = np.zeros((len(streams), mi), np.uint8)
    for i, s in enumerate(streams):
        comp[i, :len(s)] = np.frombuffer(s, np.uint8)
    return (jnp.asarray(comp),
            jnp.asarray(np.array([len(s) for s in streams], np.int32)))


def test_platform_picks_kernels(gpu):
    from lzma_tpu.ops.device_parser import dp_parse_triton
    from lzma_tpu.ops.triton_decoder import decode_fsm_triton
    from lzma_tpu.ops.triton_serializer import serialize_triton

    assert kernels.for_platform() == kernels.Kernels(
        dp_parse_triton, serialize_triton, decode_fsm_triton)


def test_decoder_kernel_ragged_small_dict(gpu):
    """35 lanes of 2-12 KiB over two programs, with a 4 KiB dictionary:
    match distances stay inside the window while each lane runs its own
    length, and max_out holds the longest lane."""
    payloads = [_text(2000 + 300 * i, 15000 * i) for i in range(35)]
    comp, lens = _padded(_raw_streams(payloads, 1 << 12))
    sizes = jnp.asarray(np.array([len(p) for p in payloads], np.int32))
    max_out = 1 << (max(len(p) for p in payloads) - 1).bit_length()
    args = (comp, lens, sizes, np.int64(1 << 12), 3, 0, 2, max_out)
    k = kernels.for_platform().decode_fsm(*args)
    x = device_decoder.decode_fsm_xla(*args)
    for i in (0, 1, 3):
        assert np.array_equal(np.asarray(k[i]), np.asarray(x[i]))
    out = np.asarray(k[0])
    assert all(out[i, :len(p)].tobytes() == p for i, p in enumerate(payloads))


@pytest.mark.parametrize("n_lanes", [1, 33])
def test_serializer_kernel_masked_lanes(gpu, n_lanes):
    """One lane, and 33 lanes over two programs: the lanes past N are
    masked, and the real lanes equal the XLA coder."""
    block = 4096
    data = np.frombuffer(_text(n_lanes * block), np.uint8).reshape(-1, block)
    lens = jnp.full((n_lanes,), block, jnp.int32)
    ctx, bits, totals, mo = device_encoder.lower_lanes(
        jnp.asarray(data), lens, jnp.int32(block), lc=3, lp=0, pb=2, fb=32)
    arena = ProbLayout(3, 0, 2, pos_bits=2).size
    k = kernels.for_platform().serialize(ctx, bits, totals, arena, mo)
    x = device_encoder.serialize_xla(ctx, bits, totals, arena, mo)
    assert np.array_equal(np.asarray(k[1]), np.asarray(x[1]))
    assert np.array_equal(np.asarray(k[0]), np.asarray(x[0]))


def test_decoder_output_buffer_past_2gib(gpu):
    """Three lanes with 1 GiB output rows: 3 GiB of output, the last
    row starting past 2**31 bytes.  Each lane decodes to its payload."""
    payloads = [_text(3000, 7000 * i) for i in range(3)]
    comp, lens = _padded(_raw_streams(payloads, 1 << 16))
    sizes = jnp.asarray(np.array([len(p) for p in payloads], np.int32))
    out, ok, _, pos = kernels.for_platform().decode_fsm(
        comp, lens, sizes, np.int64(1 << 16), 3, 0, 2, 1 << 30)
    assert bool(jnp.all(ok))
    assert np.array_equal(np.asarray(pos), np.asarray(sizes))
    for i, p in enumerate(payloads):
        assert np.asarray(out[i, :len(p)]).tobytes() == p
