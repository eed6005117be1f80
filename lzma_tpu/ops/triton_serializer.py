"""Range-coder serializer as one Pallas-Triton kernel (GPU).

The GPU counterpart of `ops/device_encoder.serialize_xla`: it consumes
the precomputed per-lane (ctx, bit) streams and produces the same LZMA
bytes.  The XLA form is a `lax.while_loop` that codes one (ctx, bit)
per lane per iteration, so on a GPU every coded bit pays a chain of
kernel launches and a readback of the loop predicate.  Here the whole
loop runs inside one kernel:

  * lanes form the vector dimension: one program codes `LANES` lanes,
    one lane per thread of its single warp; the last program masks the
    lanes past N, so no buffer is padded;
  * each lane's probability arena is a row of an (N, S) int32 buffer
    in device memory (initialized by XLA and aliased into the kernel),
    read and updated by indexed load and store;
  * output bytes are stored straight into the lane's `max_out` row.

Every buffer is indexed as (lane, column), so Pallas computes the
offsets and widens them to 64 bits for buffers past 4 GiB; byte
buffers are kept under 2**31 bytes per call (`lane_groups`).

Per-lane coder registers (low / carry / range / cache / pending-0xFF
run) are loop-carried vectors with exactly the XLA serializer's update
rules, so the bytes are identical (asserted in tests).  A lane whose
output would pass `max_out` stops writing and reports its full length;
callers raise on it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: lanes per program: one per thread of a single warp, so every lane's
#: arena and output row are only ever touched by one thread
LANES = 32

#: the most bytes a byte buffer of one kernel call may span.  Pallas
#: indexes a buffer under 4 GiB with 32-bit offsets, which wrap past
#: 2**31, so a batch whose byte rows would pass this bound is run as
#: several calls over lane groups that stay within it
MAX_CALL_BYTES = 2**31 - 1


def lane_groups(n: int, row_bytes: int):
    """[start, stop) lane ranges covering n lanes, each group's rows of
    row_bytes bytes spanning at most MAX_CALL_BYTES.  A single row is
    always under 2**31 bytes: lane positions are int32."""
    per = max(1, MAX_CALL_BYTES // max(row_bytes, 1))
    return [(s, min(n, s + per)) for s in range(0, max(n, 1), per)]


def _any(mask):
    """Cross-lane any(); Triton has no boolean reduction."""
    return jnp.max(mask.astype(jnp.int32)) > 0


@partial(jax.jit, static_argnames=("arena_size", "max_out", "interpret"))
def serialize_triton(ctx, bits, totals, arena_size: int, max_out: int,
                     interpret: bool = False):
    """Same contract as `device_encoder.serialize_xla`: returns
    (out (N, max_out) u8, out_lens (N,) i32)."""
    parts = [_serialize_call(ctx[s:e], bits[s:e], totals[s:e], arena_size,
                             max_out, interpret)
             for s, e in lane_groups(ctx.shape[0], max_out)]
    if len(parts) == 1:
        return parts[0]
    return (jnp.concatenate([p[0] for p in parts]),
            jnp.concatenate([p[1] for p in parts]))


def _serialize_call(ctx, bits, totals, S: int, max_out: int, interpret):
    n, B = ctx.shape
    probs0 = jnp.full((n, S), 1024, jnp.int32)
    out0 = jnp.zeros((n, max_out), jnp.uint8)

    def kernel(ctx_ref, bits_ref, tot_ref, probs_in, out_in, probs_ref,
               out_ref, lens_ref):
        del probs_in, out_in  # aliased to probs_ref / out_ref
        lane = pl.program_id(0) * LANES + jnp.arange(LANES, dtype=jnp.int32)
        real = lane < n
        tot = plgpu.load(tot_ref.at[lane], mask=real, other=0)
        z = jnp.zeros((LANES,), jnp.int32)
        # lanes past n start flushed: they load and store nothing
        init = (jnp.zeros((LANES,), jnp.uint32), z,
                jnp.full((LANES,), 0xFFFFFFFF, jnp.uint32), z, z, z, z, z,
                z, jnp.where(real, 0, 5))

        def unfinished(c):
            bit_pos, drain, flush_i = c[7], c[5], c[9]
            return (bit_pos < tot) | (drain > 0) | (flush_i < 5)

        def body(c):
            (low, carry, rng, cache, pending, drain, drain_byte, bit_pos,
             out_pos, flush_i) = c
            draining = drain > 0
            has_bits = bit_pos < tot
            flushing = (~draining) & (~has_bits) & (flush_i < 5)
            coding = (~draining) & has_bits

            col = jnp.minimum(bit_pos, B - 1)
            cx = plgpu.load(ctx_ref.at[lane, col], mask=coding, other=0)
            bt = plgpu.load(bits_ref.at[lane, col], mask=coding, other=0)
            adaptive = coding & (cx >= 0)
            direct = coding & (cx == -1)

            acol = jnp.maximum(cx, 0)
            prob = plgpu.load(probs_ref.at[lane, acol], mask=adaptive,
                              other=1024)
            bound = (rng >> 11) * prob.astype(jnp.uint32)
            new_prob = jnp.where(bt == 0, prob + ((2048 - prob) >> 5),
                                 prob - (prob >> 5))
            plgpu.store(probs_ref.at[lane, acol], new_prob, mask=adaptive)

            rng_a = jnp.where(bt == 0, bound, rng - bound)
            low_add_a = jnp.where(bt == 1, bound, jnp.uint32(0))
            rng_d = rng >> 1
            low_add_d = jnp.where(bt == 1, rng_d, jnp.uint32(0))
            rng1 = jnp.where(adaptive, rng_a, jnp.where(direct, rng_d, rng))
            low_add = jnp.where(adaptive, low_add_a,
                                jnp.where(direct, low_add_d, jnp.uint32(0)))
            new_low = low + low_add
            new_carry = carry | (new_low < low).astype(jnp.int32)

            renorm = coding & (rng1 < (1 << 24))
            need_shift = renorm | flushing
            rng2 = jnp.where(renorm, rng1 << 8, rng1)
            fire = need_shift & ((new_carry == 1)
                                 | (new_low < jnp.uint32(0xFF000000)))
            stall = need_shift & ~fire
            emit_byte = (cache + new_carry) & 0xFF
            filler = (0xFF + new_carry) & 0xFF

            # draining and fire are exclusive: one byte per iteration
            wflag = draining | fire
            wbyte = jnp.where(draining, drain_byte, emit_byte)
            plgpu.store(out_ref.at[lane, jnp.minimum(out_pos, max_out - 1)],
                        wbyte.astype(jnp.uint8),
                        mask=wflag & (out_pos < max_out))

            out_pos = out_pos + wflag.astype(jnp.int32)
            drain = jnp.where(draining, drain - 1,
                              jnp.where(fire, pending, drain))
            drain_byte = jnp.where(fire, filler, drain_byte)
            pending = jnp.where(fire, 0,
                                jnp.where(stall, pending + 1, pending))
            cache = jnp.where(fire, (new_low >> 24).astype(jnp.int32) & 0xFF,
                              cache)
            low2 = jnp.where(need_shift, (new_low & 0xFFFFFF) << 8, new_low)
            carry2 = jnp.where(need_shift, 0, new_carry)
            bit_pos = bit_pos + coding.astype(jnp.int32)
            flush_i = flush_i + flushing.astype(jnp.int32)
            return (low2, carry2, rng2, cache, pending, drain, drain_byte,
                    bit_pos, out_pos, flush_i)

        final = jax.lax.while_loop(lambda c: _any(unfinished(c)), body,
                                   init)
        plgpu.store(lens_ref.at[lane], final[8], mask=real)

    _, out, lens = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, LANES),),
        out_shape=(
            jax.ShapeDtypeStruct((n, S), jnp.int32),
            jax.ShapeDtypeStruct((n, max_out), jnp.uint8),
            jax.ShapeDtypeStruct((n,), jnp.int32),
        ),
        input_output_aliases={3: 0, 4: 1},
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="lzma_range_encode",
    )(ctx, bits, totals, probs0, out0)
    return out, lens
