"""LZMA decode FSM as one Pallas-Triton kernel (GPU).

The GPU counterpart of `ops/device_decoder.decode_fsm_xla`.  The XLA
form is a `lax.while_loop` that advances every lane by one adaptive bit
(or one copied byte) per iteration; on a GPU each iteration costs a
chain of kernel launches plus a readback of the loop predicate.  Here
the loop runs inside one kernel, with the same select network
(`device_decoder._ctx_index`, `_bit_decode`, `_transition`), so the
decoded bytes and the ok/error verdict per lane are identical:

  * lanes form the vector dimension: one program decodes `LANES` lanes,
    one lane per thread of its single warp; the last program masks the
    lanes past N, so no buffer is padded;
  * each lane's probability arena is an (S,) row of a device buffer
    initialized by XLA and aliased into the kernel, read and updated by
    indexed load and store;
  * the lane's output row is itself the dictionary window: match copies
    and the matched-literal predictor read earlier output bytes straight
    from it, so no separate window is kept.

Buffers are indexed as (lane, column), and byte buffers are kept under
2**31 bytes per call, as in ops/triton_serializer.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.layout import ProbLayout
from .device_decoder import (
    PH_DONE,
    PH_ERROR,
    PH_ISMATCH,
    _TOP,
    _bit_decode,
    _ctx_index,
    _state_struct,
    _transition,
)
from .triton_serializer import LANES, _any, lane_groups


@partial(jax.jit, static_argnames=("lc", "lp", "pb", "max_out", "max_iters",
                                   "interpret"))
def decode_fsm_triton(comp, comp_lens, out_sizes, dict_size, lc, lp, pb,
                      max_out, max_iters=0, preset=None, interpret=False):
    """Same contract as `device_decoder.decode_fsm_xla`: returns
    (out (N, max_out) u8, ok (N,), iters, out_pos (N,)).  `iters` is
    the largest iteration count of any program."""
    n, max_in = comp.shape
    parts = [_decode_call(comp[s:e], comp_lens[s:e], out_sizes[s:e],
                          dict_size, lc, lp, pb, max_out, max_iters, preset,
                          interpret)
             for s, e in lane_groups(n, max(max_in, max_out))]
    if len(parts) == 1:
        return parts[0]
    return (jnp.concatenate([p[0] for p in parts]),
            jnp.concatenate([p[1] for p in parts]),
            jnp.max(jnp.stack([p[2] for p in parts])),
            jnp.concatenate([p[3] for p in parts]))


def _decode_call(comp, comp_lens, out_sizes, dict_size, lc, lp, pb, max_out,
                 max_iters, preset, interpret):
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    S = layout.size
    n, max_in = comp.shape
    pos_base = 0 if preset is None else preset.shape[0]
    probs0 = jnp.full((n, S), 1024, jnp.int32)
    out0 = jnp.zeros((n, max_out), jnp.uint8)
    if pos_base:
        out0 = out0.at[:, :pos_base].set(preset[None, :].astype(jnp.uint8))
        prev_init = preset[-1].astype(jnp.int32)
    else:
        prev_init = jnp.int32(0)
    scalars = jnp.stack([jnp.maximum(jnp.asarray(dict_size, jnp.int32), 1),
                         prev_init])

    def kernel(comp_ref, lens_ref, sizes_ref, sc_ref, probs_in, out_in,
               probs_ref, out_ref, pos_ref, ok_ref, iters_ref):
        del probs_in, out_in  # aliased to probs_ref / out_ref
        lane = pl.program_id(0) * LANES + jnp.arange(LANES, dtype=jnp.int32)
        # lanes past n load size 0 and length 0: they start done, and
        # every load and store below is masked with `real` besides
        real = lane < n
        comp_lens_l = plgpu.load(lens_ref.at[lane], mask=real, other=0)
        sizes = plgpu.load(sizes_ref.at[lane], mask=real, other=0)
        dict_check = sc_ref[0]
        prev0 = jnp.zeros((LANES,), jnp.int32) + sc_ref[1]

        code0 = jnp.zeros((LANES,), jnp.uint32)
        for i in range(5):
            byte = plgpu.load(comp_ref.at[lane, i],
                              mask=real & (i < comp_lens_l), other=0)
            code0 = (code0 << 8) | byte.astype(jnp.uint32)
        st0 = _state_struct(LANES)
        st0["phase"] = jnp.where(sizes == 0, PH_DONE, PH_ISMATCH)
        if pos_base:
            st0["out_pos"] = jnp.full((LANES,), pos_base, jnp.int32)

        def active(st):
            return (st["phase"] != PH_DONE) & (st["phase"] != PH_ERROR)

        def cond(carry):
            st, rng, code, iters, prev = carry
            more = _any(active(st))
            if max_iters:
                more = more & (iters < max_iters)
            return more

        def body(carry):
            st, rng, code, iters, prev = carry
            out_pos = st["out_pos"]
            idx, is_adaptive, is_direct, consumes_bit = _ctx_index(
                st, layout, pb, pos_base)
            adapt = is_adaptive & real
            prob = plgpu.load(probs_ref.at[lane, idx], mask=adapt,
                              other=1024)
            bit, new_rng, new_code, new_prob = _bit_decode(
                rng, code, prob, is_adaptive, is_direct)
            plgpu.store(probs_ref.at[lane, idx], new_prob, mask=adapt)

            need = (new_rng < _TOP) & consumes_bit
            in_pos = st["in_pos"]
            next_byte = plgpu.load(
                comp_ref.at[lane, jnp.minimum(in_pos, max_in - 1)],
                mask=real & (in_pos < comp_lens_l), other=0).astype(jnp.int32)
            overrun = st["overrun"] + (need & (in_pos >= comp_lens_l)).astype(
                jnp.int32)
            new_rng = jnp.where(need, new_rng << 8, new_rng)
            new_code = jnp.where(
                need, (new_code << 8) | next_byte.astype(jnp.uint32), new_code)
            in_pos = jnp.where(need, in_pos + 1, in_pos)
            st = dict(st, in_pos=in_pos, overrun=overrun)

            back = jnp.clip(out_pos - st["rep0"] - 1, 0, max_out - 1)
            back_byte = plgpu.load(out_ref.at[lane, back], mask=real,
                                   other=0).astype(jnp.int32)
            st2, emit, emit_byte = _transition(
                st, bit, prev, back_byte, sizes, dict_check,
                layout, lc, lp, pb, pos_base)
            plgpu.store(
                out_ref.at[lane, jnp.minimum(out_pos, max_out - 1)],
                emit_byte.astype(jnp.uint8), mask=emit & real)
            prev2 = jnp.where(emit, emit_byte, prev)
            return (st2, new_rng, new_code, iters + 1, prev2)

        carry = (st0, jnp.full((LANES,), 0xFFFFFFFF, jnp.uint32), code0,
                 jnp.int32(0), prev0)
        st, _, _, iters, _ = jax.lax.while_loop(cond, body, carry)
        plgpu.store(pos_ref.at[lane], st["out_pos"], mask=real)
        plgpu.store(ok_ref.at[lane],
                    (st["phase"] == PH_DONE).astype(jnp.int32), mask=real)
        plgpu.store(iters_ref.at[lane],
                    jnp.zeros((LANES,), jnp.int32) + iters, mask=real)

    _, out, out_pos, ok, iters = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, LANES),),
        out_shape=(
            jax.ShapeDtypeStruct((n, S), jnp.int32),
            jax.ShapeDtypeStruct((n, max_out), jnp.uint8),
            jax.ShapeDtypeStruct((n,), jnp.int32),
            jax.ShapeDtypeStruct((n,), jnp.int32),
            jax.ShapeDtypeStruct((n,), jnp.int32),
        ),
        input_output_aliases={4: 0, 5: 1},
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="lzma_decode_fsm",
    )(comp, comp_lens, out_sizes, scalars, probs0, out0)
    return out, ok > 0, jnp.max(iters), out_pos
