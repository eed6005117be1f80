"""Lane-parallel LZMA decoder: the decode loop as a vectorized bit FSM.

Lane-parallel re-architecture of the reference's strictly sequential decode
loop (Decoder.Code, Decoder.java:205-301).  One stream is bit-serial and
branchy — hostile to SIMD.  Instead of translating the branch tree, we
flatten the whole decoder into a finite-state machine in which EVERY
iteration performs the same uniform work for EVERY lane (lane = one
independent block stream):

    1. adaptive-bit decode:  ctx gather -> bound -> compare -> prob scatter
       (or a direct-bit / match-copy step, masked)
    2. renormalize:          pull an input byte where range < 2^24
    3. FSM transition:       pure select network computing the next
                             phase/registers from (phase, bit)

so a batch of N streams decodes in lock-step with no per-lane control
flow: inside one Pallas-Triton kernel on a GPU (ops/triton_decoder.py),
as the lax.while_loop decode_fsm_xla elsewhere.  Model state is the same
flat probability arena as every other backend ((N, arena) int32),
decoded output an (N, max_out) u8 buffer.

Semantics are bit-exact with the scalar oracle (pinned by
tests/test_device_decoder.py: decodes scalar/native/liblzma streams).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.constants import (
    NEXT_STATE_LITERAL,
    NEXT_STATE_LONGREP,
    NEXT_STATE_MATCH,
    NEXT_STATE_SHORTREP,
)
from ..core.layout import (
    LITERAL_CODER_SIZE,
    POS_SLOT_TREE_SIZE,
    ProbLayout,
)
from ..core.rangecoder import CorruptStreamError
from ..format.properties import LzmaParams
from . import kernels


class CapExceededError(CorruptStreamError):
    """An EOS-terminated lane hit its expansion cap before the end
    marker — the stream may be valid but larger; callers retry with a
    bigger cap (ops/api.decode_alone grows caps geometrically)."""

# FSM phases.  Each lane sits in exactly one phase per iteration.
PH_ISMATCH = 0        # decode is_match bit
PH_LIT = 1            # literal tree walk (normal mode)
PH_LITM = 2           # literal tree walk (matched mode)
PH_ISREP = 3
PH_ISREPG0 = 4
PH_ISREP0LONG = 5
PH_ISREPG1 = 6
PH_ISREPG2 = 7
PH_LENCHOICE = 8
PH_LENCHOICE2 = 9
PH_TREE = 10          # generic MSB-first bit tree (len low/mid/high, pos_slot)
PH_DIRECT = 11        # direct (equiprobable) distance bits
PH_REV = 12           # reverse bit tree (spec_pos, align)
PH_COPY = 13          # match copy, one byte per iteration (no bit consumed)
PH_DONE = 14
PH_ERROR = 15

# what a finished PH_TREE / PH_REV means
TK_LEN_MATCH = 0
TK_LEN_REP = 1
TK_POS_SLOT = 2
RK_SPEC = 0
RK_ALIGN = 1

_TOP = 1 << 24  # plain int: a jnp scalar here would initialize the XLA
#                 backend at import time (fatal before jax.distributed)
_U8 = jnp.uint8
_I32 = jnp.int32
_U32 = jnp.uint32


# Closed forms of the 12-state machine (Base.java:16-36) — equivalent to
# the NEXT_STATE_* tables (asserted below) but free of small-table
# gathers, so the same code runs inside the Triton kernel.
def _next_lit(state):
    return jnp.where(state < 4, 0, jnp.where(state < 10, state - 3, state - 6))


def _next_match(state):
    return jnp.where(state < 7, 7, 10)


def _next_longrep(state):
    return jnp.where(state < 7, 8, 11)


def _next_shortrep(state):
    return jnp.where(state < 7, 9, 11)


assert [0 if s < 4 else s - 3 if s < 10 else s - 6 for s in range(12)] == list(NEXT_STATE_LITERAL)
assert [7 if s < 7 else 10 for s in range(12)] == list(NEXT_STATE_MATCH)
assert [8 if s < 7 else 11 for s in range(12)] == list(NEXT_STATE_LONGREP)
assert [9 if s < 7 else 11 for s in range(12)] == list(NEXT_STATE_SHORTREP)


def _state_struct(n_lanes: int):
    """Initial per-lane register file."""
    z = lambda v=0: jnp.full((n_lanes,), v, dtype=_I32)
    return dict(
        phase=z(PH_ISMATCH),
        state=z(0),
        rep0=z(0), rep1=z(0), rep2=z(0), rep3=z(0),
        sym=z(1),            # literal/tree accumulator m
        lit_base=z(0),       # literal sub-coder arena offset
        mb=z(0),             # shifting match byte (matched literal mode)
        tree_base=z(0), tree_top=z(0), tree_kind=z(0),
        rev_base=z(0), rev_sym=z(0), rev_i=z(0), rev_n=z(0), rev_kind=z(0), rev_m=z(1),
        acc=z(0), bits_left=z(0), dist_base=z(0),
        length=z(0),
        out_pos=z(0), in_pos=z(5),     # 5 header bytes consumed by init
        overrun=z(0),
    )


# --------------------------------------------------------------------------
# The FSM's pure pieces, shared between the XLA while_loop backend below and
# the Triton kernel (ops/triton_decoder.py).  Everything here is a select
# network over per-lane registers — no gathers, no scatters; the backends
# supply those (probability arena + output window access).


def _ctx_index(st, layout, pb, pos_base=0):
    """Arena index for this iteration's adaptive bit, per lane.

    `pos_base` is the primed-window prefix length (preset dictionary):
    position contexts count coded bytes only, so they use
    out_pos - pos_base.  Returns (idx, is_adaptive, is_direct,
    consumes_bit).
    """
    phase = st["phase"]
    state = st["state"]
    sym = st["sym"]
    coded_pos = st["out_pos"] - pos_base if pos_base else st["out_pos"]
    pos_state = coded_pos & ((1 << pb) - 1)
    idx = jnp.full_like(phase, 0)
    idx = jnp.where(phase == PH_ISMATCH,
                    layout.is_match + (state << layout.pos_bits) + pos_state, idx)
    idx = jnp.where(phase == PH_LIT, st["lit_base"] + sym, idx)
    match_bit = (st["mb"] >> 7) & 1
    idx = jnp.where(phase == PH_LITM,
                    st["lit_base"] + ((1 + match_bit) << 8) + sym, idx)
    idx = jnp.where(phase == PH_ISREP, layout.is_rep + state, idx)
    idx = jnp.where(phase == PH_ISREPG0, layout.is_rep_g0 + state, idx)
    idx = jnp.where(phase == PH_ISREP0LONG,
                    layout.is_rep0_long + (state << layout.pos_bits) + pos_state, idx)
    idx = jnp.where(phase == PH_ISREPG1, layout.is_rep_g1 + state, idx)
    idx = jnp.where(phase == PH_ISREPG2, layout.is_rep_g2 + state, idx)
    len_base = jnp.where(st["tree_kind"] == TK_LEN_REP, layout.rep_len_coder, layout.len_coder)
    idx = jnp.where(phase == PH_LENCHOICE, len_base + layout.len_choice, idx)
    idx = jnp.where(phase == PH_LENCHOICE2, len_base + layout.len_choice2, idx)
    idx = jnp.where(phase == PH_TREE, st["tree_base"] + sym, idx)
    idx = jnp.where(phase == PH_REV, st["rev_base"] + st["rev_m"], idx)
    is_adaptive = (phase <= PH_TREE) | (phase == PH_REV)
    is_direct = phase == PH_DIRECT
    return idx, is_adaptive, is_direct, is_adaptive | is_direct


def _bit_decode(rng, code, prob, is_adaptive, is_direct):
    """Uniform range-decoder step (adaptive + direct, masked).

    Returns (bit, new_rng, new_code, new_prob); renormalization is the
    caller's job (it needs the input stream).
    """
    bound = (rng >> 11) * prob.astype(_U32)
    bit_a = (code >= bound).astype(_I32)
    new_rng_a = jnp.where(bit_a == 0, bound, rng - bound)
    new_code_a = jnp.where(bit_a == 0, code, code - bound)
    new_prob = jnp.where(
        bit_a == 0, prob + ((2048 - prob) >> 5), prob - (prob >> 5)
    )
    rng_d = rng >> 1
    t = ((code - rng_d) >> 31).astype(_I32)        # 1 when code < range
    bit_d = 1 - t
    new_code_d = jnp.where(bit_d == 1, code - rng_d, code)
    bit = jnp.where(is_direct, bit_d, bit_a)
    new_rng = jnp.where(is_direct, rng_d, jnp.where(is_adaptive, new_rng_a, rng))
    new_code = jnp.where(is_direct, new_code_d, jnp.where(is_adaptive, new_code_a, code))
    return bit, new_rng, new_code, new_prob


def _transition(st, bit, prev_byte, back_byte, out_sizes, dict_check,
                layout, lc, lp, pb, pos_base=0):
    """FSM transition: next register file plus this iteration's output byte.

    prev_byte = out[out_pos-1]; back_byte = out[out_pos-rep0-1] (serves both
    the matched-literal predictor and the match-copy read).  st must already
    carry the post-renormalization in_pos/overrun.  `pos_base` = primed
    preset prefix length (position contexts count coded bytes only; the
    window itself — prev/back bytes, distance checks — is absolute, so the
    primed prefix is reachable).  Returns (new_st, emit, emit_byte): lanes
    with emit write emit_byte at out_pos.
    """
    phase = st["phase"]
    out_pos = st["out_pos"]
    coded_pos = out_pos - pos_base if pos_base else out_pos
    pos_state = coded_pos & ((1 << pb) - 1)
    lit_pos_mask = (1 << lp) - 1
    state = st["state"]
    sym = st["sym"]
    match_bit = (st["mb"] >> 7) & 1
    len_base = jnp.where(st["tree_kind"] == TK_LEN_REP, layout.rep_len_coder, layout.len_coder)

    nphase = phase
    nstate = state
    nsym = sym
    nlit_base = st["lit_base"]
    nmb = st["mb"]
    nrep0, nrep1, nrep2, nrep3 = st["rep0"], st["rep1"], st["rep2"], st["rep3"]
    ntree_base, ntree_top, ntree_kind = st["tree_base"], st["tree_top"], st["tree_kind"]
    nrev_base, nrev_sym, nrev_i, nrev_n = st["rev_base"], st["rev_sym"], st["rev_i"], st["rev_n"]
    nrev_kind, nrev_m = st["rev_kind"], st["rev_m"]
    nacc, nbits_left, ndist_base = st["acc"], st["bits_left"], st["dist_base"]
    nlength = st["length"]
    nout_pos = out_pos

    lit_sub = layout.literal + (
        ((coded_pos & lit_pos_mask) << lc) + (prev_byte >> (8 - lc))
    ) * LITERAL_CODER_SIZE

    # --- PH_ISMATCH ---
    p = phase == PH_ISMATCH
    to_lit = p & (bit == 0)
    nphase = jnp.where(to_lit & (state < 7), PH_LIT, nphase)
    nphase = jnp.where(to_lit & (state >= 7), PH_LITM, nphase)
    nsym = jnp.where(to_lit, 1, nsym)
    nlit_base = jnp.where(to_lit, lit_sub, nlit_base)
    nmb = jnp.where(to_lit, back_byte, nmb)
    nphase = jnp.where(p & (bit == 1), PH_ISREP, nphase)

    # --- PH_LIT / PH_LITM tree walk ---
    p_lit = phase == PH_LIT
    p_litm = phase == PH_LITM
    new_sym_l = (sym << 1) | bit
    lit_done = (p_lit | p_litm) & (new_sym_l >= 0x100)
    # matched mode: on mismatch drop to normal mode
    mism = p_litm & (match_bit != bit) & (new_sym_l < 0x100)
    nphase = jnp.where(mism, PH_LIT, nphase)
    nmb = jnp.where(p_litm, (st["mb"] << 1) & 0xFF, nmb)
    nsym = jnp.where(p_lit | p_litm, new_sym_l, nsym)
    lit_byte = new_sym_l & 0xFF
    nout_pos = jnp.where(lit_done, out_pos + 1, nout_pos)
    nstate = jnp.where(lit_done, _next_lit(state), nstate)
    nphase = jnp.where(lit_done, PH_ISMATCH, nphase)

    # --- PH_ISREP ---
    p = phase == PH_ISREP
    fresh = p & (bit == 0)          # fresh match: shift rep history now
    nrep3 = jnp.where(fresh, st["rep2"], nrep3)
    nrep2 = jnp.where(fresh, st["rep1"], nrep2)
    nrep1 = jnp.where(fresh, st["rep0"], nrep1)
    nphase = jnp.where(fresh, PH_LENCHOICE, nphase)
    ntree_kind = jnp.where(fresh, TK_LEN_MATCH, ntree_kind)
    nphase = jnp.where(p & (bit == 1), PH_ISREPG0, nphase)

    # --- PH_ISREPG0 ---
    p = phase == PH_ISREPG0
    nphase = jnp.where(p & (bit == 0), PH_ISREP0LONG, nphase)
    nphase = jnp.where(p & (bit == 1), PH_ISREPG1, nphase)

    # --- PH_ISREP0LONG ---
    p = phase == PH_ISREP0LONG
    srep = p & (bit == 0)           # short rep: copy 1 byte at rep0
    nstate = jnp.where(srep, _next_shortrep(state), nstate)
    nlength = jnp.where(srep, 1, nlength)
    nphase = jnp.where(srep, PH_COPY, nphase)
    longrep = p & (bit == 1)
    nphase = jnp.where(longrep, PH_LENCHOICE, nphase)
    ntree_kind = jnp.where(longrep, TK_LEN_REP, ntree_kind)

    # --- PH_ISREPG1 ---
    p = phase == PH_ISREPG1
    g1 = p & (bit == 0)
    nrep1 = jnp.where(g1, st["rep0"], nrep1)
    nrep0 = jnp.where(g1, st["rep1"], nrep0)
    nphase = jnp.where(g1, PH_LENCHOICE, nphase)
    ntree_kind = jnp.where(g1, TK_LEN_REP, ntree_kind)
    nphase = jnp.where(p & (bit == 1), PH_ISREPG2, nphase)

    # --- PH_ISREPG2 ---
    p = phase == PH_ISREPG2
    g2 = p & (bit == 0)
    g3 = p & (bit == 1)
    nrep0 = jnp.where(g2, st["rep2"], nrep0)
    nrep0 = jnp.where(g3, st["rep3"], nrep0)
    nrep3 = jnp.where(g3, st["rep2"], nrep3)
    nrep2 = jnp.where(g2 | g3, st["rep1"], nrep2)
    nrep1 = jnp.where(g2 | g3, st["rep0"], nrep1)
    nphase = jnp.where(p, PH_LENCHOICE, nphase)
    ntree_kind = jnp.where(p, TK_LEN_REP, ntree_kind)

    # --- PH_LENCHOICE ---
    p = phase == PH_LENCHOICE
    low = p & (bit == 0)
    nphase = jnp.where(low, PH_TREE, nphase)
    ntree_base = jnp.where(low, len_base + layout.len_low + (pos_state << 3), ntree_base)
    ntree_top = jnp.where(low, 8, ntree_top)
    nsym = jnp.where(low, 1, nsym)
    nacc = jnp.where(low, 0, nacc)   # acc reused as len band offset
    nphase = jnp.where(p & (bit == 1), PH_LENCHOICE2, nphase)

    # --- PH_LENCHOICE2 ---
    p = phase == PH_LENCHOICE2
    mid = p & (bit == 0)
    high = p & (bit == 1)
    nphase = jnp.where(p, PH_TREE, nphase)
    ntree_base = jnp.where(mid, len_base + layout.len_mid + (pos_state << 3), ntree_base)
    ntree_top = jnp.where(mid, 8, ntree_top)
    nacc = jnp.where(mid, 8, nacc)
    ntree_base = jnp.where(high, len_base + layout.len_high, ntree_base)
    ntree_top = jnp.where(high, 256, ntree_top)
    nacc = jnp.where(high, 16, nacc)
    nsym = jnp.where(p, 1, nsym)

    # --- PH_TREE (len trees and pos_slot share this) ---
    p = phase == PH_TREE
    new_m = (sym << 1) | bit
    tree_done = p & (new_m >= st["tree_top"])
    nsym = jnp.where(p, new_m, nsym)
    tree_symbol = new_m - st["tree_top"]

    # length decoded (match or rep)
    len_done = tree_done & (st["tree_kind"] != TK_POS_SLOT)
    decoded_len = st["acc"] + tree_symbol + 2
    nlength = jnp.where(len_done, decoded_len, nlength)
    # rep length -> start copy at rep0
    rep_len_done = len_done & (st["tree_kind"] == TK_LEN_REP)
    nstate = jnp.where(rep_len_done, _next_longrep(state), nstate)
    nphase = jnp.where(rep_len_done, PH_COPY, nphase)
    # match length -> pos_slot tree (ctx by len_to_pos_state)
    mat_len_done = len_done & (st["tree_kind"] == TK_LEN_MATCH)
    lps = jnp.minimum(decoded_len - 2, 3)
    nstate = jnp.where(mat_len_done, _next_match(state), nstate)
    nphase = jnp.where(mat_len_done, PH_TREE, nphase)
    ntree_base = jnp.where(mat_len_done, layout.pos_slot + lps * POS_SLOT_TREE_SIZE, ntree_base)
    ntree_top = jnp.where(mat_len_done, 64, ntree_top)
    ntree_kind = jnp.where(mat_len_done, TK_POS_SLOT, ntree_kind)
    nsym = jnp.where(mat_len_done, 1, nsym)

    # pos_slot decoded
    slot_done = tree_done & (st["tree_kind"] == TK_POS_SLOT)
    slot = tree_symbol
    small = slot_done & (slot < 4)
    nrep0 = jnp.where(small, slot, nrep0)
    nphase = jnp.where(small, PH_COPY, nphase)
    big = slot_done & (slot >= 4)
    direct_bits = (slot >> 1) - 1
    base_dist = (2 | (slot & 1)) << jnp.minimum(direct_bits, 30)
    ndist_base = jnp.where(big, base_dist, ndist_base)
    spec = big & (slot < 14)
    nphase = jnp.where(spec, PH_REV, nphase)
    nrev_base = jnp.where(spec, layout.spec_pos + base_dist - slot - 1, nrev_base)
    nrev_n = jnp.where(spec, direct_bits, nrev_n)
    nrev_i = jnp.where(spec, 0, nrev_i)
    nrev_sym = jnp.where(spec, 0, nrev_sym)
    nrev_m = jnp.where(spec, 1, nrev_m)
    nrev_kind = jnp.where(spec, RK_SPEC, nrev_kind)
    huge = big & (slot >= 14)
    nphase = jnp.where(huge, PH_DIRECT, nphase)
    nbits_left = jnp.where(huge, direct_bits - 4, nbits_left)
    nacc = jnp.where(huge, 0, nacc)

    # --- PH_DIRECT ---
    p = phase == PH_DIRECT
    nacc = jnp.where(p, (st["acc"] << 1) | bit, nacc)
    nbits_left = jnp.where(p, st["bits_left"] - 1, nbits_left)
    dir_done = p & (st["bits_left"] == 1)
    nphase = jnp.where(dir_done, PH_REV, nphase)
    nrev_base = jnp.where(dir_done, layout.align, nrev_base)
    nrev_n = jnp.where(dir_done, 4, nrev_n)
    nrev_i = jnp.where(dir_done, 0, nrev_i)
    nrev_sym = jnp.where(dir_done, 0, nrev_sym)
    nrev_m = jnp.where(dir_done, 1, nrev_m)
    nrev_kind = jnp.where(dir_done, RK_ALIGN, nrev_kind)

    # --- PH_REV ---
    p = phase == PH_REV
    nrev_m = jnp.where(p, (st["rev_m"] << 1) | bit, nrev_m)
    nrev_sym = jnp.where(p, st["rev_sym"] | (bit << st["rev_i"]), nrev_sym)
    nrev_i = jnp.where(p, st["rev_i"] + 1, nrev_i)
    rev_done = p & (st["rev_i"] == st["rev_n"] - 1)
    rev_val = st["rev_sym"] | (bit << st["rev_i"])
    spec_done = rev_done & (st["rev_kind"] == RK_SPEC)
    nrep0 = jnp.where(spec_done, st["dist_base"] + rev_val, nrep0)
    align_done = rev_done & (st["rev_kind"] == RK_ALIGN)
    dist_full = st["dist_base"] + (st["acc"] << 4) + rev_val
    nrep0 = jnp.where(align_done, dist_full, nrep0)
    nphase = jnp.where(rev_done, PH_COPY, nphase)
    # EOS-terminated lanes carry NEGATIVE out_sizes (-buffer bound): the
    # end marker dist==-1 completes them (Decoder.java:277-283); with a
    # known size — or any other negative distance — it is corruption
    eos = out_sizes < 0
    bound = jnp.abs(out_sizes)
    marker = align_done & (dist_full == -1) & eos
    bad_dist = align_done & (dist_full < 0) & ~marker
    nphase = jnp.where(bad_dist, PH_ERROR, nphase)

    # distance validity on entering copy (fresh match only; reps were valid)
    entering = (nphase == PH_COPY) & (phase != PH_COPY)
    bad = entering & ~marker & ((nrep0 >= nout_pos) | (nrep0 >= dict_check))
    nphase = jnp.where(bad, PH_ERROR, nphase)
    nphase = jnp.where(marker, PH_DONE, nphase)

    # --- PH_COPY: one byte per iteration ---
    p = phase == PH_COPY
    nout_pos = jnp.where(p, out_pos + 1, nout_pos)
    nlength = jnp.where(p, st["length"] - 1, nlength)
    nphase = jnp.where(p & (st["length"] == 1), PH_ISMATCH, nphase)

    # --- the byte this iteration emits (literal or copy) ---
    emit = lit_done | p
    emit_byte = jnp.where(lit_done, lit_byte, back_byte)

    # --- completion / error ---
    nphase = jnp.where(nout_pos > bound, PH_ERROR, nphase)  # overran size/cap
    done = ~eos & (nout_pos >= bound) & (nphase == PH_ISMATCH)
    nphase = jnp.where(done, PH_DONE, nphase)
    # applied last, so a lane only reaches PH_DONE with overrun <= 40 and
    # a finished lane (which consumes no more input) never flips
    nphase = jnp.where(st["overrun"] > 40, PH_ERROR, nphase)

    st2 = dict(
        phase=nphase, state=nstate,
        rep0=nrep0, rep1=nrep1, rep2=nrep2, rep3=nrep3,
        sym=nsym, lit_base=nlit_base, mb=nmb,
        tree_base=ntree_base, tree_top=ntree_top, tree_kind=ntree_kind,
        rev_base=nrev_base, rev_sym=nrev_sym, rev_i=nrev_i, rev_n=nrev_n,
        rev_kind=nrev_kind, rev_m=nrev_m,
        acc=nacc, bits_left=nbits_left, dist_base=ndist_base,
        length=nlength, out_pos=nout_pos, in_pos=st["in_pos"],
        overrun=st["overrun"],
    )
    return st2, emit, emit_byte


@partial(jax.jit, static_argnames=("lc", "lp", "pb", "max_out", "max_iters"))
def decode_fsm_xla(comp, comp_lens, out_sizes, dict_size, lc, lp, pb, max_out,
                   max_iters=0, preset=None):
    """Decode N padded streams as a lax.while_loop — the plain reference
    of the Triton kernel.  comp: (N, max_in) u8.  Returns (out, ok,
    iters, out_pos).

    `preset` ((P,) u8 or None) primes every lane's output window with a
    shared dictionary (LZTB v2): the window starts at P, out_sizes must
    then be the ABSOLUTE end positions (P + coded size), and the decoded
    payload sits at out[:, P:].  On a mesh, this replicated array is
    exactly the broadcast the scaling design calls for — XLA moves it to
    every device.
    """
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    n_lanes, max_in = comp.shape
    lanes = jnp.arange(n_lanes)
    pos_base = 0 if preset is None else preset.shape[0]

    probs0 = jnp.full((n_lanes, layout.size), 1024, dtype=_I32)
    out0 = jnp.zeros((n_lanes, max_out), dtype=_U8)
    if pos_base:
        out0 = out0.at[:, :pos_base].set(preset[None, :].astype(_U8))

    # --- range decoder init: code = 5 big-endian header bytes ---
    code0 = jnp.zeros((n_lanes,), dtype=_U32)
    for i in range(5):
        byte = jnp.where(i < comp_lens, comp[:, i].astype(_I32), 0)
        code0 = (code0 << 8) | byte.astype(_U32)
    range0 = jnp.full((n_lanes,), 0xFFFFFFFF, dtype=_U32)

    st = _state_struct(n_lanes)
    if pos_base:
        st["out_pos"] = jnp.full((n_lanes,), pos_base, dtype=_I32)
        prev0 = jnp.full((n_lanes,), 1, dtype=_I32) * preset[-1].astype(_I32)
    else:
        prev0 = jnp.zeros((n_lanes,), dtype=_I32)
    dict_check = jnp.maximum(dict_size, 1)

    def cond(carry):
        st, probs, out, rng, code, iters, prev = carry
        active = (st["phase"] != PH_DONE) & (st["phase"] != PH_ERROR)
        if max_iters:
            return jnp.any(active) & (iters < max_iters)
        return jnp.any(active)

    def body(carry):
        st, probs, out, rng, code, iters, prev = carry
        out_pos = st["out_pos"]

        # 1. context index + uniform bit decode (shared select networks)
        idx, is_adaptive, is_direct, consumes_bit = _ctx_index(
            st, layout, pb, pos_base)
        prob = jnp.take_along_axis(probs, idx[:, None], axis=1)[:, 0]
        bit, new_rng, new_code, new_prob = _bit_decode(rng, code, prob, is_adaptive, is_direct)
        probs = probs.at[lanes, jnp.where(is_adaptive, idx, 0)].set(
            jnp.where(is_adaptive, new_prob, probs[:, 0])
        )

        # 2. renormalize from the input stream
        need = (new_rng < _TOP) & consumes_bit
        in_pos = st["in_pos"]
        safe_ip = jnp.minimum(in_pos, max_in - 1)
        next_byte = jnp.where(in_pos < comp_lens, comp[lanes, safe_ip].astype(_I32), 0)
        overrun = st["overrun"] + jnp.where(need & (in_pos >= comp_lens), 1, 0)
        new_rng = jnp.where(need, new_rng << 8, new_rng)
        new_code = jnp.where(need, (new_code << 8) | next_byte.astype(_U32), new_code)
        in_pos = jnp.where(need, in_pos + 1, in_pos)
        st = dict(st, in_pos=in_pos, overrun=overrun)

        # 3. FSM transition (shared) + this iteration's output byte.  The
        # literal-context previous byte is always the last byte written
        # (match copies emit one byte per iteration too), so it rides the
        # loop carry instead of a per-iteration window gather.
        back_byte = out[lanes, jnp.clip(out_pos - st["rep0"] - 1, 0, max_out - 1)].astype(_I32)
        st2, emit, emit_byte = _transition(
            st, bit, prev, back_byte, out_sizes, dict_check,
            layout, lc, lp, pb, pos_base)
        write_idx = jnp.where(emit, jnp.minimum(out_pos, max_out - 1), max_out)
        out = out.at[lanes, write_idx].set(emit_byte.astype(_U8), mode="drop")
        prev2 = jnp.where(emit, emit_byte, prev)
        return (st2, probs, out, new_rng, new_code, iters + 1, prev2)

    carry = (st, probs0, out0, range0, code0, jnp.int32(0), prev0)
    st, probs, out, rng, code, iters, _prev = jax.lax.while_loop(cond, body, carry)
    ok = st["phase"] == PH_DONE
    return out, ok, iters, st["out_pos"]


def decode_batch(streams, params: LzmaParams, out_sizes, max_out=None,
                 max_iters=0, preset: bytes = b""):
    """Decode a list of raw LZMA streams lane-parallel on device.

    streams: list of bytes (one per lane).  out_sizes: list of known
    uncompressed sizes (coded bytes only); a NEGATIVE entry -cap marks an
    EOS-TERMINATED stream of unknown size (Decoder.java:219,277-283):
    the lane decodes until the end marker, erroring past `cap` bytes.
    `preset` primes every lane's window with the same shared dictionary
    (LZTB v2 blocks 1..n).  Returns list of bytes.
    """
    n = len(streams)
    if n == 0:
        return []
    if any(abs(sz) >= 2**31 for sz in out_sizes):
        # int32 lane sizes on device; a forged claim must be a clean
        # decode error, not a numpy OverflowError
        raise CorruptStreamError("output size exceeds device decoder range")
    if any(sz == 0 for sz in out_sizes):
        # the FSM always decodes at least one symbol before its done
        # check, so zero-output lanes (empty streams) short-circuit here
        keep = [i for i, sz in enumerate(out_sizes) if sz != 0]
        redone = decode_batch([streams[i] for i in keep], params,
                              [out_sizes[i] for i in keep],
                              max_out=max_out, max_iters=max_iters,
                              preset=preset)
        redo = dict(zip(keep, redone))
        return [redo.get(i, b"") for i in range(n)]
    plen = len(preset)
    max_in = max(max(len(s) for s in streams), 16)
    max_in = 1 << (max_in - 1).bit_length()  # pow2 bucket: stable jit shapes
    comp = np.zeros((n, max_in), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, s in enumerate(streams):
        comp[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        lens[i] = len(s)
    caps = [abs(sz) for sz in out_sizes]
    mo = int(max_out if max_out is not None else max(caps)) + plen
    mo = 1 << (max(mo, 16) - 1).bit_length()
    # absolute end positions (preset included), sign marking EOS lanes
    abs_sizes = np.asarray(
        [sz + plen if sz > 0 else sz - plen for sz in out_sizes],
        dtype=np.int32)
    out, ok, _, out_pos = kernels.for_platform().decode_fsm(
        jnp.asarray(comp),
        jnp.asarray(lens),
        jnp.asarray(abs_sizes),
        np.int64(min(params.dict_size, 2**31 - 1)),
        params.lc,
        params.lp,
        params.pb,
        mo,
        max_iters,
        preset=(jnp.asarray(np.frombuffer(preset, dtype=np.uint8))
                if plen else None),
    )
    out = np.asarray(out)
    ok = np.asarray(ok)
    out_pos = np.asarray(out_pos)
    results = []
    for i in range(n):
        if not ok[i]:
            if out_sizes[i] < 0 and int(out_pos[i]) > caps[i] + plen - 273:
                # the lane ran out of cap, not out of stream: the output
                # cursor reached the buffer bound (within one match of
                # it) without a decode error
                raise CapExceededError(
                    f"EOS lane {i} exceeded its {caps[i]}-byte cap")
            # same exception type as the scalar/native backends so
            # cross-backend callers need one except clause
            raise CorruptStreamError(f"device decode failed for lane {i}")
        end = out_sizes[i] + plen if out_sizes[i] > 0 else int(out_pos[i])
        results.append(out[i, plen:end].tobytes())
    return results
