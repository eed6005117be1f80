"""Lane-parallel LZMA encoder: parse and bits in parallel, serialize minimal.

The insight that makes LZMA encoding lane-parallel: once the parse (token
stream) is fixed, the exact (context, bit) sequence fed to the range coder
is FULLY DETERMINED — adaptive probabilities affect the emitted BYTES, not
which bits go to which contexts.  So the encoder splits into:

  A. parallel tokenization            (ops/device_matcher.py — sort-based)
  B. token classification scan        (tiny lax.scan: LZMA state machine +
                                       rep-distance MTF per token)
  C. bit lowering                     (fully vectorized: every token's
                                       (ctx, bit) pairs via closed-form
                                       bit-tree prefixes, scattered into a
                                       flat per-lane bit stream)
  D. range-coder serialization        (the only serial phase: one
                                       (ctx,bit) per lane per step — a
                                       Pallas-Triton kernel on a GPU
                                       (ops/triton_serializer.py), the
                                       lax.while_loop serialize_xla
                                       elsewhere)

The reference interleaves all four in one sequential loop
(Encoder.java:843-1024); here 3 of 4 phases are data-parallel.  Output is
valid LZMA — decodable by the scalar/native/device decoders and by stock
liblzma (tests/test_device_encoder.py).

Carry handling in D without 64-bit ints: `low` is a (u32, carry-flag)
pair; the pending-0xFF run of the reference's shiftLow
(RangeEncoder.java:73-87) becomes a drain counter that stalls bit
consumption while emitting one filler byte per iteration.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.layout import (
    LITERAL_CODER_SIZE,
    POS_SLOT_TREE_SIZE,
    ProbLayout,
)
from ..format.properties import LzmaParams
from . import kernels
from .device_matcher import tokenize

# closed-form 12-state transitions (validated against the NEXT_STATE_*
# tables in device_decoder) — no module-level jnp constants, which would
# initialize the XLA backend at import and break jax.distributed setup
from .device_decoder import _next_lit, _next_longrep, _next_match  # noqa: E402

K_LIT = 0
K_MATCH = 1
K_REP = 2

#: sort-neighbor candidate tiers per position — the measured ratio knee
#: (DESIGN-NOTES.md "Ratio knees").  Every device encode entry point
#: (encode_lanes, encode_batch, hybrid, mesh) shares THIS default so all
#: paths tokenize identically.
DEFAULT_NUM_CANDIDATES = 4

def clamp_fb(fast_bytes: int) -> int:
    """The device tokenizer honors the reference's full fast-bytes range
    5..273 (Encoder.java:1148-1154): fb is a STATIC bound on the lane
    tokenizer's candidate-compare loop (device_matcher.find_best_matches
    runs fb compare rounds, then the K-free extension to the 273 cap), so
    any requested depth compiles — the historical 64 cap (round 1-3) is
    gone.  Kept as the one validation point for every device entry."""
    fb = int(fast_bytes)
    if not 5 <= fb <= 273:
        raise ValueError(f"fast_bytes must be in 5..273, got {fb}")
    return fb

MAXB = 50          # bits-with-context per token, upper bound
CTX_DIRECT = -1    # sentinel ctx: equiprobable direct bit

#: wire-distance sentinel marking the end-of-stream marker token: a match
#: with len=2 and distance 0xFFFFFFFF (posSlot 63, 26 one direct bits,
#: align 15 — WriteEndMarker, Encoder.java:818-835).  Literals use -1,
#: real matches >= 0.
EOS_DIST = -2


# ---------------------------------------------------------------- phase B
@jax.jit
def classify_tokens(data, t_pos, t_len, t_dist, t_valid):
    """LZMA state machine + rep MTF over the token stream (lax.scan).

    data: (N, max_n) u8; token arrays (N, T).  Returns per-token int32
    arrays: kind, rep_idx, state_before, match_mode, match_byte, prev_byte,
    lit_byte.
    """
    N, T = t_pos.shape
    lanes = jnp.arange(N)
    max_n = data.shape[1]

    def step(carry, tok):
        state, r0, r1, r2, r3 = carry
        pos, ln, dist, valid = tok
        # EOS_DIST is a MATCH (the end marker), not a literal
        is_lit = (dist < 0) & (dist != EOS_DIST)

        prev_byte = jnp.where(
            pos > 0, data[lanes, jnp.maximum(pos - 1, 0)].astype(jnp.int32), 0
        )
        lit_byte = data[lanes, jnp.minimum(pos, max_n - 1)].astype(jnp.int32)
        match_mode = ((state >= 7) & is_lit).astype(jnp.int32)
        mb_idx = jnp.clip(pos - r0 - 1, 0, max_n - 1)
        match_byte = data[lanes, mb_idx].astype(jnp.int32)

        is_r0 = (~is_lit) & (dist == r0)
        is_r1 = (~is_lit) & (~is_r0) & (dist == r1)
        is_r2 = (~is_lit) & (~is_r0) & (~is_r1) & (dist == r2)
        is_r3 = (~is_lit) & (~is_r0) & (~is_r1) & (~is_r2) & (dist == r3)
        is_rep = is_r0 | is_r1 | is_r2 | is_r3
        is_match = (~is_lit) & (~is_rep)
        rep_idx = jnp.where(is_r0, 0, jnp.where(is_r1, 1, jnp.where(is_r2, 2, 3)))
        kind = jnp.where(is_lit, K_LIT, jnp.where(is_rep, K_REP, K_MATCH))

        # rep-distance MTF (Encoder.java:969-973, 1001-1003)
        n0 = jnp.where(
            is_match, dist,
            jnp.where(is_r1, r1, jnp.where(is_r2, r2, jnp.where(is_r3, r3, r0))),
        )
        n1 = jnp.where(is_match | is_r1 | is_r2 | is_r3, r0, r1)
        n2 = jnp.where(is_match | is_r2 | is_r3, r1, r2)
        n3 = jnp.where(is_match | is_r3, r2, r3)
        # shortRep (len-1 rep0) has its own state transition (Base.java:30)
        is_srep = is_rep & (ln < 2)
        new_state = jnp.where(
            is_lit, _next_lit(state),
            jnp.where(is_srep, jnp.where(state < 7, 9, 11),
                      jnp.where(is_rep, _next_longrep(state),
                                _next_match(state)))
        )
        out = (kind, rep_idx, state, match_mode, match_byte, prev_byte, lit_byte)
        state = jnp.where(valid, new_state, state)
        r0 = jnp.where(valid, n0, r0)
        r1 = jnp.where(valid, n1, r1)
        r2 = jnp.where(valid, n2, r2)
        r3 = jnp.where(valid, n3, r3)
        return (state, r0, r1, r2, r3), out

    z = jnp.zeros((N,), dtype=jnp.int32)
    toks = tuple(
        jnp.moveaxis(a, 1, 0)
        for a in (t_pos, t_len, t_dist, t_valid.astype(jnp.int32) > 0)
    )
    _, outs = jax.lax.scan(step, (z, z, z, z, z), toks)
    return tuple(jnp.moveaxis(o, 0, 1) for o in outs)


# ---------------------------------------------------------------- phase C
def _bitrev_low(v, k_vec, width):
    """Reverse the low k bits of v (k <= width), vectorized over arrays."""
    out = jnp.zeros_like(v)
    for j in range(width):
        bit = (v >> j) & 1
        shift = jnp.maximum(k_vec - 1 - j, 0)
        out = out | jnp.where(j < k_vec, bit << shift, 0)
    return out


@partial(jax.jit, static_argnames=("lc", "lp", "pb", "max_bits", "pos_base"))
def lower_tokens(data, meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb,
                 max_bits, pos_base=0):
    """Expand tokens into (ctx, bit) pairs scattered into flat per-lane
    streams.  `pos_base` shifts position contexts when the window is
    primed with a preset dictionary (token positions are absolute; coded
    positions start at pos_base).  Returns ctx (N,max_bits),
    bit (N,max_bits), total (N,)."""
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    kind, rep_idx, state, match_mode, match_byte, prev_byte, lit_byte = meta
    N, T = t_pos.shape
    lanes2 = jnp.arange(N)[:, None]
    coded_pos = t_pos - pos_base if pos_base else t_pos
    pos_state = coded_pos & ((1 << pb) - 1)
    valid = t_valid & True

    is_lit = kind == K_LIT
    is_match = kind == K_MATCH
    is_rep = kind == K_REP

    # ---- per-token geometry ----
    l_sym = jnp.maximum(t_len - 2, 0)
    dlen = jnp.where(l_sym < 8, 4, jnp.where(l_sym < 16, 5, 10))
    rbits = jnp.where(rep_idx < 2, 2, 3)
    # shortRep (len-1 rep0): is_match, is_rep, g0=0, rep0_long=0 — no
    # length or distance bits (Encoder.java:952-957)
    srep = is_rep & (t_len < 2)

    # the EOS marker's wire distance is 0xFFFFFFFF == int32 -1: slot 63,
    # footer 30; base_val wraps negative in int32 and the subtraction
    # below recovers reduced == 0x3FFFFFFF exactly (two's complement)
    is_eos = t_dist == EOS_DIST
    dist = jnp.where(is_eos, jnp.int32(-1), jnp.maximum(t_dist, 0))
    nb = 31 - jax.lax.clz(jnp.where(is_eos, dist, jnp.maximum(dist, 1)))
    slot = jnp.where(dist < 4, dist, (nb << 1) | ((dist >> jnp.maximum(nb - 1, 0)) & 1))
    slot = jnp.where(is_eos, 63, slot)
    footer = jnp.maximum((slot >> 1) - 1, 0)
    base_val = (2 | (slot & 1)) << footer
    reduced = dist - base_val
    spec = is_match & (slot >= 4) & (slot < 14)
    huge = is_match & (slot >= 14)
    tail_bits = jnp.where(spec, footer, jnp.where(huge, footer, 0))  # direct+align == footer

    # segment start offsets (within token)
    lit_s = 1                       # literal bits after is_match
    isrep_s = 1
    repsel_s = 2                    # rep selector bits
    len_s = jnp.where(is_rep, 2 + rbits, 2)
    slot_s = len_s + dlen           # match only
    tail_s = slot_s + 6

    nbits = jnp.where(
        is_lit, 9, jnp.where(is_rep, len_s + dlen, tail_s + tail_bits)
    )
    nbits = jnp.where(srep, 4, nbits)
    nbits = jnp.where(valid, nbits, 0)

    # flat destination offsets
    base_off = jnp.cumsum(nbits, axis=1) - nbits   # exclusive prefix sum per lane
    total = jnp.sum(nbits, axis=1)

    # ---- shared ctx components ----
    L = layout
    im_ctx = L.is_match + (state << L.pos_bits) + pos_state
    lit_sub = L.literal + (
        ((coded_pos & ((1 << lp) - 1)) << lc) + (prev_byte >> (8 - lc))
    ) * LITERAL_CODER_SIZE
    len_base = jnp.where(is_rep, L.rep_len_coder, L.len_coder)
    lps = jnp.minimum(t_len - 2, 3)
    slot_tree = L.pos_slot + lps * POS_SLOT_TREE_SIZE
    x = lit_byte ^ match_byte  # matched-literal prefix-equality word

    # band-specific length-tree values
    len_lo_v = l_sym
    len_mid_v = l_sym - 8
    len_hi_v = l_sym - 16
    band = jnp.where(l_sym < 8, 0, jnp.where(l_sym < 16, 1, 2))
    band_bits = jnp.where(band == 2, 8, 3)
    band_v = jnp.where(band == 0, len_lo_v, jnp.where(band == 1, len_mid_v, len_hi_v))
    band_tree = jnp.where(
        band == 0, len_base + L.len_low + (pos_state << 3),
        jnp.where(band == 1, len_base + L.len_mid + (pos_state << 3), len_base + L.len_high),
    )
    choice_bits = jnp.where(band == 0, 1, 2)

    # ---- split emission (round 5: the 50-slot loop over ALL tokens was
    # the stats phase's dominant scatter volume).  SHORT tokens
    # (literal: 9 bits; shortRep: 4 bits) finish within slots 0..8 and
    # run over the full token buffer; LONG tokens (len >= 2 matches and
    # reps, so provably <= T/2 + 1 per lane) are COMPACTED into a
    # half-width buffer and their full slot range runs there, bounded
    # dynamically by the realized max bit count.  Destinations are
    # disjoint by token, so the two passes write exactly the stream the
    # single loop wrote. ----
    F_full = dict(
        nbits=nbits, base_off=base_off, is_lit=is_lit, is_rep=is_rep,
        is_match=is_match, srep=srep, im_ctx=im_ctx, lit_sub=lit_sub,
        lit_byte=lit_byte, match_byte=match_byte, x=x,
        match_mode=match_mode, state=state, pos_state=pos_state,
        rep_idx=rep_idx, rbits=rbits, len_s=len_s, dlen=dlen, band=band,
        band_v=band_v, band_bits=band_bits, band_tree=band_tree,
        choice_bits=choice_bits, len_base=len_base, slot=slot,
        slot_tree=slot_tree, slot_s=slot_s, tail_s=tail_s, spec=spec,
        huge=huge, footer=footer, reduced=reduced, base_val=base_val,
    )

    def make_body(F, cls, width, short_side):
        """short_side=True: literal + shortRep tokens only (slots 0..8 —
        the length/pos_slot/distance sections can never fire and are
        omitted from the graph); False: len>=2 tokens only (the literal
        section is omitted; is_lit is identically False)."""

        def slot_body(t, ctx_out):
            """Emit bit-slot t of every class-selected token."""
            in_tok = (t < F["nbits"]) & cls
            ctx_t = jnp.zeros((N, width), dtype=jnp.int32)
            bit_t = jnp.zeros((N, width), dtype=jnp.int32)
            is_lit = F["is_lit"] if short_side else jnp.zeros(
                (N, width), bool)

            # -- slot 0: is_match bit --
            sel = in_tok & (t == 0)
            ctx_t = jnp.where(sel, F["im_ctx"], ctx_t)
            bit_t = jnp.where(sel, jnp.where(is_lit, 0, 1), bit_t)

            if short_side:
                # -- literal bits (k = t-1 in 0..7; closed forms at k=0) --
                k = jnp.clip(t - 1, 0, 7)
                sel = in_tok & is_lit & (t >= 1)
                m = (1 << k) | (F["lit_byte"] >> (8 - k))
                b = (F["lit_byte"] >> (7 - k)) & 1
                prefix_eq = (F["x"] >> (8 - k)) == 0
                mbit = (F["match_byte"] >> (7 - k)) & 1
                use_matched = (F["match_mode"] > 0) & prefix_eq
                c = F["lit_sub"] + jnp.where(
                    use_matched, ((1 + mbit) << 8) + m, m)
                ctx_t = jnp.where(sel, c, ctx_t)
                bit_t = jnp.where(sel, b, bit_t)

            # -- is_rep bit (match/rep slot 1) --
            sel = in_tok & (~is_lit) & (t == 1)
            ctx_t = jnp.where(sel, L.is_rep + F["state"], ctx_t)
            bit_t = jnp.where(sel, jnp.where(F["is_rep"], 1, 0), bit_t)

            # -- rep selector bits: r0 -> [g0=0, rep0long=1]; r1 -> [1,0];
            #    r2 -> [1,1,0]; r3 -> [1,1,1] --
            kk = t - repsel_s
            sel = in_tok & F["is_rep"] & (kk >= 0) & (kk < F["rbits"])
            c1 = jnp.where(
                F["rep_idx"] == 0,
                L.is_rep0_long + (F["state"] << L.pos_bits) + F["pos_state"],
                L.is_rep_g1 + F["state"],
            )
            b1v = jnp.where(F["rep_idx"] == 0, jnp.where(F["srep"], 0, 1),
                            jnp.where(F["rep_idx"] == 1, 0, 1))
            c = jnp.where(kk == 0, L.is_rep_g0 + F["state"],
                          jnp.where(kk == 1, c1, L.is_rep_g2 + F["state"]))
            b = jnp.where(
                kk == 0,
                jnp.where(F["rep_idx"] == 0, 0, 1),
                jnp.where(kk == 1, b1v, jnp.where(F["rep_idx"] == 2, 0, 1)),
            )
            ctx_t = jnp.where(sel, c, ctx_t)
            bit_t = jnp.where(sel, b, bit_t)

            if not short_side:
                # -- length bits (match + rep) --
                kk = t - F["len_s"]
                sel_len = in_tok & (kk >= 0) & (kk < F["dlen"])
                sel = sel_len & (kk == 0)
                ctx_t = jnp.where(sel, F["len_base"] + L.len_choice, ctx_t)
                bit_t = jnp.where(sel, jnp.where(F["band"] == 0, 0, 1),
                                  bit_t)
                sel = sel_len & (kk == 1) & (F["band"] > 0)
                ctx_t = jnp.where(sel, F["len_base"] + L.len_choice2, ctx_t)
                bit_t = jnp.where(sel, jnp.where(F["band"] == 1, 0, 1),
                                  bit_t)
                #   band tree (MSB-first): after j bits
                #   m = (1<<j) | (v >> (nb-j))
                j = jnp.clip(kk - F["choice_bits"], 0, 8)
                sel = sel_len & (kk - F["choice_bits"] >= 0)
                m = (1 << j) | (F["band_v"]
                                >> jnp.clip(F["band_bits"] - j, 0, 31))
                b = (F["band_v"]
                     >> jnp.clip(F["band_bits"] - 1 - j, 0, 31)) & 1
                ctx_t = jnp.where(sel, F["band_tree"] + m, ctx_t)
                bit_t = jnp.where(sel, b, bit_t)

                # -- pos_slot tree (match only), 6 bits MSB-first --
                j_raw = t - F["slot_s"]
                j = jnp.clip(j_raw, 0, 5)
                sel = in_tok & F["is_match"] & (j_raw >= 0) & (j_raw < 6)
                m = (1 << j) | (F["slot"] >> (6 - j))
                b = (F["slot"] >> (5 - j)) & 1
                ctx_t = jnp.where(sel, F["slot_tree"] + m, ctx_t)
                bit_t = jnp.where(sel, b, bit_t)

                # -- distance tail --
                j_raw = t - F["tail_s"]
                #   spec_pos reverse tree: footer (<=5) bits LSB-first
                j = jnp.clip(j_raw, 0, 4)
                sel = in_tok & F["spec"] & (j_raw >= 0) & (j_raw < F["footer"])
                m_rev = (1 << j) | _bitrev_low(F["reduced"], j, 5)
                b = (F["reduced"] >> j) & 1
                ctx_t = jnp.where(
                    sel, L.spec_pos + F["base_val"] - F["slot"] - 1 + m_rev,
                    ctx_t)
                bit_t = jnp.where(sel, b, bit_t)
                #   huge: direct bits MSB-first then 4-bit align rev tree
                nd = F["footer"] - 4
                sel = in_tok & F["huge"] & (j_raw >= 0) & (j_raw < nd)
                b = (F["reduced"]
                     >> jnp.clip(F["footer"] - 1 - j_raw, 0, 31)) & 1
                ctx_t = jnp.where(sel, CTX_DIRECT, ctx_t)
                bit_t = jnp.where(sel, b, bit_t)
                ja = jnp.clip(j_raw - nd, 0, 3)
                sel = in_tok & F["huge"] & (j_raw - nd >= 0) & (j_raw - nd < 4)
                align_v = F["reduced"] & 15
                m_rev = (1 << ja) | _bitrev_low(align_v, ja, 4)
                b = (align_v >> ja) & 1
                ctx_t = jnp.where(sel, L.align + m_rev, ctx_t)
                bit_t = jnp.where(sel, b, bit_t)

            # ONE packed scatter into the flat stream (ctx fits 14 bits;
            # halving the scatter volume is the round-5 lower-pass win)
            dest = jnp.where(in_tok, F["base_off"] + t, max_bits)
            packed = jnp.where(in_tok, (ctx_t << 1) | bit_t, 0)
            return ctx_out.at[lanes2, dest].set(packed, mode="drop")

        return slot_body

    # packed plane: (ctx << 1) | bit, initialized to the direct-bit ctx
    ctx_out = jnp.full((N, max_bits), CTX_DIRECT << 1, dtype=jnp.int32)

    short_cls = valid & (is_lit | srep)
    ctx_out = jax.lax.fori_loop(
        0, 9, make_body(F_full, short_cls, T, True), ctx_out)

    # LONG tokens compacted to a half-width buffer (len >= 2 each);
    # only the fields the long side reads are compacted
    Tc = T // 2 + 2
    long_cls = valid & ~(is_lit | srep)
    lidx = jnp.cumsum(long_cls.astype(jnp.int32), axis=1) - 1
    # lidx < Tc is provable (each long token covers >= 2 of the <= T
    # positions); the guard turns a violated invariant into dropped
    # bits rather than a silently corrupted last slot
    ltgt = jnp.where(long_cls & (lidx < Tc), lidx, Tc)

    def comp(a):
        return jnp.zeros((N, Tc + 1), a.dtype).at[lanes2, ltgt].set(
            a, mode="drop")[:, :Tc]

    LONG_FIELDS = ("nbits", "base_off", "im_ctx", "is_rep", "is_match",
                   "state", "pos_state", "rep_idx", "srep", "rbits", "len_s",
                   "dlen", "band", "band_v", "band_bits", "band_tree",
                   "choice_bits", "len_base", "slot", "slot_tree",
                   "slot_s", "tail_s", "spec", "huge", "footer",
                   "reduced", "base_val")
    F_long = {kk: comp(F_full[kk]) for kk in LONG_FIELDS}
    long_c = comp(long_cls)
    maxb = jnp.minimum(jnp.max(jnp.where(long_cls, nbits, 0)), MAXB)
    ctx_out = jax.lax.fori_loop(
        0, maxb, make_body(F_long, long_c, Tc, False), ctx_out)
    return ctx_out >> 1, ctx_out & 1, total


# ---------------------------------------------------------------- phase D
def check_out_lens(out_lens, max_out: int):
    """Raise if any lane's coded stream overran its max_out-byte row."""
    worst = int(np.max(out_lens)) if len(out_lens) else 0
    if worst > max_out:
        raise RuntimeError(
            f"device range coder overran its output buffer "
            f"({worst} > {max_out} bytes)")


@partial(jax.jit, static_argnames=("arena_size", "max_out"))
def serialize_xla(ctx, bits, totals, arena_size: int, max_out: int):
    """Range-code the per-lane (ctx,bit) streams as a lax.while_loop — the
    plain reference of the Triton kernel.  One op per iteration per lane:
    adaptive bit, direct bit, drain-filler byte, or flush step."""
    N, _ = ctx.shape
    lanes = jnp.arange(N)

    probs0 = jnp.full((N, arena_size), 1024, dtype=jnp.int32)
    out0 = jnp.zeros((N, max_out), dtype=jnp.uint8)
    z = jnp.zeros((N,), dtype=jnp.int32)
    state0 = dict(
        low=jnp.zeros((N,), dtype=jnp.uint32),
        carry=z,
        rng=jnp.full((N,), 0xFFFFFFFF, dtype=jnp.uint32),
        cache=z,
        pending=z,          # 0xFF-run length not yet emitted
        drain=z,            # filler bytes to emit now
        drain_byte=z,
        bit_pos=z,
        out_pos=z,
        flush_i=z,
    )

    def cond(c):
        s, probs, out = c
        unfinished = (s["bit_pos"] < totals) | (s["drain"] > 0) | (s["flush_i"] < 5)
        return jnp.any(unfinished)

    def body(c):
        s, probs, out = c
        draining = s["drain"] > 0
        has_bits = s["bit_pos"] < totals
        flushing = (~draining) & (~has_bits) & (s["flush_i"] < 5)
        coding = (~draining) & has_bits

        bp = jnp.minimum(s["bit_pos"], ctx.shape[1] - 1)
        cx = ctx[lanes, bp]
        bt = bits[lanes, bp]
        adaptive = coding & (cx >= 0)
        direct = coding & (cx == CTX_DIRECT)

        # adaptive bit
        safe_cx = jnp.where(adaptive, cx, 0)
        prob = probs[lanes, safe_cx]
        bound = (s["rng"] >> 11) * prob.astype(jnp.uint32)
        low_add_a = jnp.where(bt == 1, bound, jnp.uint32(0))
        rng_a = jnp.where(bt == 0, bound, s["rng"] - bound)
        new_prob = jnp.where(bt == 0, prob + ((2048 - prob) >> 5), prob - (prob >> 5))
        # non-adaptive lanes write the unchanged prob back to ctx 0 (no-op)
        probs = probs.at[lanes, safe_cx].set(jnp.where(adaptive, new_prob, prob))

        # direct bit
        rng_d = s["rng"] >> 1
        low_add_d = jnp.where(bt == 1, rng_d, jnp.uint32(0))

        rng1 = jnp.where(adaptive, rng_a, jnp.where(direct, rng_d, s["rng"]))
        low_add = jnp.where(adaptive, low_add_a, jnp.where(direct, low_add_d, jnp.uint32(0)))
        new_low = s["low"] + low_add
        new_carry = s["carry"] | (new_low < s["low"]).astype(jnp.int32)

        # renormalize / flush -> shiftLow
        need_shift = (coding & (rng1 < (1 << 24))) | flushing
        rng2 = jnp.where(coding & (rng1 < (1 << 24)), rng1 << 8, rng1)

        fire = need_shift & ((new_carry == 1) | (new_low < jnp.uint32(0xFF000000)))
        stall = need_shift & ~fire
        emit_byte = (s["cache"] + new_carry) & 0xFF
        filler = (0xFF + new_carry) & 0xFF

        # drain emission (one filler per iteration)
        wi = jnp.where(draining, jnp.minimum(s["out_pos"], max_out - 1), max_out)
        out = out.at[lanes, wi].set(s["drain_byte"].astype(jnp.uint8), mode="drop")
        # fire emission
        wi = jnp.where(fire, jnp.minimum(s["out_pos"], max_out - 1), max_out)
        out = out.at[lanes, wi].set(emit_byte.astype(jnp.uint8), mode="drop")

        out_pos = s["out_pos"] + jnp.where(draining | fire, 1, 0)
        drain = jnp.where(draining, s["drain"] - 1, jnp.where(fire, s["pending"], s["drain"]))
        drain_byte = jnp.where(fire, filler, s["drain_byte"])
        pending = jnp.where(fire, 0, jnp.where(stall, s["pending"] + 1, s["pending"]))
        cache = jnp.where(fire, (new_low >> 24).astype(jnp.int32) & 0xFF, s["cache"])
        low2 = jnp.where(need_shift, (new_low & 0xFFFFFF) << 8, new_low)
        carry2 = jnp.where(need_shift, 0, new_carry)

        s2 = dict(
            low=low2,
            carry=carry2,
            rng=rng2,
            cache=cache,
            pending=pending,
            drain=drain,
            drain_byte=drain_byte,
            bit_pos=s["bit_pos"] + jnp.where(coding, 1, 0),
            out_pos=out_pos,
            flush_i=s["flush_i"] + jnp.where(flushing, 1, 0),
        )
        return (s2, probs, out)

    s, probs, out = jax.lax.while_loop(cond, body, (state0, probs0, out0))
    return out, s["out_pos"]


# ------------------------------------------------------------------ API
@jax.jit
def _append_eos_tokens(t_pos, t_len, t_dist, t_valid, ntok, lens):
    """Append the end-of-stream marker token to every lane's compacted
    stream: a len-2 match at the EOS_DIST sentinel distance coded at the
    end position (WriteEndMarker semantics, Encoder.java:818-835)."""
    N, T = t_pos.shape
    pad = ((0, 0), (0, 1))
    t_pos = jnp.pad(t_pos, pad)
    t_len = jnp.pad(t_len, pad, constant_values=1)
    t_dist = jnp.pad(t_dist, pad, constant_values=-1)
    lanes = jnp.arange(N)
    t_pos = t_pos.at[lanes, ntok].set(lens)
    t_len = t_len.at[lanes, ntok].set(2)
    t_dist = t_dist.at[lanes, ntok].set(EOS_DIST)
    t_valid = jnp.arange(T + 1)[None, :] < (ntok + 1)[:, None]
    return t_pos, t_len, t_dist, t_valid


@partial(jax.jit, static_argnames=("fb", "num_candidates", "start"))
def _tokenize_lazy(data, lens, dict_size, *, fb, num_candidates, start):
    return jax.vmap(
        lambda d, n: tokenize(d, n, dict_size, fb, num_candidates,
                              start=start)
    )(data, lens)


def lower_lanes(data, lens, dict_size, *, lc, lp, pb, fb,
                num_candidates=DEFAULT_NUM_CANDIDATES, preset=None,
                write_eos=False, parse="lazy"):
    """Phases A-C for a lane batch: (optional preset priming) + tokenize +
    classify + bit lowering.  Returns (ctx, bits, totals, max_out).

    parse="optimal" runs the lane-parallel optimal-parse DP
    (ops/device_parser.tokenize_optimal — empirical prices + banded DP
    scan) instead of the lazy tokenizer.  Preset priming is lazy-only
    for now.  Each pass is its own compiled program, so callers that
    dispatch the same passes (chip_smoke.py) reuse the compilations."""
    N, max_n = data.shape
    if preset is not None and preset.shape[0]:
        plen = preset.shape[0]
        data = jnp.concatenate(
            [jnp.broadcast_to(preset[None, :], (N, plen)).astype(data.dtype), data],
            axis=1,
        )
        lens = lens + plen
    else:
        plen = 0
    if parse.startswith("optimal") and plen == 0:
        from .device_parser import DP_TIERS, tokenize_optimal

        # "optimal" or "optimal:<seed>" (seed A/B: lists|lazy|lists2|...)
        seed = parse.split(":", 1)[1] if ":" in parse else "lists"
        tok = tokenize_optimal(data, lens, dict_size, lc=lc, lp=lp, pb=pb,
                               fb=fb, tiers_key=DP_TIERS, n_iter=2,
                               seed=seed)
    else:
        tok = _tokenize_lazy(data, lens, dict_size, fb=fb,
                             num_candidates=num_candidates, start=plen)
    t_pos, t_len, t_dist, t_valid, ntok = tok
    if write_eos:
        t_pos, t_len, t_dist, t_valid = _append_eos_tokens(
            t_pos, t_len, t_dist, t_valid, ntok, lens)
    meta = classify_tokens(data, t_pos, t_len, t_dist, t_valid)
    max_bits = 10 * max_n + 128
    ctx, bits, totals = lower_tokens(
        data, meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb, max_bits,
        pos_base=plen,
    )
    return ctx, bits, totals, max_n + max_n // 4 + 128


def encode_lanes(data, lens, dict_size, *, lc, lp, pb, fb,
                 num_candidates=DEFAULT_NUM_CANDIDATES, preset=None,
                 write_eos=False, parse="lazy"):
    """Lane-parallel encode: the device pipeline (jittable as a whole).

    data: (N, max_n) u8, lens: (N,) i32.  `preset` ((P,) u8 or None)
    primes every lane's window with a shared dictionary (LZTB v2): it is
    searched as match history but contributes no output — on a mesh,
    passing it replicated IS the dictionary broadcast.  Returns
    (comp (N, max_out) u8, comp_lens (N,) i32).  Safe to wrap in
    shard_map over a block-sharded mesh axis (parallel/mesh.py).
    """
    ctx, bits, totals, max_out = lower_lanes(
        data, lens, dict_size, lc=lc, lp=lp, pb=pb, fb=fb,
        num_candidates=num_candidates, preset=preset, write_eos=write_eos,
        parse=parse)
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    # the backend's coder; a lane with out_lens > max_out overran its
    # row (check_out_lens)
    return kernels.for_platform().serialize(ctx, bits, totals, layout.size,
                                            max_out)


def _dump_device_trace(trace, data, lens, dict_j, fb, num_candidates,
                       preset_j, parse):
    """Re-run the (deterministic) tokenizer outside the fused encode and
    print every lane's decision stream through CodecTrace.tokens."""
    dj, lj = jnp.asarray(data), jnp.asarray(lens)
    plen = 0
    if preset_j is not None and preset_j.shape[0]:
        plen = int(preset_j.shape[0])
        dj = jnp.concatenate(
            [jnp.broadcast_to(preset_j[None, :],
                              (dj.shape[0], plen)).astype(dj.dtype), dj],
            axis=1)
        lj = lj + plen
    if parse.startswith("optimal") and plen == 0:
        from .device_parser import DP_TIERS, tokenize_optimal

        seed = parse.split(":", 1)[1] if ":" in parse else "lists"
        tok = tokenize_optimal(dj, lj, dict_j, lc=3, lp=0, pb=2, fb=fb,
                               tiers_key=DP_TIERS, n_iter=2, seed=seed)
    else:
        tok = jax.vmap(
            lambda d, n: tokenize(d, n, dict_j, fb, num_candidates,
                                  start=plen)
        )(dj, lj)
    tp, tl, td, tv, ntok = tok
    meta = classify_tokens(dj, tp, tl, td, tv)
    kinds, rep_idx = np.asarray(meta[0]), np.asarray(meta[1])
    tp, tl, td, ntok = map(np.asarray, (tp, tl, td, ntok))
    # per-position candidate-list dump (BinTree.java:139-150 analogue):
    # the DEVICE finder's ascending (len, dist)
    # lists at every decision position, in the scalar `matches=` line
    # format.  Lists come from the same engine the parse consumed
    # (tier RMQ lists for the optimal DP; the lazy tokenizer's best
    # pair is a 1-entry list).
    if parse.startswith("optimal") and plen == 0:
        from .device_parser import DP_M_CAP, DP_M_CAP_ORDER, DP_TIERS
        from .device_matcher import find_match_lists_rmq

        # SAME cap/order as the parse consumed (tokenize_optimal's
        # production defaults) — the dumped lists are what the DP saw
        cl, cd, cn = jax.vmap(
            lambda d, n: find_match_lists_rmq(
                d, n, dict_j, fb, m_cap=DP_M_CAP,
                m_cap_order=DP_M_CAP_ORDER, **dict(DP_TIERS))
        )(dj, lj)
        cl, cd, cn = map(np.asarray, (cl, cd, cn))
    else:
        from .device_matcher import find_best_matches_rmq

        bl, bd = jax.vmap(
            lambda d, n: find_best_matches_rmq(d, n, dict_j, fb,
                                               num_candidates)
        )(dj, lj)
        bl, bd = np.asarray(bl), np.asarray(bd)
        cl = bl[:, :, None]
        cd = np.where(bl > 0, bd, 0)[:, :, None]
        cn = (bl >= 2).astype(np.int32)
    for i in range(tp.shape[0]):
        trace.tokens(i, tp[i] - plen, tl[i], td[i], kinds[i], rep_idx[i],
                     int(ntok[i]))
        for j in range(int(ntok[i])):
            pos = int(tp[i, j])
            k = int(cn[i, pos])
            pairs = [(int(cl[i, pos, m]), int(cd[i, pos, m]))
                     for m in range(k)]
            trace.matches(pos - plen, pairs)


def encode_batch(blocks, params: LzmaParams, fb=None,
                 num_candidates: int = DEFAULT_NUM_CANDIDATES,
                 preset: bytes = b"",
                 write_eos: bool = False, parse: str = "lazy", trace=None):
    """Encode independent blocks lane-parallel on device.

    blocks: list of bytes.  `preset` primes every lane's window with the
    same shared dictionary (LZTB v2 blocks 1..n).  Returns list of raw
    LZMA streams.  `trace` (utils.trace.CodecTrace) dumps every lane's decision stream
    in the scalar per-symbol format — the device analogue of the
    reference's FINE logging (Encoder.java:871-1018): the token stream
    is read back once and each (pos, len, dist) + classify metadata
    prints as pos/kind/len lines (debug mode; the parse runs once more
    outside the fused encode, deterministic so the dump matches the
    coded stream exactly).
    """
    if not blocks:
        return []
    params = params.validated_for_encode()
    fb = clamp_fb(fb if fb is not None else params.fast_bytes)
    n_lanes = len(blocks)
    max_n = max(max(len(b) for b in blocks), 16)
    max_n = 1 << (max_n - 1).bit_length()  # pow2 bucket: stable jit shapes
    data = np.zeros((n_lanes, max_n), dtype=np.uint8)
    lens = np.zeros(n_lanes, dtype=np.int32)
    for i, b in enumerate(blocks):
        data[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    preset_j = (jnp.asarray(np.frombuffer(preset, dtype=np.uint8))
                if preset else None)
    dict_j = jnp.int32(min(params.dict_size, max_n + len(preset)))
    if trace is not None and getattr(trace, "enabled", False):
        _dump_device_trace(trace, np.asarray(data), np.asarray(lens), dict_j,
                           fb, num_candidates, preset_j, parse)
    out, out_lens = encode_lanes(
        jnp.asarray(data),
        jnp.asarray(lens),
        dict_j,
        lc=params.lc,
        lp=params.lp,
        pb=params.pb,
        fb=fb,
        num_candidates=num_candidates,
        preset=preset_j,
        write_eos=write_eos,
        parse=parse,
    )
    out = np.asarray(out)
    out_lens = np.asarray(out_lens)
    check_out_lens(out_lens, out.shape[1])
    return [out[i, : out_lens[i]].tobytes() for i in range(n_lanes)]
