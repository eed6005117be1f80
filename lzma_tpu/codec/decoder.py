"""Scalar LZMA decoder — semantic oracle for the batched device decoder.

Single-pass symbol loop replicating the reference decoder exactly
(Decoder.Code, Decoder.java:205-301): isMatch -> literal (normal / matched
mode keyed on state<7) | isRep tree -> shortRep/longRep/match, distance
reconstruction from posSlot + spec-pos reverse tree or direct bits + align
tree, EOS detection via rep0 == 0xFFFFFFFF, and the corruption checks
(rep0 >= decoded-so-far or >= dict size).

Decodes into one in-memory buffer (the block-parallel design keeps every
block resident, so the circular OutWindow of the streaming reference
collapses to plain appends); the device backend (ops/device_decoder.py)
re-expresses this loop as a lane-parallel bit FSM.
"""

from __future__ import annotations

from ..core.constants import (
    END_POS_MODEL_INDEX,
    INITIAL_STATE,
    MATCH_MIN_LEN,
    NUM_ALIGN_BITS,
    NUM_POS_STATES_BITS_MAX,
    START_POS_MODEL_INDEX,
    NEXT_STATE_LITERAL,
    NEXT_STATE_MATCH,
    NEXT_STATE_LONGREP,
    NEXT_STATE_SHORTREP,
    len_to_pos_state,
)
from ..core.layout import (
    LEN_CHOICE,
    LEN_CHOICE2,
    LEN_HIGH,
    LEN_LOW,
    LEN_MID,
    POS_SLOT_TREE_SIZE,
    ProbLayout,
    LITERAL_CODER_SIZE,
)
from ..core.rangecoder import CorruptStreamError, RangeDecoder
from ..format.properties import LzmaParams, decode_props

_NSL = NEXT_STATE_LITERAL.tolist()
_NSM = NEXT_STATE_MATCH.tolist()
_NSR = NEXT_STATE_LONGREP.tolist()
_NSS = NEXT_STATE_SHORTREP.tolist()


def _decode_len(rc: RangeDecoder, probs, base: int, pos_state: int) -> int:
    """Length symbol 0..271 (LenDecoder.Decode, Decoder.java:48-59)."""
    if rc.decode_bit(probs, base + LEN_CHOICE) == 0:
        return rc.decode_tree(probs, base + LEN_LOW + (pos_state << 3), 3)
    if rc.decode_bit(probs, base + LEN_CHOICE2) == 0:
        return 8 + rc.decode_tree(probs, base + LEN_MID + (pos_state << 3), 3)
    return 16 + rc.decode_tree(probs, base + LEN_HIGH, 8)


def decode_stream(
    data,
    params: LzmaParams,
    out_size: int = -1,
    start: int = 0,
    end: int | None = None,
    preset: bytes = b"",
) -> bytes:
    """Decode one raw LZMA stream.

    out_size < 0 decodes until the EOS marker (Decoder.java:219).
    `preset` primes the dictionary window: match distances may reach into
    it, but position contexts count coded bytes only and `out_size`/the
    return value cover only the coded bytes.
    Returns the decompressed bytes; raises CorruptStreamError on invalid
    streams (mirroring the reference's `return false` paths,
    Decoder.java:281-291).
    """
    layout = ProbLayout(params.lc, params.lp, params.pb)
    probs = layout.new_arena()
    rc = RangeDecoder(data, start=start, end=end)

    base = len(preset)
    out = bytearray(preset)
    dict_size_check = max(params.dict_size, 1)
    pos_state_mask = layout.pos_state_mask
    lit_pos_mask = layout.literal_pos_mask
    lc = params.lc

    state = INITIAL_STATE
    rep0 = rep1 = rep2 = rep3 = 0
    prev_byte = preset[-1] if preset else 0

    decode_bit = rc.decode_bit
    decode_tree = rc.decode_tree
    L = layout

    while out_size < 0 or len(out) - base < out_size:
        now_pos = len(out) - base
        pos_state = now_pos & pos_state_mask
        if decode_bit(probs, L.is_match + (state << NUM_POS_STATES_BITS_MAX) + pos_state) == 0:
            # ---- literal (Decoder.java:222-230) ----
            sub = L.literal + (
                ((now_pos & lit_pos_mask) << lc) + (prev_byte >> (8 - lc))
            ) * LITERAL_CODER_SIZE
            if state < 7:
                symbol = 1
                while symbol < 0x100:
                    symbol = (symbol << 1) | decode_bit(probs, sub + symbol)
            else:
                match_byte = out[base + now_pos - rep0 - 1]
                symbol = 1
                while symbol < 0x100:
                    match_bit = (match_byte >> 7) & 1
                    match_byte = (match_byte << 1) & 0xFF
                    bit = decode_bit(probs, sub + ((1 + match_bit) << 8) + symbol)
                    symbol = (symbol << 1) | bit
                    if match_bit != bit:
                        while symbol < 0x100:
                            symbol = (symbol << 1) | decode_bit(probs, sub + symbol)
                        break
            prev_byte = symbol & 0xFF
            out.append(prev_byte)
            state = _NSL[state]
            continue

        # ---- match / rep (Decoder.java:231-295) ----
        if decode_bit(probs, L.is_rep + state) == 1:
            length = 0
            if decode_bit(probs, L.is_rep_g0 + state) == 0:
                if decode_bit(
                    probs, L.is_rep0_long + (state << NUM_POS_STATES_BITS_MAX) + pos_state
                ) == 0:
                    state = _NSS[state]
                    length = 1
            else:
                if decode_bit(probs, L.is_rep_g1 + state) == 0:
                    distance = rep1
                else:
                    if decode_bit(probs, L.is_rep_g2 + state) == 0:
                        distance = rep2
                    else:
                        distance = rep3
                        rep3 = rep2
                    rep2 = rep1
                rep1 = rep0
                rep0 = distance
            if length == 0:
                length = MATCH_MIN_LEN + _decode_len(rc, probs, L.rep_len_coder, pos_state)
                state = _NSR[state]
        else:
            rep3, rep2, rep1 = rep2, rep1, rep0
            length = MATCH_MIN_LEN + _decode_len(rc, probs, L.len_coder, pos_state)
            state = _NSM[state]
            slot_tree = L.pos_slot + len_to_pos_state(length) * POS_SLOT_TREE_SIZE
            pos_slot = decode_tree(probs, slot_tree, 6)
            if pos_slot >= START_POS_MODEL_INDEX:
                direct_bits = (pos_slot >> 1) - 1
                rep0 = (2 | (pos_slot & 1)) << direct_bits
                if pos_slot < END_POS_MODEL_INDEX:
                    rep0 += rc.decode_tree_reverse(
                        probs, L.spec_pos + rep0 - pos_slot - 1, direct_bits
                    )
                else:
                    rep0 += rc.decode_direct_bits(direct_bits - NUM_ALIGN_BITS) << NUM_ALIGN_BITS
                    rep0 += rc.decode_tree_reverse(probs, L.align, NUM_ALIGN_BITS)
                    rep0 &= 0xFFFFFFFF
                    if rep0 >= 0x80000000:  # signed-negative in the reference
                        if rep0 == 0xFFFFFFFF:
                            break  # EOS marker (Decoder.java:277-280)
                        raise CorruptStreamError("invalid distance")
            else:
                rep0 = pos_slot

        if rep0 >= base + now_pos or rep0 >= dict_size_check:
            raise CorruptStreamError(
                f"distance {rep0} out of window at position {now_pos}"
            )  # Decoder.java:288-291
        # copy match (OutWindow.CopyBlock semantics, overlap-safe)
        if out_size >= 0 and len(out) - base + length > out_size:
            # a match crossing the declared end never comes from a valid
            # encoder (native decoder: error -5)
            raise CorruptStreamError("match runs past the declared size")
        src = base + now_pos - rep0 - 1
        if rep0 == 0:
            out.extend(out[src:src + 1] * length)
        elif rep0 + 1 >= length:
            out.extend(out[src:src + length])
        else:
            for _ in range(length):
                out.append(out[src])
                src += 1
        prev_byte = out[-1]

    # exited via the EOS-marker break with bytes still owed: in known-size
    # mode a premature marker is corruption (native decoder: error -9)
    if out_size >= 0 and len(out) - base != out_size:
        raise CorruptStreamError("EOS marker before the declared size")

    return bytes(out[base:]) if base else bytes(out)


def decode_alone(data) -> bytes:
    """Decode a full `.lzma` (LZMA_Alone) container: 5-byte props + 8-byte
    LE size (or -1 for EOS-terminated) + raw stream (LzmaAlone.java:220-239)."""
    if len(data) < 13:
        raise CorruptStreamError(".lzma input too short")
    params = decode_props(data[:5])
    out_size = int.from_bytes(data[5:13], "little")
    if out_size == 0xFFFFFFFFFFFFFFFF:
        out_size = -1
    return decode_stream(data, params, out_size=out_size, start=13)
