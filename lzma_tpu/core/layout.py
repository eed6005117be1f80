"""Flat probability-arena layout shared by every backend.

The reference scatters its adaptive probabilities across many small Java
arrays (Encoder.java:113-128, Decoder.java:132-147).  We instead pack the
entire model into ONE contiguous uint16 arena with fixed offsets derived
from (lc, lp, pb).  Why: on a device, per-stream model state must be a single
dense (lanes, arena_size) array so a batched coder can gather
``probs[lane, ctx]`` uniformly; and the scalar Python, native C++ and JAX
implementations all share this layout, which makes their internal states
directly diffable in tests.

Sub-model sizes mirror the reference exactly:
  is_match      12<<4            Decoder.java:132
  is_rep        12               Decoder.java:133
  is_rep_g0/1/2 12 each          Decoder.java:134-136
  is_rep0_long  12<<4            Decoder.java:137
  pos_slot      4*64 trees       Decoder.java:139 (tree nodes indexed 1..63)
  spec_pos      114              Decoder.java:140
  align         16               Decoder.java:142
  len / rep_len 2+16*8+16*8+256  Decoder.java:25-60, LenEncoder.java:11-14
  literal       0x300 << (lc+lp) Decoder.java:62-127
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .constants import (
    ALIGN_TABLE_SIZE,
    NUM_FULL_DISTANCES,
    END_POS_MODEL_INDEX,
    NUM_LEN_TO_POS_STATES,
    NUM_POS_STATES_BITS_MAX,
    NUM_POS_STATES_MAX,
    NUM_STATES,
    NUM_LOW_LEN_SYMBOLS,
    NUM_MID_LEN_SYMBOLS,
)
from .prices import PROB_INIT

POS_SLOT_TREE_SIZE = 1 << 6          # 64 nodes per tree, root at index 1
LEN_CHOICE_SIZE = 2
LEN_LOW_SIZE = NUM_POS_STATES_MAX * NUM_LOW_LEN_SYMBOLS   # 16 * 8
LEN_MID_SIZE = NUM_POS_STATES_MAX * NUM_MID_LEN_SYMBOLS   # 16 * 8
LEN_HIGH_SIZE = 1 << 8
LEN_CODER_SIZE = LEN_CHOICE_SIZE + LEN_LOW_SIZE + LEN_MID_SIZE + LEN_HIGH_SIZE  # 514

# Offsets inside one length coder (relative):
LEN_CHOICE = 0          # choice bit
LEN_CHOICE2 = 1         # choice2 bit
LEN_LOW = 2                                 # + posState * 8 + node(1..7)
LEN_MID = LEN_LOW + LEN_LOW_SIZE            # + posState * 8 + node(1..7)
LEN_HIGH = LEN_MID + LEN_MID_SIZE           # + node(1..255)

LITERAL_CODER_SIZE = 0x300


@dataclass(frozen=True)
class ProbLayout:
    """Offsets of every sub-model inside the flat arena for given lc/lp/pb.

    ``pos_bits`` sets the posState STRIDE of the position-conditioned
    tables (is_match, is_rep0_long, len low/mid).  The canonical layout
    uses the reference's fixed kNumPosStatesMax=16 stride
    (Decoder.java:132,137, LenEncoder.java:11-14) so scalar/native
    arenas stay directly diffable.  The device kernels pass
    ``pos_bits=pb``: with pb=2 only 4 of every 16 posState slots are
    ever touched, so compacting the stride to the live posStates
    shrinks the arena ~25% at lc0.  Pure memory plan — probabilities, adaptation and output
    bytes are identical.
    """

    lc: int
    lp: int
    pb: int
    pos_bits: int = NUM_POS_STATES_BITS_MAX

    is_match: int = field(init=False)
    is_rep: int = field(init=False)
    is_rep_g0: int = field(init=False)
    is_rep_g1: int = field(init=False)
    is_rep_g2: int = field(init=False)
    is_rep0_long: int = field(init=False)
    pos_slot: int = field(init=False)
    spec_pos: int = field(init=False)
    align: int = field(init=False)
    len_coder: int = field(init=False)
    rep_len_coder: int = field(init=False)
    literal: int = field(init=False)
    size: int = field(init=False)
    # relative offsets inside one length coder (stride-dependent)
    len_choice: int = field(init=False)
    len_choice2: int = field(init=False)
    len_low: int = field(init=False)
    len_mid: int = field(init=False)
    len_high: int = field(init=False)

    def __post_init__(self):
        assert self.pb <= self.pos_bits <= NUM_POS_STATES_BITS_MAX
        n_ps = 1 << self.pos_bits
        off = 0

        def take(n):
            nonlocal off
            cur = off
            off += n
            return cur

        object.__setattr__(self, "is_match", take(NUM_STATES * n_ps))
        object.__setattr__(self, "is_rep", take(NUM_STATES))
        object.__setattr__(self, "is_rep_g0", take(NUM_STATES))
        object.__setattr__(self, "is_rep_g1", take(NUM_STATES))
        object.__setattr__(self, "is_rep_g2", take(NUM_STATES))
        object.__setattr__(self, "is_rep0_long", take(NUM_STATES * n_ps))
        object.__setattr__(self, "pos_slot", take(NUM_LEN_TO_POS_STATES * POS_SLOT_TREE_SIZE))
        object.__setattr__(self, "spec_pos", take(NUM_FULL_DISTANCES - END_POS_MODEL_INDEX))
        object.__setattr__(self, "align", take(ALIGN_TABLE_SIZE))
        object.__setattr__(self, "len_choice", 0)
        object.__setattr__(self, "len_choice2", 1)
        object.__setattr__(self, "len_low", 2)
        object.__setattr__(self, "len_mid",
                           2 + n_ps * NUM_LOW_LEN_SYMBOLS)
        object.__setattr__(self, "len_high",
                           2 + n_ps * (NUM_LOW_LEN_SYMBOLS + NUM_MID_LEN_SYMBOLS))
        len_size = self.len_high + LEN_HIGH_SIZE
        object.__setattr__(self, "len_coder", take(len_size))
        object.__setattr__(self, "rep_len_coder", take(len_size))
        object.__setattr__(self, "literal", take(LITERAL_CODER_SIZE << (self.lc + self.lp)))
        object.__setattr__(self, "size", off)

    # ---- context helpers (shared by all backends) ----
    @property
    def pos_state_mask(self) -> int:
        return (1 << self.pb) - 1

    @property
    def literal_pos_mask(self) -> int:
        return (1 << self.lp) - 1

    def literal_sub(self, pos: int, prev_byte: int) -> int:
        """Arena offset of the 0x300-prob literal sub-coder for (pos, prevByte).

        Context select mirrors LiteralEncoder.GetSubCoder
        (LiteralEncoder.java:93-95).
        """
        ctx = ((pos & self.literal_pos_mask) << self.lc) + ((prev_byte & 0xFF) >> (8 - self.lc))
        return self.literal + ctx * LITERAL_CODER_SIZE

    def new_arena(self) -> np.ndarray:
        """Fresh arena with every probability at 1024 (RangeBase.java:9-13)."""
        return np.full(self.size, PROB_INIT, dtype=np.uint16)
