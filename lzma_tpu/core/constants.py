"""LZMA format constants and the 12-state context state machine.

Capability parity with the reference's ``Compression/LZMA/Base.java`` (see
SURVEY.md #1): same constants, same state-transition semantics.  Written
array-first so the state machine is usable both scalarly and as vectorized
jnp/numpy lookups on device (device lanes index these tables directly).

Reference behavior pinned against: Base.java:6-85.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- states
NUM_REP_DISTANCES = 4          # Base.java:6
NUM_STATES = 12                # Base.java:7

# State-transition tables (Base.java:16-36).  Expressed as dense lookup
# tables rather than branchy functions: on a device every lane does
# ``next_state = TABLE[state]`` as a tiny gather / one-hot select.
_STATES = np.arange(NUM_STATES)
NEXT_STATE_LITERAL = np.where(
    _STATES < 4, 0, np.where(_STATES < 10, _STATES - 3, _STATES - 6)
).astype(np.int32)
NEXT_STATE_MATCH = np.where(_STATES < 7, 7, 10).astype(np.int32)
NEXT_STATE_SHORTREP = np.where(_STATES < 7, 9, 11).astype(np.int32)
NEXT_STATE_LONGREP = np.where(_STATES < 7, 8, 11).astype(np.int32)

INITIAL_STATE = 0


def state_is_literal(state: int) -> bool:
    """True when the previous op emitted a literal (state < 7).

    Mirrors Base.isStateOneWhereAtLastACharWasFound (Base.java:38-40);
    controls matched-literal coding mode.
    """
    return state < 7


# ------------------------------------------------------------- match/len
MATCH_MIN_LEN = 2              # Base.java:50
NUM_LOW_LEN_BITS = 3           # Base.java:78
NUM_MID_LEN_BITS = 3
NUM_HIGH_LEN_BITS = 8
NUM_LOW_LEN_SYMBOLS = 1 << NUM_LOW_LEN_BITS
NUM_MID_LEN_SYMBOLS = 1 << NUM_MID_LEN_BITS
NUM_LEN_SYMBOLS = NUM_LOW_LEN_SYMBOLS + NUM_MID_LEN_SYMBOLS + (1 << NUM_HIGH_LEN_BITS)
MATCH_MAX_LEN = MATCH_MIN_LEN + NUM_LEN_SYMBOLS - 1  # = 273 (Base.java:85)

# ------------------------------------------------------------- distances
NUM_POS_SLOT_BITS = 6          # Base.java:42
NUM_LEN_TO_POS_STATES_BITS = 2  # Base.java:47
NUM_LEN_TO_POS_STATES = 1 << NUM_LEN_TO_POS_STATES_BITS

NUM_ALIGN_BITS = 4             # Base.java:60
ALIGN_TABLE_SIZE = 1 << NUM_ALIGN_BITS
ALIGN_MASK = ALIGN_TABLE_SIZE - 1

START_POS_MODEL_INDEX = 4      # Base.java:64
END_POS_MODEL_INDEX = 14       # Base.java:65
NUM_FULL_DISTANCES = 1 << (END_POS_MODEL_INDEX // 2)  # = 128 (Base.java:68)
NUM_SPEC_POS_PROBS = NUM_FULL_DISTANCES - END_POS_MODEL_INDEX  # = 114

# --------------------------------------------------------------- posState
NUM_POS_STATES_BITS_MAX = 4    # Base.java:73
NUM_POS_STATES_MAX = 1 << NUM_POS_STATES_BITS_MAX
NUM_LIT_POS_BITS_MAX = 4       # Base.java:70 (lp <= 4)
NUM_LIT_CONTEXT_BITS_MAX = 8   # Base.java:71 (lc <= 8)

DICT_LOG_SIZE_MIN = 0          # Base.java:43
DICT_LOG_SIZE_MAX_COMPRESS = 29  # Encoder.java:1136

# EOS marker distance: encoded as posSlot 63 + all-ones footer, which the
# decoder reconstructs as rep0 == 0xFFFFFFFF (== -1) (Decoder.java:277-283,
# Encoder.java:818-835).
EOS_DISTANCE_U32 = 0xFFFFFFFF


def len_to_pos_state(length: int) -> int:
    """Distance-model context from match length (Base.java:52-58)."""
    length -= MATCH_MIN_LEN
    return length if length < NUM_LEN_TO_POS_STATES else NUM_LEN_TO_POS_STATES - 1



# ------------------------------------------------------------ pos slots
# Slot of a distance: slot < 4 encodes the distance directly; otherwise
# dist = (2 | (slot&1)) << ((slot>>1)-1)  + footer bits.  The reference
# accelerates the inverse with the g_FastPos table (Encoder.java:24-41);
# we build the full 2048-entry table once and derive slots with shifts.
def _build_fast_pos() -> np.ndarray:
    table = np.zeros(1 << 11, dtype=np.uint8)
    table[0], table[1] = 0, 1
    c = 2
    for slot in range(2, 22):
        k = 1 << ((slot >> 1) - 1)
        table[c : c + k] = slot
        c += k
    return table


FAST_POS = _build_fast_pos()


def pos_slot(dist: int) -> int:
    """posSlot for encoding a distance (Encoder.java:86-94)."""
    if dist < (1 << 11):
        return int(FAST_POS[dist])
    if dist < (1 << 21):
        return int(FAST_POS[dist >> 10]) + 20
    return int(FAST_POS[dist >> 20]) + 40


def pos_slot2(dist: int) -> int:
    """posSlot for dist >= NUM_FULL_DISTANCES price lookups (Encoder.java:96-104)."""
    if dist < (1 << 17):
        return int(FAST_POS[dist >> 6]) + 12
    if dist < (1 << 27):
        return int(FAST_POS[dist >> 16]) + 32
    return int(FAST_POS[dist >> 26]) + 52
