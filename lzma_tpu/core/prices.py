"""Adaptive-bit probability model constants and the -log2 price table.

The range coder models every bit with an 11-bit probability (init 1024,
adapt shift 5) — RangeBase.java:4-13.  Prices are precomputed -log2(p) in
1/64-bit units over 512 quantized probability buckets — ProbPrices.java:5-18.

The whole table is a 512-entry int32 vector; on device price evaluation
is a tiny gather.  Values are bit-identical to the reference table (pinned by
tests/test_prices.py golden vectors from BitTreeEncoderLearningTest).
"""

from __future__ import annotations

import numpy as np

NUM_BIT_MODEL_TOTAL_BITS = 11
BIT_MODEL_TOTAL = 1 << NUM_BIT_MODEL_TOTAL_BITS   # 2048
NUM_MOVE_BITS = 5
PROB_INIT = BIT_MODEL_TOTAL >> 1                   # 1024
TOP_VALUE = 1 << 24

NUM_MOVE_REDUCING_BITS = 2
NUM_BIT_PRICE_SHIFT_BITS = 6
INFINITY_PRICE = 0x0FFFFFFF                        # Encoder.java:22


def _build_prices() -> np.ndarray:
    """Piecewise-log price table (ProbPrices.java:8-18)."""
    n = BIT_MODEL_TOTAL >> NUM_MOVE_REDUCING_BITS  # 512
    num_bits = NUM_BIT_MODEL_TOTAL_BITS - NUM_MOVE_REDUCING_BITS  # 9
    table = np.zeros(n, dtype=np.int32)
    for i in range(num_bits - 1, -1, -1):
        start = 1 << (num_bits - i - 1)
        end = 1 << (num_bits - i)
        j = np.arange(start, end)
        table[j] = (i << NUM_BIT_PRICE_SHIFT_BITS) + (
            ((end - j) << NUM_BIT_PRICE_SHIFT_BITS) >> (num_bits - i - 1)
        )
    return table


PRICE_TABLE = _build_prices()


def price(prob: int, bit: int) -> int:
    """Price of coding `bit` with probability state `prob` (ProbPrices.java:23-29)."""
    mask = BIT_MODEL_TOTAL - 1
    return int(PRICE_TABLE[(((prob - bit) ^ (-bit)) & mask) >> NUM_MOVE_REDUCING_BITS])


def price0(prob: int) -> int:
    return int(PRICE_TABLE[prob >> NUM_MOVE_REDUCING_BITS])


def price1(prob: int) -> int:
    return int(PRICE_TABLE[(BIT_MODEL_TOTAL - prob) >> NUM_MOVE_REDUCING_BITS])
