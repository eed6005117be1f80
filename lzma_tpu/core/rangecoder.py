"""Scalar binary range coder — the semantic oracle for all batched backends.

Binary arithmetic coding with 32-bit range, 64-bit low with carry
propagation, 11-bit adaptive probabilities (p += (2048-p)>>5 on 0,
p -= p>>5 on 1), renormalization when range < 2^24.  Behavior is pinned
bit-for-bit against the reference (RangeEncoder.java:23-87,
RangeDecoder.java:19-64) by golden-vector tests (e.g. encoding bits 1,1,1
from fresh probs yields exactly ``00 dc f8 3c 00`` —
EncoderLearningTest.java:34-37).  The first emitted byte is always 0x00
(cache starts 0 with cacheSize 1).

This scalar form exists for correctness and small-input paths; the device
path re-expresses the same recurrences as a lane-parallel FSM
(lzma_tpu/ops/) and the native path in C++ (lzma_tpu/runtime/src/).
"""

from __future__ import annotations

import numpy as np

from .prices import BIT_MODEL_TOTAL, NUM_BIT_MODEL_TOTAL_BITS, NUM_MOVE_BITS, TOP_VALUE

_MASK32 = 0xFFFFFFFF


class RangeEncoder:
    """Adaptive binary arithmetic encoder writing to a bytearray."""

    __slots__ = ("out", "low", "range", "cache", "cache_size")

    def __init__(self, out: bytearray | None = None):
        self.out = out if out is not None else bytearray()
        self.reset()

    def reset(self):
        self.low = 0
        self.range = _MASK32
        self.cache = 0
        self.cache_size = 1

    # RangeEncoder.java:73-87
    def _shift_low(self):
        low = self.low
        if low >= 0xFF000000:
            carry = low >> 32
            if carry == 0:
                # Carry undecided: buffer another 0xFF-pending byte.
                self.cache_size += 1
                self.low = (low & 0xFFFFFF) << 8
                return
            # fall through: emit with carry
        else:
            carry = 0
        out = self.out
        out.append((self.cache + carry) & 0xFF)
        filler = (0xFF + carry) & 0xFF
        for _ in range(self.cache_size - 1):
            out.append(filler)
        self.cache = (low >> 24) & 0xFF
        self.cache_size = 1
        self.low = (low & 0xFFFFFF) << 8

    def encode_bit(self, probs: np.ndarray, index: int, bit: int):
        """Code one adaptive bit (RangeEncoder.java:38-54)."""
        prob = int(probs[index])
        bound = (self.range >> NUM_BIT_MODEL_TOTAL_BITS) * prob
        if bit == 0:
            self.range = bound
            probs[index] = prob + ((BIT_MODEL_TOTAL - prob) >> NUM_MOVE_BITS)
        else:
            self.low += bound
            self.range -= bound
            probs[index] = prob - (prob >> NUM_MOVE_BITS)
        if self.range < TOP_VALUE:
            self.range = (self.range << 8) & _MASK32
            self._shift_low()

    def encode_direct_bits(self, value: int, num_bits: int):
        """Code `num_bits` equiprobable bits MSB-first (RangeEncoder.java:56-67)."""
        for i in range(num_bits - 1, -1, -1):
            self.range >>= 1
            if (value >> i) & 1:
                self.low += self.range
            if self.range < TOP_VALUE:
                self.range = (self.range << 8) & _MASK32
                self._shift_low()

    def flush(self):
        """Drain the remaining 40 bits of state (RangeEncoder.java:31-36)."""
        for _ in range(5):
            self._shift_low()

    def processed_size(self) -> int:
        """Bytes that WILL have been written once flushed (RangeEncoder.java:69-71)."""
        return self.cache_size + len(self.out) + 4

    # --- tree helpers (BitTreeEncoder.java:18-36) ---
    def encode_tree(self, probs: np.ndarray, base: int, num_bits: int, symbol: int):
        m = 1
        for i in range(num_bits - 1, -1, -1):
            bit = (symbol >> i) & 1
            self.encode_bit(probs, base + m, bit)
            m = (m << 1) | bit

    def encode_tree_reverse(self, probs: np.ndarray, base: int, num_bits: int, symbol: int):
        m = 1
        for _ in range(num_bits):
            bit = symbol & 1
            symbol >>= 1
            self.encode_bit(probs, base + m, bit)
            m = (m << 1) | bit


class RangeDecoder:
    """Adaptive binary arithmetic decoder over an in-memory byte buffer.

    Reads past the logical end of input return 0 (they can only occur while
    draining the final flush window of a valid stream and never influence
    decoded output); more than 32 over-reads raises, catching corruption.
    """

    __slots__ = ("data", "pos", "end", "range", "code", "_overrun")

    def __init__(self, data, start: int = 0, end: int | None = None):
        self.data = data
        self.pos = start
        self.end = len(data) if end is None else end
        self.range = _MASK32
        self.code = 0
        self._overrun = 0
        for _ in range(5):  # RangeDecoder.java:19-25 (first byte is the 0x00 pad)
            self.code = ((self.code << 8) | self._next_byte()) & _MASK32

    def _next_byte(self) -> int:
        if self.pos < self.end:
            b = self.data[self.pos]
            self.pos += 1
            return b
        self._overrun += 1
        if self._overrun > 32:
            raise CorruptStreamError("range decoder ran past end of stream")
        return 0

    def decode_bit(self, probs: np.ndarray, index: int) -> int:
        """Decode one adaptive bit (RangeDecoder.java:43-64)."""
        prob = int(probs[index])
        bound = (self.range >> NUM_BIT_MODEL_TOTAL_BITS) * prob
        if self.code < bound:
            self.range = bound
            probs[index] = prob + ((BIT_MODEL_TOTAL - prob) >> NUM_MOVE_BITS)
            bit = 0
        else:
            self.range -= bound
            self.code -= bound
            probs[index] = prob - (prob >> NUM_MOVE_BITS)
            bit = 1
        if self.range < TOP_VALUE:
            self.code = ((self.code << 8) | self._next_byte()) & _MASK32
            self.range = (self.range << 8) & _MASK32
        return bit

    def decode_direct_bits(self, num_bits: int) -> int:
        """Decode equiprobable bits (RangeDecoder.java:27-41)."""
        result = 0
        for _ in range(num_bits):
            self.range >>= 1
            t = (self.code - self.range) & _MASK32
            t >>= 31  # 1 when code < range (borrow), i.e. bit is 0
            if t == 0:
                self.code -= self.range
            result = (result << 1) | (1 - t)
            if self.range < TOP_VALUE:
                self.code = ((self.code << 8) | self._next_byte()) & _MASK32
                self.range = (self.range << 8) & _MASK32
        return result

    # --- tree helpers (BitTreeDecoder.java:19-37) ---
    def decode_tree(self, probs: np.ndarray, base: int, num_bits: int) -> int:
        m = 1
        for _ in range(num_bits):
            m = (m << 1) | self.decode_bit(probs, base + m)
        return m - (1 << num_bits)

    def decode_tree_reverse(self, probs: np.ndarray, base: int, num_bits: int) -> int:
        m = 1
        symbol = 0
        for i in range(num_bits):
            bit = self.decode_bit(probs, base + m)
            m = (m << 1) | bit
            symbol |= bit << i
        return symbol


class CorruptStreamError(ValueError):
    """Raised when an LZMA stream is structurally invalid."""
