"""Scalar LZMA encoder with optimal parsing — the ratio-parity oracle.

Re-derivation of the reference encoder's behavior (Encoder.java:207-1184):
BT2/BT4 match search feeds a dynamic-programming parse over a 4096-node
lookahead (getOptimum, Encoder.java:364-811) that picks literal / shortRep
/ rep0-3 / match per position by minimizing cumulative prices in 1/64-bit
units, with live price tables refreshed on the reference's cadence
(matchPriceCount >= 128, alignPriceCount >= 16, len counters —
Encoder.java:914-920, LenPriceTableEncoder.java:32-37).  Byte-exact output
parity with the reference is asserted by tests/test_golden_sizes.py.

A greedy parse mode (our addition, the reference's fast mode is a stub —
Encoder.java:1127-1133) provides a fast path with the same bitstream
validity; the device backend mirrors it lane-parallel in ops/.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.constants import (
    ALIGN_MASK,
    ALIGN_TABLE_SIZE,
    END_POS_MODEL_INDEX,
    INITIAL_STATE,
    MATCH_MAX_LEN,
    MATCH_MIN_LEN,
    NUM_ALIGN_BITS,
    NUM_FULL_DISTANCES,
    NUM_LEN_TO_POS_STATES,
    NUM_POS_SLOT_BITS,
    NUM_POS_STATES_BITS_MAX,
    NUM_REP_DISTANCES,
    START_POS_MODEL_INDEX,
    NEXT_STATE_LITERAL,
    NEXT_STATE_MATCH,
    NEXT_STATE_LONGREP,
    NEXT_STATE_SHORTREP,
    len_to_pos_state,
    pos_slot,
    pos_slot2,
)
from ..core.layout import (
    LEN_CHOICE,
    LEN_CHOICE2,
    LEN_HIGH,
    LEN_LOW,
    LEN_MID,
    POS_SLOT_TREE_SIZE,
    ProbLayout,
)
from ..core.prices import INFINITY_PRICE, PRICE_TABLE, BIT_MODEL_TOTAL
from ..core.rangecoder import RangeEncoder
from ..format.properties import LzmaParams, MF_BT2, MF_BT4, MF_FAST4, MF_HC4
from ..match.bintree import BinTreeMatchFinder
from ..match.hashchain import Fast4MatchFinder, HashChainMatchFinder

_NUM_OPTS = 1 << 12          # Encoder.java:19
_NUM_LEN_SYMBOLS = 272

_NSL = NEXT_STATE_LITERAL.tolist()
_NSM = NEXT_STATE_MATCH.tolist()
_NSR = NEXT_STATE_LONGREP.tolist()
_NSS = NEXT_STATE_SHORTREP.tolist()
_PRICES = PRICE_TABLE.tolist()
_MASK = BIT_MODEL_TOTAL - 1


def _price(prob: int, bit: int) -> int:
    return _PRICES[(((prob - bit) ^ (-bit)) & _MASK) >> 2]


def _price0(prob: int) -> int:
    return _PRICES[prob >> 2]


def _price1(prob: int) -> int:
    return _PRICES[(BIT_MODEL_TOTAL - prob) >> 2]


class _Optimal:
    """One DP node (Optimal.java:3-34)."""

    __slots__ = (
        "state", "prev1_is_char", "prev2", "pos_prev2", "back_prev2",
        "price", "pos_prev", "back_prev", "backs0", "backs1", "backs2", "backs3",
    )

    def __init__(self):
        self.state = 0
        self.prev1_is_char = False
        self.prev2 = False
        self.pos_prev2 = 0
        self.back_prev2 = 0
        self.price = 0
        self.pos_prev = 0
        self.back_prev = 0
        self.backs0 = self.backs1 = self.backs2 = self.backs3 = 0

    def make_char(self):
        self.back_prev = -1
        self.prev1_is_char = False

    def make_short_rep(self):
        self.back_prev = 0
        self.prev1_is_char = False

    def is_short_rep(self):
        return self.back_prev == 0


@dataclass
class _Decision:
    """(pos, length) command: pos==-1 => literal; pos<4 => rep index; else
    pos-4 is a fresh match distance (Encoder.java PosAndLength:43-84)."""

    pos: int
    length: int


class LzmaEncoder:
    """One-shot block encoder.  `encode(data)` returns the raw LZMA stream
    (no container header)."""

    def __init__(self, params: LzmaParams, optimal: bool = True, trace=None,
                 mode: str | None = None):
        self._trace = trace  # utils.trace.CodecTrace or None
        self.params = params.validated_for_encode()
        if mode is None:
            mode = "optimal" if optimal else "greedy"
        if mode not in ("optimal", "lazy", "greedy"):
            raise ValueError(f"unknown parse mode: {mode}")
        if mode == "optimal" and params.match_finder in (MF_HC4, MF_FAST4):
            mode = "lazy"  # HC4 is the fast finder; pair it with the fast parse
        self.mode = mode
        self.optimal = mode == "optimal"
        self.layout = ProbLayout(params.lc, params.lp, params.pb)
        self.pos_state_mask = self.layout.pos_state_mask
        self.fb = params.fast_bytes
        self._optimum = [_Optimal() for _ in range(_NUM_OPTS)]
        self._pos_slot_prices = [0] * (NUM_LEN_TO_POS_STATES << NUM_POS_SLOT_BITS)
        self._distances_prices = [0] * (NUM_LEN_TO_POS_STATES * NUM_FULL_DISTANCES)
        self._align_prices = [0] * ALIGN_TABLE_SIZE
        self._len_prices = [0] * (_NUM_LEN_SYMBOLS << 4)
        self._rep_len_prices = [0] * (_NUM_LEN_SYMBOLS << 4)
        self._len_counters = [0] * 16
        self._rep_len_counters = [0] * 16
        self._len_table_size = self.fb + 1 - MATCH_MIN_LEN

    # ================================================================ setup
    def _init_state(self, data: bytes, preset: bytes = b""):
        """Reset coder state for one stream.

        `preset` primes the dictionary window (the analogue of liblzma's
        preset_dict; absent from the reference — README.md lists no
        preset API): matches and literal context may reach into it, but
        only `data` is coded and position contexts start at 0.
        """
        p = self.params
        buf = preset + data if preset else data
        self.buf = buf
        self.preset_len = len(preset)
        self.probs = self.layout.new_arena().tolist()  # python list: fast scalar access
        self.rc = RangeEncoder()
        if p.match_finder == MF_BT2:
            self.mf = BinTreeMatchFinder(buf, p.dict_size, self.fb, num_hash_bytes=2)
        elif p.match_finder == MF_BT4:
            self.mf = BinTreeMatchFinder(buf, p.dict_size, self.fb, num_hash_bytes=4)
        elif p.match_finder == MF_FAST4:
            self.mf = Fast4MatchFinder(buf, p.dict_size, self.fb)
        else:
            self.mf = HashChainMatchFinder(buf, p.dict_size, self.fb)
        if preset:
            self.mf.skip(len(preset))  # insert the preset positions
        self.state = INITIAL_STATE
        self.prev_byte = preset[-1] if preset else 0
        self.rep_distances = [0] * NUM_REP_DISTANCES
        self.now_pos = 0
        self.additional_offset = 0
        self.optimum_end_index = 0
        self.optimum_current_index = 0
        self.longest_match_found = False
        self.longest_match_length = 0
        self.longest_match_dist = 0
        self.match_distances = []
        self.num_distance_pairs = 0
        self.match_price_count = 0
        self.align_price_count = 0
        self._fill_distances_prices()
        self._fill_align_prices()
        num_pos_states = 1 << p.pb
        for ps in range(num_pos_states):
            self._update_len_table(False, ps)
            self._update_len_table(True, ps)

    # ============================================================= len coder
    def _len_base(self, is_rep: bool) -> int:
        return self.layout.rep_len_coder if is_rep else self.layout.len_coder

    def _update_len_table(self, is_rep: bool, ps: int):
        """Refresh one posState row of length prices (LenEncoder.SetPrices,
        LenEncoder.java:50-71)."""
        probs = self.probs
        base = self._len_base(is_rep)
        prices = self._rep_len_prices if is_rep else self._len_prices
        counters = self._rep_len_counters if is_rep else self._len_counters
        n = self._len_table_size
        st = ps * _NUM_LEN_SYMBOLS
        a0 = _price0(probs[base + LEN_CHOICE])
        a1 = _price1(probs[base + LEN_CHOICE])
        b0 = a1 + _price0(probs[base + LEN_CHOICE2])
        b1 = a1 + _price1(probs[base + LEN_CHOICE2])
        low = base + LEN_LOW + (ps << 3)
        mid = base + LEN_MID + (ps << 3)
        high = base + LEN_HIGH
        i = 0
        while i < 8:
            if i >= n:
                counters[ps] = n
                return
            prices[st + i] = a0 + self._tree_price(low, 3, i)
            i += 1
        while i < 16:
            if i >= n:
                counters[ps] = n
                return
            prices[st + i] = b0 + self._tree_price(mid, 3, i - 8)
            i += 1
        while i < n:
            prices[st + i] = b1 + self._tree_price(high, 8, i - 16)
            i += 1
        counters[ps] = n

    def _encode_len(self, is_rep: bool, symbol: int, ps: int):
        """LenEncoder.encode + price-counter cadence (LenEncoder.java:33-48,
        LenPriceTableEncoder.java:32-37)."""
        rc, probs = self.rc, self.probs
        base = self._len_base(is_rep)
        if symbol < 8:
            rc.encode_bit(probs, base + LEN_CHOICE, 0)
            self._encode_tree(base + LEN_LOW + (ps << 3), 3, symbol)
        else:
            rc.encode_bit(probs, base + LEN_CHOICE, 1)
            if symbol < 16:
                rc.encode_bit(probs, base + LEN_CHOICE2, 0)
                self._encode_tree(base + LEN_MID + (ps << 3), 3, symbol - 8)
            else:
                rc.encode_bit(probs, base + LEN_CHOICE2, 1)
                self._encode_tree(base + LEN_HIGH, 8, symbol - 16)
        counters = self._rep_len_counters if is_rep else self._len_counters
        counters[ps] -= 1
        if counters[ps] == 0:
            self._update_len_table(is_rep, ps)

    def _len_price(self, is_rep: bool, symbol: int, ps: int) -> int:
        prices = self._rep_len_prices if is_rep else self._len_prices
        return prices[ps * _NUM_LEN_SYMBOLS + symbol]

    # ============================================================ tree utils
    def _encode_tree(self, base: int, nbits: int, symbol: int):
        self.rc.encode_tree(self.probs, base, nbits, symbol)

    def _tree_price(self, base: int, nbits: int, symbol: int) -> int:
        probs = self.probs
        price = 0
        m = 1
        for i in range(nbits - 1, -1, -1):
            bit = (symbol >> i) & 1
            price += _price(probs[base + m], bit)
            m = (m << 1) + bit
        return price

    def _reverse_tree_price(self, base: int, nbits: int, symbol: int) -> int:
        probs = self.probs
        price = 0
        m = 1
        for _ in range(nbits):
            bit = symbol & 1
            symbol >>= 1
            price += _price(probs[base + m], bit)
            m = (m << 1) | bit
        return price

    # ========================================================== literal coder
    def _literal_base(self, pos: int, prev_byte: int) -> int:
        return self.layout.literal_sub(pos, prev_byte)

    def _literal_price(self, sub: int, match_mode: bool, match_byte: int, symbol: int) -> int:
        """LiteralEncoder.Encoder2.GetPrice (LiteralEncoder.java:42-64)."""
        probs = self.probs
        price = 0
        context = 1
        i = 7
        if match_mode:
            while i >= 0:
                match_bit = (match_byte >> i) & 1
                bit = (symbol >> i) & 1
                price += _price(probs[sub + ((1 + match_bit) << 8) + context], bit)
                context = (context << 1) | bit
                if match_bit != bit:
                    i -= 1
                    break
                i -= 1
        while i >= 0:
            bit = (symbol >> i) & 1
            price += _price(probs[sub + context], bit)
            context = (context << 1) | bit
            i -= 1
        return price

    def _encode_literal(self, sub: int, symbol: int):
        rc, probs = self.rc, self.probs
        context = 1
        for i in range(7, -1, -1):
            bit = (symbol >> i) & 1
            rc.encode_bit(probs, sub + context, bit)
            context = (context << 1) | bit

    def _encode_literal_matched(self, sub: int, match_byte: int, symbol: int):
        rc, probs = self.rc, self.probs
        context = 1
        same = True
        for i in range(7, -1, -1):
            bit = (symbol >> i) & 1
            state = context
            if same:
                match_bit = (match_byte >> i) & 1
                state += (1 + match_bit) << 8
                same = match_bit == bit
            rc.encode_bit(probs, sub + state, bit)
            context = (context << 1) | bit

    # ========================================================= price tables
    def _fill_distances_prices(self):
        """Encoder.FillDistancesPrices (Encoder.java:1087-1118)."""
        probs = self.probs
        L = self.layout
        temp = [0] * NUM_FULL_DISTANCES
        for i in range(START_POS_MODEL_INDEX, NUM_FULL_DISTANCES):
            slot = pos_slot(i)
            footer_bits = (slot >> 1) - 1
            base_val = (2 | (slot & 1)) << footer_bits
            # startIndex = baseVal - posSlot - 1 into the spec_pos slab, with
            # tree node m starting at 1 (Encoder.java:1092-1093).
            temp[i] = self._reverse_tree_price(
                L.spec_pos + base_val - slot - 1, footer_bits, i - base_val
            )
        dist_table_size = self.params.dist_table_size
        for lps in range(NUM_LEN_TO_POS_STATES):
            tree = L.pos_slot + lps * POS_SLOT_TREE_SIZE
            st = lps << NUM_POS_SLOT_BITS
            for slot in range(dist_table_size):
                self._pos_slot_prices[st + slot] = self._tree_price(tree, 6, slot)
            for slot in range(END_POS_MODEL_INDEX, dist_table_size):
                self._pos_slot_prices[st + slot] += ((slot >> 1) - 1 - NUM_ALIGN_BITS) << 6
            st2 = lps * NUM_FULL_DISTANCES
            for i in range(START_POS_MODEL_INDEX):
                self._distances_prices[st2 + i] = self._pos_slot_prices[st + i]
            for i in range(START_POS_MODEL_INDEX, NUM_FULL_DISTANCES):
                self._distances_prices[st2 + i] = (
                    self._pos_slot_prices[st + pos_slot(i)] + temp[i]
                )
        self.match_price_count = 0

    def _fill_align_prices(self):
        for i in range(ALIGN_TABLE_SIZE):
            self._align_prices[i] = self._reverse_tree_price(
                self.layout.align, NUM_ALIGN_BITS, i
            )
        self.align_price_count = 0

    # ===================================================== optimum: helpers
    def _rep_len1_price(self, state: int, ps: int) -> int:
        probs = self.probs
        L = self.layout
        return _price0(probs[L.is_rep_g0 + state]) + _price0(
            probs[L.is_rep0_long + (state << NUM_POS_STATES_BITS_MAX) + ps]
        )

    def _pure_rep_price(self, rep_index: int, state: int, ps: int) -> int:
        probs = self.probs
        L = self.layout
        if rep_index == 0:
            price = _price0(probs[L.is_rep_g0 + state])
            price += _price1(probs[L.is_rep0_long + (state << NUM_POS_STATES_BITS_MAX) + ps])
        else:
            price = _price1(probs[L.is_rep_g0 + state])
            if rep_index == 1:
                price += _price0(probs[L.is_rep_g1 + state])
            else:
                price += _price1(probs[L.is_rep_g1 + state])
                price += _price(probs[L.is_rep_g2 + state], rep_index - 2)
        return price

    def _rep_price(self, rep_index: int, length: int, state: int, ps: int) -> int:
        return self._len_price(True, length - MATCH_MIN_LEN, ps) + self._pure_rep_price(
            rep_index, state, ps
        )

    def _pos_len_price(self, dist: int, length: int, ps: int) -> int:
        lps = len_to_pos_state(length)
        if dist < NUM_FULL_DISTANCES:
            price = self._distances_prices[lps * NUM_FULL_DISTANCES + dist]
        else:
            price = (
                self._pos_slot_prices[(lps << NUM_POS_SLOT_BITS) + pos_slot2(dist)]
                + self._align_prices[dist & ALIGN_MASK]
            )
        return price + self._len_price(False, length - MATCH_MIN_LEN, ps)

    def _read_match_distances(self) -> int:
        """ReadMatchDistances (Encoder.java:275-287)."""
        self.match_distances = self.mf.find_matches()
        if self._trace is not None and self._trace.enabled:
            self._trace.matches(self.mf.pos - 1, self.match_distances)
        self.num_distance_pairs = len(self.match_distances)
        length = 0
        if self.num_distance_pairs > 0:
            last = self.match_distances[-1]
            length = last[0]
            if length == self.fb:
                length += self.mf.get_match_len(length - 1, last[1], MATCH_MAX_LEN - length)
        self.additional_offset += 1
        return length

    def _move_pos(self, num: int):
        if num > 0:
            self.mf.skip(num)
            self.additional_offset += num

    # ======================================================= optimal parse
    def _backward(self, cur: int) -> _Decision:
        """Path reconstruction (Encoder.Backward, Encoder.java:335-362)."""
        opt = self._optimum
        self.optimum_end_index = cur
        pos_mem = opt[cur].pos_prev
        back_mem = opt[cur].back_prev
        while True:
            if opt[cur].prev1_is_char:
                opt[pos_mem].make_char()
                opt[pos_mem].pos_prev = pos_mem - 1
                if opt[cur].prev2:
                    opt[pos_mem - 1].prev1_is_char = False
                    opt[pos_mem - 1].pos_prev = opt[cur].pos_prev2
                    opt[pos_mem - 1].back_prev = opt[cur].back_prev2
            pos_prev = pos_mem
            back_cur = back_mem
            back_mem = opt[pos_prev].back_prev
            pos_mem = opt[pos_prev].pos_prev
            opt[pos_prev].back_prev = back_cur
            opt[pos_prev].pos_prev = cur
            cur = pos_prev
            if cur <= 0:
                break
        self.optimum_current_index = opt[0].pos_prev
        return _Decision(opt[0].back_prev, self.optimum_current_index)

    def _get_optimum(self, position: int) -> _Decision:
        """The DP parse (Encoder.getOptimum, Encoder.java:364-811)."""
        opt = self._optimum
        if self.optimum_end_index != self.optimum_current_index:
            cur_i = self.optimum_current_index
            len_res = opt[cur_i].pos_prev - cur_i
            len_pos = opt[cur_i].back_prev
            self.optimum_current_index = opt[cur_i].pos_prev
            return _Decision(len_pos, len_res)
        self.optimum_current_index = self.optimum_end_index = 0

        if self.longest_match_found:
            len_main = self.longest_match_length
            self.longest_match_found = False
        else:
            len_main = self._read_match_distances()
        num_pairs = self.num_distance_pairs
        mf = self.mf
        probs = self.probs
        L = self.layout
        fb = self.fb

        num_avail = mf.available() + 1
        if num_avail < 2:
            return _Decision(-1, 1)
        if num_avail > MATCH_MAX_LEN:
            num_avail = MATCH_MAX_LEN

        reps = [0] * NUM_REP_DISTANCES
        rep_lens = [0] * NUM_REP_DISTANCES
        rep_max_index = 0
        for i in range(NUM_REP_DISTANCES):
            reps[i] = self.rep_distances[i]
            rep_lens[i] = mf.get_match_len(-1, reps[i], MATCH_MAX_LEN)
            if rep_lens[i] > rep_lens[rep_max_index]:
                rep_max_index = i
        if rep_lens[rep_max_index] >= fb:
            len_res = rep_lens[rep_max_index]
            self._move_pos(len_res - 1)
            return _Decision(rep_max_index, len_res)

        if len_main >= fb:
            pos = self.match_distances[-1][1] + NUM_REP_DISTANCES
            self._move_pos(len_main - 1)
            return _Decision(pos, len_main)

        current_byte = mf.get_byte(-1)
        match_byte = mf.get_byte(-self.rep_distances[0] - 2)

        if len_main < 2 and current_byte != match_byte and rep_lens[rep_max_index] < 2:
            return _Decision(-1, 1)

        opt[0].state = self.state
        ps = position & self.pos_state_mask

        is_match_idx = L.is_match + (self.state << NUM_POS_STATES_BITS_MAX) + ps
        sub = self._literal_base(position, self.prev_byte)
        opt[1].price = _price0(probs[is_match_idx]) + self._literal_price(
            sub, self.state >= 7, match_byte, current_byte
        )
        opt[1].make_char()

        match_price = _price1(probs[is_match_idx])
        rep_match_price = match_price + _price1(probs[L.is_rep + self.state])

        if match_byte == current_byte:
            short_rep_price = rep_match_price + self._rep_len1_price(self.state, ps)
            if short_rep_price < opt[1].price:
                opt[1].price = short_rep_price
                opt[1].make_short_rep()

        len_end = len_main if len_main >= rep_lens[rep_max_index] else rep_lens[rep_max_index]
        if len_end < 2:
            return _Decision(opt[1].back_prev, 1)

        opt[1].pos_prev = 0
        opt[0].backs0, opt[0].backs1, opt[0].backs2, opt[0].backs3 = reps

        for ln in range(len_end, 1, -1):
            opt[ln].price = INFINITY_PRICE

        for i in range(NUM_REP_DISTANCES):
            rep_len = rep_lens[i]
            if rep_len < 2:
                continue
            price = rep_match_price + self._pure_rep_price(i, self.state, ps)
            while rep_len >= 2:
                cur_and_len_price = price + self._len_price(True, rep_len - 2, ps)
                o = opt[rep_len]
                if cur_and_len_price < o.price:
                    o.price = cur_and_len_price
                    o.pos_prev = 0
                    o.back_prev = i
                    o.prev1_is_char = False
                rep_len -= 1

        normal_match_price = match_price + _price0(probs[L.is_rep + self.state])
        ln = rep_lens[0] + 1 if rep_lens[0] >= 2 else 2
        if ln <= len_main:
            offs = 0
            md = self.match_distances
            while ln > md[offs][0]:
                offs += 1
            while True:
                distance = md[offs][1]
                cur_and_len_price = normal_match_price + self._pos_len_price(distance, ln, ps)
                o = opt[ln]
                if cur_and_len_price < o.price:
                    o.price = cur_and_len_price
                    o.pos_prev = 0
                    o.back_prev = distance + NUM_REP_DISTANCES
                    o.prev1_is_char = False
                if ln == md[offs][0]:
                    offs += 1
                    if offs == num_pairs:
                        break
                ln += 1

        cur = 0
        while True:
            cur += 1
            if cur == len_end:
                return self._backward(cur)
            new_len = self._read_match_distances()
            num_pairs = self.num_distance_pairs
            if new_len >= fb:
                self.longest_match_length = new_len
                self.longest_match_found = True
                return self._backward(cur)
            position += 1
            o_cur = opt[cur]
            pos_prev = o_cur.pos_prev
            if o_cur.prev1_is_char:
                pos_prev -= 1
                if o_cur.prev2:
                    state = opt[o_cur.pos_prev2].state
                    if o_cur.back_prev2 < NUM_REP_DISTANCES:
                        state = _NSR[state]
                    else:
                        state = _NSM[state]
                else:
                    state = opt[pos_prev].state
                state = _NSL[state]
            else:
                state = opt[pos_prev].state
            if pos_prev == cur - 1:
                if o_cur.is_short_rep():
                    state = _NSS[state]
                else:
                    state = _NSL[state]
            else:
                if o_cur.prev1_is_char and o_cur.prev2:
                    pos_prev = o_cur.pos_prev2
                    pos = o_cur.back_prev2
                    state = _NSR[state]
                else:
                    pos = o_cur.back_prev
                    if pos < NUM_REP_DISTANCES:
                        state = _NSR[state]
                    else:
                        state = _NSM[state]
                o_prev = opt[pos_prev]
                if pos < NUM_REP_DISTANCES:
                    if pos == 0:
                        reps = [o_prev.backs0, o_prev.backs1, o_prev.backs2, o_prev.backs3]
                    elif pos == 1:
                        reps = [o_prev.backs1, o_prev.backs0, o_prev.backs2, o_prev.backs3]
                    elif pos == 2:
                        reps = [o_prev.backs2, o_prev.backs0, o_prev.backs1, o_prev.backs3]
                    else:
                        reps = [o_prev.backs3, o_prev.backs0, o_prev.backs1, o_prev.backs2]
                else:
                    reps = [pos - NUM_REP_DISTANCES, o_prev.backs0, o_prev.backs1, o_prev.backs2]
            o_cur.state = state
            o_cur.backs0, o_cur.backs1, o_cur.backs2, o_cur.backs3 = reps
            cur_price = o_cur.price

            current_byte = mf.get_byte(-1)
            match_byte = mf.get_byte(-reps[0] - 2)
            ps = position & self.pos_state_mask

            is_match_idx = L.is_match + (state << NUM_POS_STATES_BITS_MAX) + ps
            sub = self._literal_base(position, mf.get_byte(-2))
            cur_and_1_price = (
                cur_price
                + _price0(probs[is_match_idx])
                + self._literal_price(sub, state >= 7, match_byte, current_byte)
            )

            next_opt = opt[cur + 1]
            next_is_char = False
            if cur_and_1_price < next_opt.price:
                next_opt.price = cur_and_1_price
                next_opt.pos_prev = cur
                next_opt.make_char()
                next_is_char = True

            match_price = cur_price + _price1(probs[is_match_idx])
            rep_match_price = match_price + _price1(probs[L.is_rep + state])

            if match_byte == current_byte and not (
                next_opt.pos_prev < cur and next_opt.back_prev == 0
            ):
                short_rep_price = rep_match_price + self._rep_len1_price(state, ps)
                if short_rep_price <= next_opt.price:
                    next_opt.price = short_rep_price
                    next_opt.pos_prev = cur
                    next_opt.make_short_rep()
                    next_is_char = True

            num_avail_full = mf.available() + 1
            if num_avail_full > _NUM_OPTS - 1 - cur:
                num_avail_full = _NUM_OPTS - 1 - cur
            num_avail = num_avail_full
            if num_avail < 2:
                continue
            if num_avail > fb:
                num_avail = fb

            if not next_is_char and match_byte != current_byte:
                # try literal + rep0 (Encoder.java:637-664)
                t = min(num_avail_full - 1, fb)
                len_test2 = mf.get_match_len(0, reps[0], t)
                if len_test2 >= 2:
                    state2 = _NSL[state]
                    ps_next = (position + 1) & self.pos_state_mask
                    next_rep_match_price = (
                        cur_and_1_price
                        + _price1(probs[L.is_match + (state2 << NUM_POS_STATES_BITS_MAX) + ps_next])
                        + _price1(probs[L.is_rep + state2])
                    )
                    offset = cur + 1 + len_test2
                    while len_end < offset:
                        len_end += 1
                        opt[len_end].price = INFINITY_PRICE
                    cur_and_len_price = next_rep_match_price + self._rep_price(
                        0, len_test2, state2, ps_next
                    )
                    o = opt[offset]
                    if cur_and_len_price < o.price:
                        o.price = cur_and_len_price
                        o.pos_prev = cur + 1
                        o.back_prev = 0
                        o.prev1_is_char = True
                        o.prev2 = False

            start_len = 2

            for rep_index in range(NUM_REP_DISTANCES):
                len_test = mf.get_match_len(-1, reps[rep_index], num_avail)
                if len_test < 2:
                    continue
                len_test_temp = len_test
                while True:
                    while len_end < cur + len_test:
                        len_end += 1
                        opt[len_end].price = INFINITY_PRICE
                    cur_and_len_price = rep_match_price + self._rep_price(
                        rep_index, len_test, state, ps
                    )
                    o = opt[cur + len_test]
                    if cur_and_len_price < o.price:
                        o.price = cur_and_len_price
                        o.pos_prev = cur
                        o.back_prev = rep_index
                        o.prev1_is_char = False
                    len_test -= 1
                    if len_test < 2:
                        break
                len_test = len_test_temp

                if rep_index == 0:
                    start_len = len_test + 1

                # rep + literal + rep0 two-step lookahead (Encoder.java:696-734)
                if len_test < num_avail_full:
                    t = min(num_avail_full - 1 - len_test, fb)
                    len_test2 = mf.get_match_len(len_test, reps[rep_index], t)
                    if len_test2 >= 2:
                        state2 = _NSR[state]
                        ps_next = (position + len_test) & self.pos_state_mask
                        cur_and_len_char_price = (
                            rep_match_price
                            + self._rep_price(rep_index, len_test, state, ps)
                            + _price0(
                                probs[L.is_match + (state2 << NUM_POS_STATES_BITS_MAX) + ps_next]
                            )
                            + self._literal_price(
                                self._literal_base(position + len_test, mf.get_byte(len_test - 2)),
                                True,
                                mf.get_byte(len_test - 1 - (reps[rep_index] + 1)),
                                mf.get_byte(len_test - 1),
                            )
                        )
                        state2 = _NSL[state2]
                        ps_next2 = (position + len_test + 1) & self.pos_state_mask
                        next_match_price = cur_and_len_char_price + _price1(
                            probs[L.is_match + (state2 << NUM_POS_STATES_BITS_MAX) + ps_next2]
                        )
                        next_rep_match_price = next_match_price + _price1(
                            probs[L.is_rep + state2]
                        )
                        offset = len_test + 1 + len_test2
                        while len_end < cur + offset:
                            len_end += 1
                            opt[len_end].price = INFINITY_PRICE
                        cur_and_len_price = next_rep_match_price + self._rep_price(
                            0, len_test2, state2, ps_next2
                        )
                        o = opt[cur + offset]
                        if cur_and_len_price < o.price:
                            o.price = cur_and_len_price
                            o.pos_prev = cur + len_test + 1
                            o.back_prev = 0
                            o.prev1_is_char = True
                            o.prev2 = True
                            o.pos_prev2 = cur
                            o.back_prev2 = rep_index

            if new_len > num_avail:
                new_len = num_avail
                num_pairs = 0
                while new_len > self.match_distances[num_pairs][0]:
                    num_pairs += 1
                self.match_distances[num_pairs][0] = new_len
                num_pairs += 1
            if new_len >= start_len:
                normal_match_price = match_price + _price0(probs[L.is_rep + state])
                while len_end < cur + new_len:
                    len_end += 1
                    opt[len_end].price = INFINITY_PRICE

                md = self.match_distances
                offs = 0
                while start_len > md[offs][0]:
                    offs += 1

                len_test = start_len
                while True:
                    cur_back = md[offs][1]
                    cur_and_len_price = normal_match_price + self._pos_len_price(
                        cur_back, len_test, ps
                    )
                    o = opt[cur + len_test]
                    if cur_and_len_price < o.price:
                        o.price = cur_and_len_price
                        o.pos_prev = cur
                        o.back_prev = cur_back + NUM_REP_DISTANCES
                        o.prev1_is_char = False

                    if len_test == md[offs][0]:
                        # match + literal + rep0 lookahead (Encoder.java:766-801)
                        if len_test < num_avail_full:
                            t = min(num_avail_full - 1 - len_test, fb)
                            len_test2 = mf.get_match_len(len_test, cur_back, t)
                            if len_test2 >= 2:
                                state2 = _NSM[state]
                                ps_next = (position + len_test) & self.pos_state_mask
                                cur_and_len_char_price = (
                                    cur_and_len_price
                                    + _price0(
                                        probs[
                                            L.is_match
                                            + (state2 << NUM_POS_STATES_BITS_MAX)
                                            + ps_next
                                        ]
                                    )
                                    + self._literal_price(
                                        self._literal_base(
                                            position + len_test, mf.get_byte(len_test - 2)
                                        ),
                                        True,
                                        mf.get_byte(len_test - (cur_back + 1) - 1),
                                        mf.get_byte(len_test - 1),
                                    )
                                )
                                state2 = _NSL[state2]
                                ps_next2 = (position + len_test + 1) & self.pos_state_mask
                                next_match_price = cur_and_len_char_price + _price1(
                                    probs[
                                        L.is_match + (state2 << NUM_POS_STATES_BITS_MAX) + ps_next2
                                    ]
                                )
                                next_rep_match_price = next_match_price + _price1(
                                    probs[L.is_rep + state2]
                                )
                                offset = len_test + 1 + len_test2
                                while len_end < cur + offset:
                                    len_end += 1
                                    opt[len_end].price = INFINITY_PRICE
                                cur_and_len_price2 = next_rep_match_price + self._rep_price(
                                    0, len_test2, state2, ps_next2
                                )
                                o = opt[cur + offset]
                                if cur_and_len_price2 < o.price:
                                    o.price = cur_and_len_price2
                                    o.pos_prev = cur + len_test + 1
                                    o.back_prev = 0
                                    o.prev1_is_char = True
                                    o.prev2 = True
                                    o.pos_prev2 = cur
                                    o.back_prev2 = cur_back + NUM_REP_DISTANCES
                        offs += 1
                        if offs == num_pairs:
                            break
                    len_test += 1

    # ======================================================== lazy parse
    def _get_lazy(self, position: int) -> _Decision:
        """One-position-lookahead parse (our mode; the reference's fast
        mode is a stub, Encoder.java:1127-1133).  Takes the best of
        {match, rep} at the current position unless the next position
        offers a strictly longer match, in which case it defers with a
        literal — the classic LZ77 lazy evaluation."""
        mf = self.mf
        if self.longest_match_found:
            len_main = self.longest_match_length
            main_dist = self.longest_match_dist
            self.longest_match_found = False
        else:
            len_main = self._read_match_distances()
            main_dist = self.match_distances[-1][1] if self.num_distance_pairs else 0
        num_avail = mf.available() + 1
        if num_avail < 2:
            return _Decision(-1, 1)

        best_rep_len = 0
        best_rep_idx = 0
        for i in range(NUM_REP_DISTANCES):
            l = mf.get_match_len(-1, self.rep_distances[i], MATCH_MAX_LEN)
            if l > best_rep_len:
                best_rep_len = l
                best_rep_idx = i

        # candidate: prefer reps at near-equal length (cheaper to code)
        if best_rep_len >= 2 and best_rep_len + 1 >= len_main:
            cand_len, cand_pos, cand_dist = best_rep_len, best_rep_idx, -1
        elif len_main >= 2:
            cand_len, cand_pos, cand_dist = len_main, main_dist + NUM_REP_DISTANCES, main_dist
        else:
            cur_byte = mf.get_byte(-1)
            match_byte = mf.get_byte(-self.rep_distances[0] - 2)
            return _Decision(0, 1) if cur_byte == match_byte else _Decision(-1, 1)

        if cand_len >= self.fb or num_avail <= 2:
            self._move_pos(cand_len - 1)
            return _Decision(cand_pos, cand_len)

        # peek one position ahead
        next_len = self._read_match_distances()
        next_dist = self.match_distances[-1][1] if self.num_distance_pairs else 0
        if next_len > cand_len or (
            next_len == cand_len and cand_dist >= 0 and next_dist * 64 < cand_dist
        ):
            self.longest_match_found = True
            self.longest_match_length = next_len
            self.longest_match_dist = next_dist
            cur_byte = mf.get_byte(-2)
            match_byte = mf.get_byte(-self.rep_distances[0] - 3)
            return _Decision(0, 1) if cur_byte == match_byte else _Decision(-1, 1)
        self._move_pos(cand_len - 2)
        return _Decision(cand_pos, cand_len)

    # ====================================================== greedy parse
    def _get_greedy(self, position: int) -> _Decision:
        """Fast lazy-ish parse: longest of {best match, best rep}, preferring
        reps at equal length; one-byte literal otherwise.  Valid LZMA, lower
        ratio — our analogue of the reference's (stubbed) fast mode."""
        if self.longest_match_found:
            len_main = self.longest_match_length
            self.longest_match_found = False
        else:
            len_main = self._read_match_distances()
        mf = self.mf
        num_avail = mf.available() + 1
        if num_avail < 2:
            return _Decision(-1, 1)

        best_rep_len = 0
        best_rep_idx = 0
        for i in range(NUM_REP_DISTANCES):
            l = mf.get_match_len(-1, self.rep_distances[i], MATCH_MAX_LEN)
            if l > best_rep_len:
                best_rep_len = l
                best_rep_idx = i

        if best_rep_len >= 2 and best_rep_len + 1 >= len_main:
            self._move_pos(best_rep_len - 1)
            return _Decision(best_rep_idx, best_rep_len)
        if len_main >= 2:
            dist = self.match_distances[-1][1]
            self._move_pos(len_main - 1)
            return _Decision(dist + NUM_REP_DISTANCES, len_main)
        cur_byte = mf.get_byte(-1)
        match_byte = mf.get_byte(-self.rep_distances[0] - 2)
        if cur_byte == match_byte:
            return _Decision(0, 1)  # short rep
        return _Decision(-1, 1)

    # ========================================================== main loop
    def encode(self, data: bytes, progress=None, preset: bytes = b"") -> bytes:
        """Encode one block; returns the raw LZMA stream (flushed).

        With a `preset` dictionary the first byte is NOT force-coded as a
        literal (history exists, so matches are legal from position 0).
        """
        self._init_state(data, preset)
        rc, probs = self.rc, self.probs
        L = self.layout
        get = {"optimal": self._get_optimum, "lazy": self._get_lazy,
               "greedy": self._get_greedy}[self.mode]

        if not preset and self.mf.available() > 0:
            # first byte forced literal (Encoder.java:860-877)
            self._read_match_distances()
            ps = 0
            rc.encode_bit(probs, L.is_match + (self.state << NUM_POS_STATES_BITS_MAX) + ps, 0)
            self.state = _NSL[self.state]
            cur_byte = self.mf.get_byte(-self.additional_offset)
            self._encode_literal(self._literal_base(0, self.prev_byte), cur_byte)
            self.prev_byte = cur_byte
            self.additional_offset -= 1
            self.now_pos = 1

        if self.mf.available() > 0:
            last_report = 0
            while True:
                decision = get(self.now_pos)
                if self._trace is not None and self._trace.enabled:
                    self._trace.symbol(self.now_pos, decision)
                ps = self.now_pos & self.pos_state_mask
                complex_state = (self.state << NUM_POS_STATES_BITS_MAX) + ps
                if decision.pos == -1 and decision.length == 1:
                    rc.encode_bit(probs, L.is_match + complex_state, 0)
                    self._emit_literal(complex_state)
                else:
                    rc.encode_bit(probs, L.is_match + complex_state, 1)
                    if decision.pos < NUM_REP_DISTANCES:
                        self._emit_rep(decision, ps, complex_state)
                    else:
                        self._emit_match(decision, ps)
                    self.prev_byte = self.mf.get_byte(
                        decision.length - 1 - self.additional_offset
                    )
                self.additional_offset -= decision.length
                self.now_pos += decision.length
                if self.additional_offset == 0:
                    if self.optimal:
                        if self.match_price_count >= (1 << 7):
                            self._fill_distances_prices()
                        if self.align_price_count >= ALIGN_TABLE_SIZE:
                            self._fill_align_prices()
                    if self.mf.available() == 0:
                        break
                    if progress is not None and self.now_pos - last_report >= (1 << 12):
                        progress(self.now_pos, rc.processed_size())
                        last_report = self.now_pos

        self._write_end_marker(self.now_pos & self.pos_state_mask)
        rc.flush()
        return bytes(rc.out)

    def _emit_literal(self, complex_state: int):
        """encodeSingleByteLiteral (Encoder.java:1007-1024)."""
        mf = self.mf
        cur_byte = mf.get_byte(-self.additional_offset)
        sub = self._literal_base(self.now_pos, self.prev_byte)
        if self.state < 7:
            self._encode_literal(sub, cur_byte)
        else:
            match_byte = mf.get_byte(-self.rep_distances[0] - 1 - self.additional_offset)
            self._encode_literal_matched(sub, match_byte, cur_byte)
        self.prev_byte = cur_byte
        self.state = _NSL[self.state]

    def _emit_rep(self, d: _Decision, ps: int, complex_state: int):
        """encodeARepetition (Encoder.java:938-974)."""
        rc, probs = self.rc, self.probs
        L = self.layout
        pos = d.pos
        rc.encode_bit(probs, L.is_rep + self.state, 1)
        if pos == 0:
            rc.encode_bit(probs, L.is_rep_g0 + self.state, 0)
            rc.encode_bit(probs, L.is_rep0_long + complex_state, 0 if d.length == 1 else 1)
        else:
            rc.encode_bit(probs, L.is_rep_g0 + self.state, 1)
            if pos == 1:
                rc.encode_bit(probs, L.is_rep_g1 + self.state, 0)
            else:
                rc.encode_bit(probs, L.is_rep_g1 + self.state, 1)
                rc.encode_bit(probs, L.is_rep_g2 + self.state, pos - 2)
        if d.length == 1:
            self.state = _NSS[self.state]
        else:
            self._encode_len(True, d.length - MATCH_MIN_LEN, ps)
            self.state = _NSR[self.state]
        distance = self.rep_distances[pos]
        if pos != 0:
            for i in range(pos, 0, -1):
                self.rep_distances[i] = self.rep_distances[i - 1]
            self.rep_distances[0] = distance

    def _emit_match(self, d: _Decision, ps: int):
        """encodeAMatch (Encoder.java:976-1005)."""
        rc, probs = self.rc, self.probs
        L = self.layout
        rc.encode_bit(probs, L.is_rep + self.state, 0)
        self.state = _NSM[self.state]
        self._encode_len(False, d.length - MATCH_MIN_LEN, ps)
        pos = d.pos - NUM_REP_DISTANCES
        slot = pos_slot(pos)
        self._encode_tree(
            L.pos_slot + len_to_pos_state(d.length) * POS_SLOT_TREE_SIZE, 6, slot
        )
        if slot >= START_POS_MODEL_INDEX:
            footer_bits = (slot >> 1) - 1
            base_val = (2 | (slot & 1)) << footer_bits
            pos_reduced = pos - base_val
            if slot < END_POS_MODEL_INDEX:
                rc.encode_tree_reverse(
                    probs, L.spec_pos + base_val - slot - 1, footer_bits, pos_reduced
                )
            else:
                rc.encode_direct_bits(pos_reduced >> NUM_ALIGN_BITS, footer_bits - NUM_ALIGN_BITS)
                rc.encode_tree_reverse(probs, L.align, NUM_ALIGN_BITS, pos_reduced & ALIGN_MASK)
                self.align_price_count += 1
        for i in range(NUM_REP_DISTANCES - 1, 0, -1):
            self.rep_distances[i] = self.rep_distances[i - 1]
        self.rep_distances[0] = pos
        self.match_price_count += 1

    def _write_end_marker(self, ps: int):
        """WriteEndMarker (Encoder.java:818-835)."""
        if not self.params.write_eos:
            return
        rc, probs = self.rc, self.probs
        L = self.layout
        rc.encode_bit(probs, L.is_match + (self.state << NUM_POS_STATES_BITS_MAX) + ps, 1)
        rc.encode_bit(probs, L.is_rep + self.state, 0)
        self.state = _NSM[self.state]
        self._encode_len(False, 0, ps)
        slot = (1 << NUM_POS_SLOT_BITS) - 1
        self._encode_tree(
            L.pos_slot + len_to_pos_state(MATCH_MIN_LEN) * POS_SLOT_TREE_SIZE, 6, slot
        )
        pos_reduced = (1 << 30) - 1
        rc.encode_direct_bits(pos_reduced >> NUM_ALIGN_BITS, 30 - NUM_ALIGN_BITS)
        rc.encode_tree_reverse(probs, L.align, NUM_ALIGN_BITS, pos_reduced & ALIGN_MASK)


def encode_stream(data: bytes, params: LzmaParams, optimal: bool = True,
                  mode: str | None = None, preset: bytes = b"") -> bytes:
    """One-shot raw-stream encode (optionally with a preset dictionary)."""
    return LzmaEncoder(params, optimal=optimal, mode=mode).encode(data, preset=preset)


def encode_alone(data: bytes, params: LzmaParams, optimal: bool = True,
                 mode: str | None = None) -> bytes:
    """Full `.lzma` container encode (LzmaAlone.java:208-218)."""
    size = (-1 if params.write_eos else len(data)) & 0xFFFFFFFFFFFFFFFF
    return (
        params.encode_props()
        + size.to_bytes(8, "little")
        + encode_stream(data, params, optimal=optimal, mode=mode)
    )
