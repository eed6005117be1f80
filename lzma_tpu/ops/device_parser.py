"""Lane-parallel on-device optimal-parse DP (SURVEY §7 step 5).

The reference's getOptimum (Encoder.java:364-811) is a serial
dynamic program whose prices come from live adaptive probabilities.
The lane-parallel formulation keeps only the position order serial —
ONE loop over block positions — and moves everything else into vector
work across lanes:

  pass A   lazy tokenize + bit lowering (the existing GB/s pipeline:
           device_matcher.tokenize -> classify_tokens -> lower_tokens)
           yields each block's OWN (ctx, bit) stream — the block's
           empirical statistics per probability slot
  pass B   empirical probabilities -> price planes and every price
           table the DP needs (per-position literal cost, length
           tables, per-candidate distance cost), fully vectorized over
           lanes x positions.  This replaces the reference's adaptive
           price refresh (FillDistancesPrices / UpdateTable,
           Encoder.java:1087-1125): instead of chasing the coder's
           probabilities through time, the parse prices against the
           block's realized bit statistics — a fixed point of the same
           quantity the adaptation converges to
  pass C   the DP scan: at each position the relaxation over
           (candidate pair x length) is one vectorized window-min
           across every lane at once; nodes carry the reference
           Optimal fields (state, rep0) finalized on the scan frontier
           exactly like Encoder.java:1261-1305
  pass D   path extraction by pointer doubling + prefix-sum compaction
           (no serial walk), token layout as in device_matcher._compact

The host then range-codes the winning token stream with the exact
adaptive coder (runtime TokenEncoder) — prices only steer the parse,
so the approximation never threatens stream validity, and rep-priced
coding of any token whose distance matches the live rep set is
automatic.
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
from ..core.prices import BIT_MODEL_TOTAL, PRICE_TABLE

INF = 0x0FFFFFFF  # python int: jnp scalars would be captured tracers in pallas
REP_FLAG = 1 << 30
DIST_MASK = (1 << 30) - 1

#: candidate pairs fed to the DP per position (ascending lengths, each at
#: its minimal distance; the longest list entry is always kept)
DEFAULT_M_DP = 4

#: search right-sizing: unique candidates per position kept before the
#: LCP queries, in round-robin TIER priority (every tier's rank-1
#: candidate first, then rank-2, ... — "rr"): crowded rows keep each
#: seed length's nearest finds, so truncation costs ~nothing.  Measured
#: (tools/mcap_sweep.py, frozen 1 MB, fb32, deep ladder, container
#: bytes vs bt4-opt): off 239964; rr cap16/cap20 239964 (IDENTICAL);
#: rr cap12 +9 B; nearest-first cap16 was +365 B and cap12 +1.5 KB.
#: cap12 cuts ~59% of the query+merge gather volume (the chip search's
#: dominant cost).  The exact-parity hybrid path keeps m_cap=0.
DP_M_CAP = 12
DP_M_CAP_ORDER = "rr"

#: the hybrid-optimal deep tier ladder (ops/hybrid.DEFAULT_TIERS) as a
#: static tiers_key for the DP pipeline
DP_TIERS = (("k4", 12), ("k6", 4), ("k8", 6), ("k16", 3), ("k32", 2))


# ------------------------------------------------------------- pass B
#: additive-smoothing pseudo-count for the empirical probability model.
#: Measured sweep on the frozen corpus (16 x 64 KB, n_iter=3, container
#: size vs bt4-opt): a=1 +0.87%, a=4 +0.76%, a=16/32 +0.69% (knee),
#: a=128 +0.93%; the synthetic corpus agrees (-0.22% at a=16).  Low-count
#: slots otherwise price too confidently — the adaptive coder never
#: reaches extreme probabilities that fast (its own update shifts 1/32
#: per bit toward the observation, RangeBase.java:7).
EMP_ALPHA = 16


def empirical_probs(ctx, bits, totals, arena_size: int, alpha: int = EMP_ALPHA):
    """Per-slot probability estimates from a lowered (ctx, bit) stream.

    ctx, bits: (L, B) int32; totals: (L,).  Returns (L, S) int32 probs in
    the coder's 11-bit scale, clamped to the adaptive coder's reachable
    band; unseen slots keep the 1024 init (RangeBase.java:9-13);
    `alpha` pseudo-counts pull low-evidence slots toward 1/2."""
    L, B = ctx.shape
    lanes2 = jnp.arange(L)[:, None]
    j = jnp.arange(B, dtype=jnp.int32)[None, :]
    valid = (j < totals[:, None]) & (ctx >= 0)
    cix = jnp.where(valid, ctx, arena_size)
    n = jnp.zeros((L, arena_size + 1), jnp.int32).at[lanes2, cix].add(
        valid.astype(jnp.int32))[:, :arena_size]
    n1 = jnp.zeros((L, arena_size + 1), jnp.int32).at[lanes2, cix].add(
        jnp.where(valid, bits, 0))[:, :arena_size]
    n0 = n - n1
    p = jnp.where(n > 0,
                  (BIT_MODEL_TOTAL * (2 * n0 + alpha)) // (2 * n + 2 * alpha),
                  1024)
    return jnp.clip(p, 32, 2016)


def _tree_price(EP0, EP1, tree_base, nbits_max, nbits, value):
    """MSB-first bit-tree price, vectorized over any broadcastable shapes.

    tree_base/nbits/value broadcast against each other (NO lane axis);
    EP0/EP1 are the (L, S) per-lane price planes and the result gains a
    leading lane axis.  `nbits` may vary per element (masked levels cost
    0)."""
    L = EP0.shape[0]
    tree_base, nbits, value = jnp.broadcast_arrays(
        jnp.asarray(tree_base), jnp.asarray(nbits), jnp.asarray(value))
    lanes = jnp.arange(L).reshape((L,) + (1,) * value.ndim)
    cost = jnp.zeros((L,) + value.shape, jnp.int32)
    m = jnp.ones_like(value)
    for j in range(nbits_max):
        active = j < nbits
        b = (value >> jnp.clip(nbits - 1 - j, 0, 31)) & 1
        cx = tree_base + m
        pr = jnp.where(b == 1, EP1[lanes, cx], EP0[lanes, cx])
        cost = cost + jnp.where(active, pr, 0)
        m = jnp.where(active, (m << 1) | b, m)
    return cost


def _rev_tree_price(EP0, EP1, tree_base, nbits_max, nbits, value):
    """LSB-first (reverse) bit-tree price, same conventions as _tree_price."""
    L = EP0.shape[0]
    tree_base, nbits, value = jnp.broadcast_arrays(
        jnp.asarray(tree_base), jnp.asarray(nbits), jnp.asarray(value))
    lanes = jnp.arange(L).reshape((L,) + (1,) * value.ndim)
    cost = jnp.zeros((L,) + value.shape, jnp.int32)
    m = jnp.ones_like(value)
    v = value
    for j in range(nbits_max):
        active = j < nbits
        b = v & 1
        cx = tree_base + m
        pr = jnp.where(b == 1, EP1[lanes, cx], EP0[lanes, cx])
        cost = cost + jnp.where(active, pr, 0)
        m = jnp.where(active, (m << 1) | b, m)
        v = jnp.where(active, v >> 1, v)
    return cost


def build_price_model(data, probs, lc: int, lp: int, pb: int, fb: int,
                      r0pos=None):
    """All DP price tables from per-lane empirical probabilities.

    data: (L, N) u8; probs: (L, S); r0pos: (L, N) rep0-by-position trace
    (enables matched-mode literal pricing for after-match states).
    Returns a dict of jnp arrays (see dp_parse).  Everything here is
    embarrassingly parallel — the lane-parallel analogue of FillDistancesPrices /
    FillAlignPrices / UpdateTable."""
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    PT = jnp.asarray(PRICE_TABLE)
    EP0 = PT[probs >> 2]
    EP1 = PT[(BIT_MODEL_TOTAL - probs) >> 2]
    L, N = data.shape
    lanes2 = jnp.arange(L)[:, None]
    n_ps = 1 << pb

    # ---- literal cost per position (normal mode) ----
    pos = jnp.arange(N, dtype=jnp.int32)[None, :]
    prev = jnp.pad(data[:, :-1], ((0, 0), (1, 0))).astype(jnp.int32)
    sub = layout.literal + (
        ((pos & ((1 << lp) - 1)) << lc) + (prev >> (8 - lc))
    ) * LITERAL_CODER_SIZE
    byte = data.astype(jnp.int32)
    m = jnp.ones_like(byte)
    lit_cost = jnp.zeros((L, N), jnp.int32)
    for k in range(8):
        b = (byte >> (7 - k)) & 1
        cx = sub + m
        lit_cost = lit_cost + jnp.where(b == 1, EP1[lanes2, cx], EP0[lanes2, cx])
        m = (m << 1) | b

    # ---- length tables (L, n_ps, 272), match + rep ----
    def len_table(base):
        lsym = jnp.broadcast_to(jnp.arange(272, dtype=jnp.int32)[None, :],
                                (n_ps, 272))
        ps = jnp.arange(n_ps, dtype=jnp.int32)[:, None]
        band0 = lsym < 8
        band1 = (lsym >= 8) & (lsym < 16)
        c0 = EP0[:, base + layout.len_choice][:, None, None]
        c1 = EP1[:, base + layout.len_choice][:, None, None]
        c20 = EP0[:, base + layout.len_choice2][:, None, None]
        c21 = EP1[:, base + layout.len_choice2][:, None, None]
        head = jnp.where(band0[None], c0,
                         jnp.where(band1[None], c1 + c20, c1 + c21))
        v = jnp.where(band0, lsym, jnp.where(band1, lsym - 8, lsym - 16))
        nb = jnp.where(band0 | band1, 3, 8)
        tree = jnp.where(band0, base + layout.len_low + (ps << 3),
                         jnp.where(band1, base + layout.len_mid + (ps << 3),
                                   base + layout.len_high))
        return head + _tree_price(EP0, EP1, tree, 8, nb, v)

    lt_match = len_table(layout.len_coder)
    lt_rep = len_table(layout.rep_len_coder)

    # ---- pos_slot prices (L, 4, 64) ----
    slot_v = jnp.broadcast_to(jnp.arange(64, dtype=jnp.int32)[None, :], (4, 64))
    tree = layout.pos_slot + jnp.arange(4, dtype=jnp.int32)[:, None] * POS_SLOT_TREE_SIZE
    ps_price = _tree_price(EP0, EP1, tree, 6, jnp.full_like(slot_v, 6), slot_v)

    # ---- full-distance table d < 128 (L, 4, 128) ----
    d128 = jnp.arange(128, dtype=jnp.int32)
    nb128 = 31 - jax.lax.clz(jnp.maximum(d128, 1))
    slot128 = jnp.where(d128 < 4, d128,
                        (nb128 << 1) | ((d128 >> jnp.maximum(nb128 - 1, 0)) & 1))
    footer128 = jnp.maximum((slot128 >> 1) - 1, 0)
    base_val128 = (2 | (slot128 & 1)) << footer128
    reduced128 = d128 - base_val128
    spec_base = layout.spec_pos + base_val128 - slot128 - 1
    spec_nb = jnp.where(slot128 >= 4, footer128, 0)
    spec_price = _rev_tree_price(EP0, EP1, spec_base, 5, spec_nb, reduced128)
    dfull = ps_price[:, :, slot128] + spec_price[:, None, :]     # (L, 4, 128)

    # ---- align prices (L, 16) ----
    a16 = jnp.arange(16, dtype=jnp.int32)
    align_price = _rev_tree_price(
        EP0, EP1, jnp.full_like(a16, layout.align), 4, jnp.full_like(a16, 4), a16)

    # ---- flag tables ----
    lanes3 = jnp.arange(L)[:, None, None]
    st = jnp.arange(12, dtype=jnp.int32)[None, :, None]
    psv = jnp.arange(n_ps, dtype=jnp.int32)[None, None, :]
    im_ctx = layout.is_match + (st << layout.pos_bits) + psv
    im0 = EP0[lanes3, im_ctx]                                    # (L, 12, n_ps)
    im1 = EP1[lanes3, im_ctx]
    r0l_ctx = layout.is_rep0_long + (st << layout.pos_bits) + psv
    r0l0 = EP0[lanes3, r0l_ctx]
    r0l1 = EP1[lanes3, r0l_ctx]
    s12 = jnp.arange(12)
    ir0 = EP0[:, layout.is_rep + s12]
    ir1 = EP1[:, layout.is_rep + s12]
    g00 = EP0[:, layout.is_rep_g0 + s12]
    g01 = EP1[:, layout.is_rep_g0 + s12]
    g10 = EP0[:, layout.is_rep_g1 + s12]
    g11 = EP1[:, layout.is_rep_g1 + s12]
    g20 = EP0[:, layout.is_rep_g2 + s12]
    g21 = EP1[:, layout.is_rep_g2 + s12]

    # rep-selector price per rep index (L, 4, 12): the is_rep_g0/g1/g2
    # bit chain of each index (Decoder.java:232-259 as the tree spec)
    rep_sel = jnp.stack([
        g00,                  # rep0 (the is_rep0_long bit is per-ps, added separately)
        g01 + g10,            # rep1
        g01 + g11 + g20,      # rep2
        g01 + g11 + g21,      # rep3
    ], axis=1)

    mlit_cost = (matched_lit_cost(data, (EP0, EP1), r0pos, layout, lc, lp)
                 if r0pos is not None else lit_cost)

    return dict(
        lit_cost=lit_cost, mlit_cost=mlit_cost, lt_match=lt_match,
        lt_rep=lt_rep, ps_price=ps_price, dfull=dfull,
        align_price=align_price, im0=im0, im1=im1, ir0=ir0, ir1=ir1,
        rep_sel=rep_sel, r0l0=r0l0, r0l1=r0l1,
    )


def _pair_dist_cost(model, dd, valid):
    """Distance-part price for candidate pairs at each lps (L, N, M, 4).

    dd: (L, N, M) wire distances.  For d < 128 the exact spec-tree price
    (dfull); above, pos_slot + direct bits at 64 units each + align tree
    (pos_len_price semantics, Encoder.java:1081-1090 as spec)."""
    L = dd.shape[0]
    lanes4 = jnp.arange(L)[:, None, None, None]
    d = jnp.maximum(dd, 0)
    nb = 31 - jax.lax.clz(jnp.maximum(d, 1))
    slot = jnp.where(d < 4, d, (nb << 1) | ((d >> jnp.maximum(nb - 1, 0)) & 1))
    footer = jnp.maximum((slot >> 1) - 1, 0)
    lps = jnp.arange(4, dtype=jnp.int32)[None, None, None, :]
    lanes3 = jnp.arange(L)[:, None, None]
    big = (model["ps_price"][lanes4, lps, slot[:, :, :, None]]
           + ((footer - 4) << 6)[:, :, :, None]
           + model["align_price"][lanes3, d & 15][:, :, :, None])
    small = model["dfull"][lanes4, lps, jnp.minimum(d, 127)[:, :, :, None]]
    cost = jnp.where((d < 128)[:, :, :, None], small, big)
    return jnp.where(valid[:, :, :, None], cost, INF)


def _next_lit(s):
    return jnp.where(s < 4, 0, jnp.where(s < 10, s - 3, s - 6))


def _next_match(s):
    return jnp.where(s < 7, 7, 10)


def _next_longrep(s):
    return jnp.where(s < 7, 8, 11)


# ------------------------------------------------------------- pass C
#: node kinds recorded in the rkind plane
RK_LIT = -1
RK_MATCH = 4
RK_SHORTREP = 5


@partial(jax.jit, static_argnames=("fb", "pb", "full_len_only"))
def dp_parse(data, lens, ld, dd, model, fb: int, pb: int,
             full_len_only: bool = False, r0pos=None, replen=None):
    """The lane-parallel optimal-parse scan.

    data (L, N) u8, lens (L,), ld/dd (L, N, M) candidate (len, dist)
    pairs (ascending, invalid = 0/-1), model from build_price_model.
    Returns (price, from_, choice, rkind) planes, each (L, N + fb + 1).

    Node fields follow the reference Optimal (state + the 4-entry rep
    MTF set, finalized on the scan frontier from the best predecessor —
    Encoder.java:1261-1305); edges: literal, shortRep, candidate matches
    at every length 2..len (or full length only), with rep pricing for
    any pair whose distance sits in the node's rep set (the same
    first-index-wins detection the TokenEncoder applies)."""
    L, N = data.shape
    M = ld.shape[2]
    W = fb - 1                       # lengths 2..fb
    NP = N + W + 2                   # window slack past the last node
    pmask = (1 << pb) - 1

    dcost = _pair_dist_cost(model, dd, (ld >= 2) & (dd >= 0))  # (L, N, M, 4)
    lvec = jnp.arange(2, fb + 1, dtype=jnp.int32)              # (W,)
    lps_idx = jnp.minimum(lvec - 2, 3)

    # shortRep byte equality against the rep0 TRACE distance (see
    # dp_parse_band — both implementations share this gating so they
    # stay token-identical)
    if r0pos is not None:
        posv = jnp.arange(N, dtype=jnp.int32)[None, :]
        srcv = posv - r0pos - 1
        sbyte = jnp.take_along_axis(data, jnp.clip(srcv, 0, N - 1), axis=1)
        sr_eq = ((data == sbyte) & (srcv >= 0)).astype(jnp.int32)
    else:
        sr_eq = jnp.zeros((L, N), jnp.int32)

    price = jnp.full((L, NP), INF, jnp.int32).at[:, 0].set(0)
    from_ = jnp.zeros((L, NP), jnp.int32)
    choice = jnp.full((L, NP), -1, jnp.int32)
    rkind = jnp.full((L, NP), RK_LIT, jnp.int32)
    state = jnp.zeros((L, NP), jnp.int32)
    reps = jnp.zeros((L, NP, 4), jnp.int32)

    lt_match = model["lt_match"]     # (L, n_ps, 272)
    lt_rep = model["lt_rep"]
    lit_cost = model["lit_cost"]
    im0, im1 = model["im0"], model["im1"]          # (L, 12, n_ps)
    ir0, ir1 = model["ir0"], model["ir1"]          # (L, 12)
    rep_sel = model["rep_sel"]                     # (L, 4, 12)
    r0l0, r0l1 = model["r0l0"], model["r0l1"]      # (L, 12, n_ps)

    def col(a, i):
        return jax.lax.dynamic_slice(a, (0, i), (L, 1))[:, 0]

    def setcol(a, i, v):
        return jax.lax.dynamic_update_slice(a, v[:, None], (0, i))

    def step(i, carry):
        price, from_, choice, rkind, state, reps = carry
        ps = i & pmask

        # --- finalize node i (state, rep set) from its best predecessor ---
        p_i = col(price, i)
        f_i = col(from_, i)
        c_i = col(choice, i)
        k_i = col(rkind, i)
        st_prev = jnp.take_along_axis(state, f_i[:, None], axis=1)[:, 0]
        r_prev = jnp.take_along_axis(
            reps, f_i[:, None, None], axis=1)[:, 0, :]          # (L, 4)
        is_lit_e = k_i == RK_LIT
        is_sr_e = k_i == RK_SHORTREP
        is_rep_e = (k_i >= 0) & (k_i < 4)
        st_i = jnp.where(
            is_lit_e, _next_lit(st_prev),
            jnp.where(is_sr_e, jnp.where(st_prev < 7, 9, 11),
                      jnp.where(is_rep_e, _next_longrep(st_prev),
                                _next_match(st_prev))))
        # rep MTF (Encoder.java:969-973, 1001-1003): literal/shortRep
        # keep the set; rep k moves reps[k] to front; match pushes dist
        kk = jnp.clip(k_i, 0, 3)
        picked = jnp.take_along_axis(r_prev, kk[:, None], axis=1)[:, 0]
        n0 = jnp.where(is_rep_e, picked,
                       jnp.where(k_i == RK_MATCH, c_i, r_prev[:, 0]))
        n1 = jnp.where((is_rep_e & (kk >= 1)) | (k_i == RK_MATCH),
                       r_prev[:, 0], r_prev[:, 1])
        n2 = jnp.where((is_rep_e & (kk >= 2)) | (k_i == RK_MATCH),
                       r_prev[:, 1], r_prev[:, 2])
        n3 = jnp.where((is_rep_e & (kk >= 3)) | (k_i == RK_MATCH),
                       r_prev[:, 2], r_prev[:, 3])
        r_i = jnp.stack([n0, n1, n2, n3], axis=1)               # (L, 4)
        st_i = jnp.where(i == 0, 0, st_i)
        r_i = jnp.where(i == 0, 0, r_i)
        state = setcol(state, i, st_i)
        reps = jax.lax.dynamic_update_slice(reps, r_i[:, None, :], (0, i, 0))

        live = i < lens                                         # (L,)
        # flag prices at (state_i, ps)
        def at_st(tab_ps):                                       # (L, 12) -> (L,)
            return jnp.take_along_axis(tab_ps, st_i[:, None], axis=1)[:, 0]

        im0_ps = jax.lax.dynamic_slice(im0, (0, 0, ps), (L, 12, 1))[:, :, 0]
        im1_ps = jax.lax.dynamic_slice(im1, (0, 0, ps), (L, 12, 1))[:, :, 0]
        r0l0_ps = jax.lax.dynamic_slice(r0l0, (0, 0, ps), (L, 12, 1))[:, :, 0]
        r0l1_ps = jax.lax.dynamic_slice(r0l1, (0, 0, ps), (L, 12, 1))[:, :, 0]
        f_im0, f_im1 = at_st(im0_ps), at_st(im1_ps)
        f_r0l0, f_r0l1 = at_st(r0l0_ps), at_st(r0l1_ps)
        f_ir0, f_ir1 = at_st(ir0), at_st(ir1)
        f_sel = jnp.take_along_axis(
            rep_sel, st_i[:, None, None], axis=2)[:, :, 0]       # (L, 4)

        # --- literal / shortRep edges i -> i+1 ---
        # after-match states price the literal in matched mode (the
        # model's match byte comes from the rep0-by-position trace)
        lcost = jnp.where(st_i >= 7, col(model["mlit_cost"], i),
                          col(lit_cost, i))
        cand_l = p_i + f_im0 + lcost
        # shortRep gated on node-rep0 == trace-rep0 (see dp_parse_band)
        if r0pos is not None:
            sr_ok = (col(sr_eq, i) > 0) & (r_i[:, 0] == col(r0pos, i))
        else:
            sr_ok = jnp.zeros((L,), bool)
        cand_sr = jnp.where(sr_ok,
                            p_i + f_im1 + f_ir1 + f_sel[:, 0] + f_r0l0, INF)
        use_sr = cand_sr < cand_l
        cand1 = jnp.minimum(cand_l, cand_sr)
        old = col(price, i + 1)
        imp = live & (cand1 < old)
        price = setcol(price, i + 1, jnp.where(imp, cand1, old))
        from_ = setcol(from_, i + 1, jnp.where(imp, i, col(from_, i + 1)))
        choice = setcol(choice, i + 1,
                        jnp.where(imp, jnp.where(use_sr, r_i[:, 0], -1),
                                  col(choice, i + 1)))
        rkind = setcol(rkind, i + 1,
                       jnp.where(imp, jnp.where(use_sr, RK_SHORTREP, RK_LIT),
                                 col(rkind, i + 1)))

        # --- match / rep window relax over lengths 2..fb ---
        ld_i = jax.lax.dynamic_slice(ld, (0, i, 0), (L, 1, M))[:, 0, :]
        dd_i = jax.lax.dynamic_slice(dd, (0, i, 0), (L, 1, M))[:, 0, :]
        dc_i = jax.lax.dynamic_slice(dcost, (0, i, 0, 0), (L, 1, M, 4))[:, 0]
        ld_i = jnp.minimum(ld_i, jnp.maximum(lens[:, None] - i, 0))
        pv = (ld_i >= 2) & (dd_i >= 0) & live[:, None]
        # first-index-wins rep detection, mirroring TokenEncoder.match
        eq = dd_i[:, :, None] == r_i[:, None, :]                 # (L, M, 4)
        any_eq = jnp.any(eq, axis=2)
        ridx = jnp.argmax(eq, axis=2)                            # (L, M)
        is_rep_pair = pv & any_eq

        ltm = jax.lax.dynamic_slice(lt_match, (0, ps, 0), (L, 1, 272))[:, 0, :W]
        ltr = jax.lax.dynamic_slice(lt_rep, (0, ps, 0), (L, 1, 272))[:, 0, :W]
        mbase = p_i + f_im1 + f_ir0                              # (L,)
        rep_base = (p_i + f_im1 + f_ir1)[:, None] + f_sel        # (L, 4)
        rep_base = rep_base.at[:, 0].add(f_r0l1)
        pair_rep_base = jnp.take_along_axis(rep_base, ridx, axis=1)  # (L, M)

        dc_l = jnp.take(dc_i, lps_idx, axis=2)                   # (L, M, W)
        mcost = mbase[:, None, None] + dc_l + ltm[:, None, :]
        rcost = pair_rep_base[:, :, None] + ltr[:, None, :]
        cost = jnp.where(is_rep_pair[:, :, None], rcost, mcost)
        lmask = lvec[None, None, :] <= ld_i[:, :, None]
        if full_len_only:
            lmask = lmask & (lvec[None, None, :] == ld_i[:, :, None])
        cost = jnp.where(lmask & pv[:, :, None], cost, INF)

        # rep0-continuation edge: the candidate tiers miss short (2-3
        # byte) rep0 matches entirely (their seeds are 4+ bytes), so the
        # rep0 match length comes from the dedicated per-position LCP
        # trace — valid whenever the node's actual rep0 equals the
        # traced distance (it almost always does: both are "the last
        # match's distance")
        if r0pos is not None:
            r0p_i = col(r0pos, jnp.minimum(i, N - 1))
            rl_i = col(replen, jnp.minimum(i, N - 1))
            rep0_ok = live & (r_i[:, 0] == r0p_i) & (rl_i >= 2)
            c_r0 = jnp.where(
                rep0_ok[:, None] & (lvec[None, :] <= rl_i[:, None]),
                (p_i + f_im1 + f_ir1 + f_sel[:, 0] + f_r0l1)[:, None] + ltr,
                INF)
            cost = jnp.concatenate([cost, c_r0[:, None, :]], axis=1)
            dd_i = jnp.concatenate([dd_i, r0p_i[:, None]], axis=1)
            is_rep_pair = jnp.concatenate(
                [is_rep_pair, rep0_ok[:, None]], axis=1)
            ridx = jnp.concatenate(
                [ridx, jnp.zeros((L, 1), ridx.dtype)], axis=1)

        best = jnp.min(cost, axis=1)                             # (L, W)
        bidx = jnp.argmin(cost, axis=1)                          # (L, W)

        def pick(a):
            return jnp.take_along_axis(
                jnp.broadcast_to(a[:, :, None], cost.shape),
                bidx[:, None, :], axis=1)[:, 0, :]

        bdist = pick(dd_i)
        bkind = jnp.where(pick(is_rep_pair.astype(jnp.int32)) > 0,
                          pick(ridx), RK_MATCH)

        win = jax.lax.dynamic_slice(price, (0, i + 2), (L, W))
        impw = best < win
        price = jax.lax.dynamic_update_slice(
            price, jnp.where(impw, best, win), (0, i + 2))
        winf = jax.lax.dynamic_slice(from_, (0, i + 2), (L, W))
        from_ = jax.lax.dynamic_update_slice(
            from_, jnp.where(impw, i, winf), (0, i + 2))
        winc = jax.lax.dynamic_slice(choice, (0, i + 2), (L, W))
        choice = jax.lax.dynamic_update_slice(
            choice, jnp.where(impw, jnp.maximum(bdist, 0), winc), (0, i + 2))
        wink = jax.lax.dynamic_slice(rkind, (0, i + 2), (L, W))
        rkind = jax.lax.dynamic_update_slice(
            rkind, jnp.where(impw, bkind, wink), (0, i + 2))
        return (price, from_, choice, rkind, state, reps)

    price, from_, choice, rkind, state, reps = jax.lax.fori_loop(
        0, N, step, (price, from_, choice, rkind, state, reps))
    return from_, choice


@partial(jax.jit, static_argnames=("fb", "pb", "full_len_only"))
def dp_parse_band(data, lens, ld, dd, model, fb: int, pb: int,
                  full_len_only: bool = False, r0pos=None, replen=None):
    """dp_parse restructured as a band scan: the XLA plain reference of
    dp_parse_triton.

    The DP is BANDED: every read/write at step i lands within fb columns
    of i.  The naive formulation (dp_parse) dynamic-slices ~25 (L, N)
    planes per step.  Here the live state is two small rolling bands
    (future window + finalized history, O(L x fb) each), the
    per-position tables are packed into ONE (N, L, C) array the loop
    reads once per step, one packed (from, choice) row is written back
    per step, and every in-loop select is a one-hot masked contraction.
    Identical output to dp_parse."""
    L, N = data.shape
    M = ld.shape[2]
    W = fb - 1                        # relax lengths 2..fb
    B = fb + 1                        # future band: cols 0..fb == nodes i..i+fb
    H = fb                            # history band: nodes i-1..i-fb
    pmask = (1 << pb) - 1
    n_ps = 1 << pb

    dcost = _pair_dist_cost(model, dd, (ld >= 2) & (dd >= 0))   # (L, N, M, 4)
    lvec = jnp.arange(2, fb + 1, dtype=jnp.int32)               # (W,)
    lps_idx = jnp.minimum(lvec - 2, 3)

    # shortRep byte equality precomputed against the rep0 TRACE distance
    # (in-loop it gates on node-rep0 == trace-rep0, so the test is exact
    # whenever it fires) — removes the only in-loop data gather
    pos = jnp.arange(N, dtype=jnp.int32)[None, :]
    zcol = jnp.zeros((L, N), jnp.int32)
    if r0pos is not None:
        src = pos - r0pos - 1
        sbyte = jnp.take_along_axis(data, jnp.clip(src, 0, N - 1), axis=1)
        sr_eq = ((data == sbyte) & (src >= 0)).astype(jnp.int32)
        r0p, rlp = r0pos, replen
    else:
        sr_eq = zcol
        r0p = rlp = zcol

    # ---- packed per-position input: (N, L, C) ----
    packed = jnp.concatenate([
        jnp.moveaxis(ld, 1, 0).reshape(N, L, M),
        jnp.moveaxis(dd, 1, 0).reshape(N, L, M),
        jnp.moveaxis(dcost, 1, 0).reshape(N, L, M * 4),
        jnp.moveaxis(model["lit_cost"], 1, 0)[:, :, None],
        jnp.moveaxis(model["mlit_cost"], 1, 0)[:, :, None],
        jnp.moveaxis(r0p, 1, 0)[:, :, None],
        jnp.moveaxis(rlp, 1, 0)[:, :, None],
        jnp.moveaxis(sr_eq, 1, 0)[:, :, None],
    ], axis=2)                                                   # (N, L, C)
    C = packed.shape[2]

    # ---- ps-indexed tables with ps leading (one-hot contracted in-loop) ----
    ltm_ps = jnp.moveaxis(model["lt_match"][:, :, :W], 1, 0)     # (n_ps, L, W)
    ltr_ps = jnp.moveaxis(model["lt_rep"][:, :, :W], 1, 0)
    im0_ps = jnp.moveaxis(model["im0"], 2, 0)                    # (n_ps, L, 12)
    im1_ps = jnp.moveaxis(model["im1"], 2, 0)
    r0l0_ps = jnp.moveaxis(model["r0l0"], 2, 0)
    r0l1_ps = jnp.moveaxis(model["r0l1"], 2, 0)
    ir0, ir1 = model["ir0"], model["ir1"]                        # (L, 12)
    rep_sel = model["rep_sel"]                                   # (L, 4, 12)

    # ---- bands ----
    bp = jnp.full((L, B), INF, jnp.int32).at[:, 0].set(0)        # price
    bf = jnp.zeros((L, B), jnp.int32)                            # from offset d=i-f (0 at node 0)
    bc = jnp.full((L, B), -1, jnp.int32)                         # choice dist
    bk = jnp.full((L, B), RK_LIT, jnp.int32)                     # kind
    hstate = jnp.zeros((L, H), jnp.int32)                        # node i-1-h
    hreps = jnp.zeros((L, H, 4), jnp.int32)
    out = jnp.zeros((N + 1, L, 2), jnp.int32)                    # (from_abs, choice)

    def step(i, carry):
        bp, bf, bc, bk, hstate, hreps, out = carry
        row = jax.lax.dynamic_slice(packed, (i, 0, 0), (1, L, C))[0]
        ld_i = row[:, 0:M]
        dd_i = row[:, M:2 * M]
        dc_i = row[:, 2 * M:6 * M].reshape(L, M, 4)
        lit_i = row[:, 6 * M]
        mlit_i = row[:, 6 * M + 1]
        r0p_i = row[:, 6 * M + 2]
        rl_i = row[:, 6 * M + 3]
        sr_eq_i = row[:, 6 * M + 4]

        # posState one-hot: the only ps-dependent op is a tiny contraction
        ohps = (jnp.arange(n_ps, dtype=jnp.int32) == (i & pmask)).astype(
            jnp.int32)                                           # (n_ps,)

        def by_ps(tab):                                          # (n_ps, L, X) -> (L, X)
            return jnp.tensordot(ohps, tab, axes=1)

        # --- finalize node i from its predecessor (history band) ---
        p_i, d_i, c_i, k_i = bp[:, 0], bf[:, 0], bc[:, 0], bk[:, 0]
        ohh = (jnp.arange(H, dtype=jnp.int32)[None, :]
               == jnp.clip(d_i - 1, 0, H - 1)[:, None]).astype(jnp.int32)
        st_prev = jnp.sum(hstate * ohh, axis=1)
        r_prev = jnp.sum(hreps * ohh[:, :, None], axis=1)        # (L, 4)
        is_lit_e = k_i == RK_LIT
        is_sr_e = k_i == RK_SHORTREP
        is_rep_e = (k_i >= 0) & (k_i < 4)
        st_i = jnp.where(
            is_lit_e, _next_lit(st_prev),
            jnp.where(is_sr_e, jnp.where(st_prev < 7, 9, 11),
                      jnp.where(is_rep_e, _next_longrep(st_prev),
                                _next_match(st_prev))))
        kk = jnp.clip(k_i, 0, 3)
        ohk = (jnp.arange(4, dtype=jnp.int32)[None, :]
               == kk[:, None]).astype(jnp.int32)                 # (L, 4)
        picked = jnp.sum(r_prev * ohk, axis=1)
        n0 = jnp.where(is_rep_e, picked,
                       jnp.where(k_i == RK_MATCH, c_i, r_prev[:, 0]))
        n1 = jnp.where((is_rep_e & (kk >= 1)) | (k_i == RK_MATCH),
                       r_prev[:, 0], r_prev[:, 1])
        n2 = jnp.where((is_rep_e & (kk >= 2)) | (k_i == RK_MATCH),
                       r_prev[:, 1], r_prev[:, 2])
        n3 = jnp.where((is_rep_e & (kk >= 3)) | (k_i == RK_MATCH),
                       r_prev[:, 2], r_prev[:, 3])
        st_i = jnp.where(i == 0, 0, st_i)
        r_i = jnp.where(i == 0, 0,
                        jnp.stack([n0, n1, n2, n3], axis=1))

        # emit node i (absolute from, choice)
        out = jax.lax.dynamic_update_slice(
            out, jnp.stack([i - d_i, c_i], axis=1)[None], (i, 0, 0))

        live = i < lens
        # flag prices at (state_i, ps): one-hot over the 12 states
        ohst = (jnp.arange(12, dtype=jnp.int32)[None, :]
                == st_i[:, None]).astype(jnp.int32)              # (L, 12)

        def at_st(tab):                                          # (L, 12) -> (L,)
            return jnp.sum(tab * ohst, axis=1)

        f_im0 = at_st(by_ps(im0_ps))
        f_im1 = at_st(by_ps(im1_ps))
        f_r0l0 = at_st(by_ps(r0l0_ps))
        f_r0l1 = at_st(by_ps(r0l1_ps))
        f_ir0, f_ir1 = at_st(ir0), at_st(ir1)
        f_sel = jnp.sum(rep_sel * ohst[:, None, :], axis=2)      # (L, 4)

        # --- literal / shortRep edges -> band col 1 ---
        lcost = jnp.where(st_i >= 7, mlit_i, lit_i)
        cand_l = p_i + f_im0 + lcost
        # shortRep gated on node-rep0 == trace-rep0, where the
        # precomputed byte equality is exact
        sr_ok = (sr_eq_i > 0) & (r_i[:, 0] == r0p_i)
        cand_sr = jnp.where(sr_ok,
                            p_i + f_im1 + f_ir1 + f_sel[:, 0] + f_r0l0, INF)
        use_sr = cand_sr < cand_l
        cand1 = jnp.minimum(cand_l, cand_sr)
        imp = live & (cand1 < bp[:, 1])
        bp = bp.at[:, 1].set(jnp.where(imp, cand1, bp[:, 1]))
        bf = bf.at[:, 1].set(jnp.where(imp, 1, bf[:, 1]))
        bc = bc.at[:, 1].set(jnp.where(
            imp, jnp.where(use_sr, r_i[:, 0], -1), bc[:, 1]))
        bk = bk.at[:, 1].set(jnp.where(
            imp, jnp.where(use_sr, RK_SHORTREP, RK_LIT), bk[:, 1]))

        # --- match / rep window relax over cols 2..fb ---
        ld_c = jnp.minimum(ld_i, jnp.maximum(lens[:, None] - i, 0))
        pv = (ld_c >= 2) & (dd_i >= 0) & live[:, None]
        eq = dd_i[:, :, None] == r_i[:, None, :]
        any_eq = jnp.any(eq, axis=2)
        ridx = jnp.argmax(eq, axis=2)
        is_rep_pair = pv & any_eq

        ltm = by_ps(ltm_ps)
        ltr = by_ps(ltr_ps)
        mbase = p_i + f_im1 + f_ir0
        rep_base = (p_i + f_im1 + f_ir1)[:, None] + f_sel
        rep_base = rep_base.at[:, 0].add(f_r0l1)
        # select the matching rep index's base per pair via the eq mask
        # (first-index-wins: mask eq to the argmax index)
        ohr = (jnp.cumsum(eq.astype(jnp.int32), axis=2)
               * eq.astype(jnp.int32)) == 1                      # (L, M, 4)
        pair_rep_base = jnp.sum(rep_base[:, None, :] * ohr, axis=2)

        dc_l = jnp.take(dc_i, lps_idx, axis=2)                   # (L, M, W)
        mcost = mbase[:, None, None] + dc_l + ltm[:, None, :]
        rcost = pair_rep_base[:, :, None] + ltr[:, None, :]
        cost = jnp.where(is_rep_pair[:, :, None], rcost, mcost)
        lmask = lvec[None, None, :] <= ld_c[:, :, None]
        if full_len_only:
            lmask = lmask & (lvec[None, None, :] == ld_c[:, :, None])
        cost = jnp.where(lmask & pv[:, :, None], cost, INF)

        if r0pos is not None:
            rl_c = jnp.minimum(rl_i, jnp.maximum(lens - i, 0))
            rep0_ok = live & (r_i[:, 0] == r0p_i) & (rl_c >= 2)
            c_r0 = jnp.where(
                rep0_ok[:, None] & (lvec[None, :] <= rl_c[:, None]),
                (p_i + f_im1 + f_ir1 + f_sel[:, 0] + f_r0l1)[:, None] + ltr,
                INF)
            cost = jnp.concatenate([cost, c_r0[:, None, :]], axis=1)
            dd_x = jnp.concatenate([dd_i, r0p_i[:, None]], axis=1)
            rep_x = jnp.concatenate([is_rep_pair, rep0_ok[:, None]], axis=1)
            ridx_x = jnp.concatenate(
                [ridx, jnp.zeros((L, 1), ridx.dtype)], axis=1)
        else:
            dd_x, rep_x, ridx_x = dd_i, is_rep_pair, ridx

        best = jnp.min(cost, axis=1)                             # (L, W)
        bidx = jnp.argmin(cost, axis=1)
        ohb = (jnp.arange(cost.shape[1], dtype=jnp.int32)[None, :, None]
               == bidx[:, None, :]).astype(jnp.int32)            # (L, M', W)

        def pick(a):
            return jnp.sum(a[:, :, None] * ohb, axis=1)

        bdist = pick(dd_x)
        bkind = jnp.where(pick(rep_x.astype(jnp.int32)) > 0,
                          pick(ridx_x), RK_MATCH)

        win = bp[:, 2:2 + W]
        impw = best < win
        bp = bp.at[:, 2:2 + W].set(jnp.where(impw, best, win))
        bf = bf.at[:, 2:2 + W].set(jnp.where(
            impw, lvec[None, :], bf[:, 2:2 + W]))
        bc = bc.at[:, 2:2 + W].set(jnp.where(
            impw, jnp.maximum(bdist, 0), bc[:, 2:2 + W]))
        bk = bk.at[:, 2:2 + W].set(jnp.where(impw, bkind, bk[:, 2:2 + W]))

        # --- advance: node i leaves the future band, enters history ---
        bp = jnp.roll(bp, -1, axis=1).at[:, B - 1].set(INF)
        bf = jnp.roll(bf, -1, axis=1).at[:, B - 1].set(0)
        bc = jnp.roll(bc, -1, axis=1).at[:, B - 1].set(-1)
        bk = jnp.roll(bk, -1, axis=1).at[:, B - 1].set(RK_LIT)
        hstate = jnp.roll(hstate, 1, axis=1).at[:, 0].set(st_i)
        hreps = jnp.roll(hreps, 1, axis=1).at[:, 0, :].set(r_i)
        return (bp, bf, bc, bk, hstate, hreps, out)

    bp, bf, bc, bk, hstate, hreps, out = jax.lax.fori_loop(
        0, N, step, (bp, bf, bc, bk, hstate, hreps, out))
    # node N (the end node for full lanes) sits at band col 0 now
    out = out.at[N, :, 0].set(N - bf[:, 0])
    out = out.at[N, :, 1].set(bc[:, 0])
    from_abs = jnp.moveaxis(out[:, :, 0], 0, 1)                  # (L, N+1)
    choice = jnp.moveaxis(out[:, :, 1], 0, 1)
    return from_abs, choice


def _pack_inputs(data, ld, dd, dcost, model, r0pos, replen, fb):
    """Per-position DP inputs packed lanes-last: (N, C, L) int32.

    Row layout: ld (M), dd (M), dcost (M*4, m-major), lit, mlit, r0p,
    rl, sr_eq — one contiguous read per DP step."""
    L, N = model["lit_cost"].shape
    M = ld.shape[2]
    pos = jnp.arange(N, dtype=jnp.int32)[None, :]
    zcol = jnp.zeros((L, N), jnp.int32)
    if r0pos is not None:
        src = pos - r0pos - 1
        sbyte = jnp.take_along_axis(data, jnp.clip(src, 0, N - 1), axis=1)
        sr_eq = ((data == sbyte) & (src >= 0)).astype(jnp.int32)
        r0p, rlp = r0pos, replen
    else:
        sr_eq = zcol
        r0p = rlp = zcol
    parts = [
        jnp.moveaxis(ld, 1, 0).reshape(N, L, M),
        jnp.moveaxis(dd, 1, 0).reshape(N, L, M),
        jnp.moveaxis(dcost, 1, 0).reshape(N, L, M * 4),
        jnp.moveaxis(model["lit_cost"], 1, 0)[:, :, None],
        jnp.moveaxis(model["mlit_cost"], 1, 0)[:, :, None],
        jnp.moveaxis(r0p, 1, 0)[:, :, None],
        jnp.moveaxis(rlp, 1, 0)[:, :, None],
        jnp.moveaxis(sr_eq, 1, 0)[:, :, None],
    ]
    return jnp.moveaxis(jnp.concatenate(parts, axis=2), 1, 2)    # (N, C, L)


#: dp_parse_triton's program shape: lanes per program and warps — the
#: fastest of 4x1, 8x1, 8x2 and 32x4 at 24 x 128 KiB on the H100
#: (PERF.md): more, shorter programs beat wider ones
DP_KERNEL_LANES = 4
DP_KERNEL_WARPS = 1


def _ring_rows(fb: int) -> int:
    """Ring depth of the kernel's bands: a power of two > fb, so the
    fb + 1 nodes each band holds at step i (i .. i+fb in the future
    band, i-fb .. i in the history) never share a row."""
    return 1 << fb.bit_length()


@partial(jax.jit, static_argnames=("fb", "pb", "full_len_only",
                                   "interpret"))
def dp_parse_triton(data, lens, ld, dd, model, fb: int, pb: int,
                    full_len_only: bool = False, r0pos=None, replen=None,
                    interpret: bool = False):
    """The DP scan as one Pallas-Triton kernel (GPU).  Output is
    identical to dp_parse_band.

    The XLA band form pays a chain of kernel launches per position.
    Here one program scans all positions of DP_KERNEL_LANES lanes,
    lanes last (the last program masks the lanes past L; nothing is
    padded):

      * the future band (price, from offset, choice, kind) and the
        finalized history (state, 4 reps) are loop-carried register
        tiles of shape (R, DP_KERNEL_LANES), R = _ring_rows(fb).  Node
        j lives in row j mod R, so advancing a position moves nothing:
        node i's row is read, relaxed from and reset to the empty node;
      * per-position inputs come from the packed (N, C, L) array
        (_pack_inputs), one load per field;
      * prices indexed by (posState, state) and the length tables are
        read by indexed loads, not one-hot contractions.

    Every buffer is int32 and indexed by its dimensions, so Pallas
    computes the offsets (in 64 bits for buffers past 4 GiB).
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    L, N = data.shape
    M = ld.shape[2]
    W = fb - 1
    R = _ring_rows(fb)
    pmask = (1 << pb) - 1
    LB = DP_KERNEL_LANES
    i32 = jnp.int32

    dcost = _pair_dist_cost(model, dd, (ld >= 2) & (dd >= 0))
    packed = _pack_inputs(data, ld, dd, dcost, model, r0pos, replen,
                          fb).astype(i32)                        # (N, C, L)
    ltm = jnp.transpose(model["lt_match"][:, :, :W], (1, 2, 0)).astype(i32)
    ltr = jnp.transpose(model["lt_rep"][:, :, :W], (1, 2, 0)).astype(i32)
    # per-(posState, state) flag prices: (n_ps, 12, L) each, stacked
    flags = jnp.stack(
        [jnp.transpose(model[k], (2, 1, 0))
         for k in ("im0", "im1", "r0l0", "r0l1")]).astype(i32)  # (4, n_ps, 12, L)
    st_tabs = jnp.concatenate(
        [model["ir0"].T[None], model["ir1"].T[None],
         jnp.transpose(model["rep_sel"], (1, 2, 0))]).astype(i32)  # (6, 12, L)

    def kernel(inp_ref, ltm_ref, ltr_ref, flag_ref, st_ref, lens_ref,
               out_ref):
        lane = pl.program_id(0) * LB + jnp.arange(LB, dtype=i32)
        real = lane < L
        rowid = jnp.arange(R, dtype=i32)[:, None]                # (R, 1)
        lens_l = plgpu.load(lens_ref.at[lane], mask=real, other=0)

        def row_of(tile, r):                                     # r: scalar or (LB,)
            return jnp.sum(jnp.where(rowid == r, tile, 0), axis=0)

        def field(i, j):
            return plgpu.load(inp_ref.at[i, j, lane], mask=real, other=0)

        def flag(t, ps, st):
            return plgpu.load(flag_ref.at[t, ps, st, lane], mask=real,
                              other=0)

        def st_tab(t, st):
            return plgpu.load(st_ref.at[t, st, lane], mask=real, other=0)

        def put_row(tile, r, val, mask=True):
            return jnp.where((rowid == r) & mask, val[None, :], tile)

        def step(i, carry):
            bp, bf, bc, bk, hst, h0, h1, h2, h3 = carry
            ri = i & (R - 1)
            ps = i & pmask
            ld_i = [field(i, m) for m in range(M)]
            dd_i = [field(i, M + m) for m in range(M)]
            lit_i = field(i, 6 * M)
            mlit_i = field(i, 6 * M + 1)
            r0p_i = field(i, 6 * M + 2)
            rl_i = field(i, 6 * M + 3)
            sr_eq_i = field(i, 6 * M + 4)

            # --- finalize node i from its predecessor ---
            p_i, d_i = row_of(bp, ri), row_of(bf, ri)
            c_i, k_i = row_of(bc, ri), row_of(bk, ri)
            hrow = (i - 1 - jnp.clip(d_i - 1, 0, fb - 1)) & (R - 1)
            st_prev = row_of(hst, hrow)
            r_prev = [row_of(h, hrow) for h in (h0, h1, h2, h3)]
            is_lit_e = k_i == RK_LIT
            is_sr_e = k_i == RK_SHORTREP
            is_rep_e = (k_i >= 0) & (k_i < 4)
            st_i = jnp.where(
                is_lit_e, _next_lit(st_prev),
                jnp.where(is_sr_e, jnp.where(st_prev < 7, 9, 11),
                          jnp.where(is_rep_e, _next_longrep(st_prev),
                                    _next_match(st_prev))))
            kk = jnp.clip(k_i, 0, 3)
            picked = jnp.where(kk == 0, r_prev[0],
                               jnp.where(kk == 1, r_prev[1],
                                         jnp.where(kk == 2, r_prev[2],
                                                   r_prev[3])))
            is_m = k_i == RK_MATCH
            r_i = [jnp.where(is_rep_e, picked, jnp.where(is_m, c_i, r_prev[0])),
                   jnp.where((is_rep_e & (kk >= 1)) | is_m, r_prev[0], r_prev[1]),
                   jnp.where((is_rep_e & (kk >= 2)) | is_m, r_prev[1], r_prev[2]),
                   jnp.where((is_rep_e & (kk >= 3)) | is_m, r_prev[2], r_prev[3])]
            first = i == 0
            st_i = jnp.where(first, 0, st_i)
            r_i = [jnp.where(first, 0, r) for r in r_i]

            plgpu.store(out_ref.at[i, 0, lane], i - d_i, mask=real)
            plgpu.store(out_ref.at[i, 1, lane], c_i, mask=real)

            live = i < lens_l
            f_im0 = flag(0, ps, st_i)
            f_im1 = flag(1, ps, st_i)
            f_r0l0 = flag(2, ps, st_i)
            f_r0l1 = flag(3, ps, st_i)
            f_ir0 = st_tab(0, st_i)
            f_ir1 = st_tab(1, st_i)
            f_sel = [st_tab(2 + r, st_i) for r in range(4)]

            # --- literal / shortRep edge -> node i+1 ---
            lcost = jnp.where(st_i >= 7, mlit_i, lit_i)
            cand_l = p_i + f_im0 + lcost
            sr_ok = (sr_eq_i > 0) & (r_i[0] == r0p_i)
            cand_sr = jnp.where(
                sr_ok, p_i + f_im1 + f_ir1 + f_sel[0] + f_r0l0, INF)
            use_sr = cand_sr < cand_l
            cand1 = jnp.minimum(cand_l, cand_sr)
            r1 = (i + 1) & (R - 1)
            imp = live & (cand1 < row_of(bp, r1))
            bp = put_row(bp, r1, cand1, imp[None, :])
            bf = put_row(bf, r1, jnp.ones_like(cand1), imp[None, :])
            bc = put_row(bc, r1, jnp.where(use_sr, r_i[0], -1), imp[None, :])
            bk = put_row(bk, r1, jnp.where(use_sr, RK_SHORTREP, RK_LIT),
                         imp[None, :])

            # --- match / rep relax: ring row r holds node i + k ---
            k = (rowid - i) & (R - 1)                            # (R, 1)
            in_win = (k >= 2) & (k <= fb)
            lt_at = (jnp.broadcast_to(ps, (R, LB)),
                     jnp.broadcast_to(jnp.clip(k - 2, 0, W - 1), (R, LB)),
                     jnp.broadcast_to(lane[None, :], (R, LB)))
            win_mask = in_win & real[None, :]
            ltm_t = plgpu.load(ltm_ref.at[lt_at], mask=win_mask, other=0)
            ltr_t = plgpu.load(ltr_ref.at[lt_at], mask=win_mask, other=0)
            lps = jnp.minimum(k - 2, 3)
            mbase = p_i + f_im1 + f_ir0
            rep_head = p_i + f_im1 + f_ir1
            rep_base = [rep_head + f_sel[0] + f_r0l1, rep_head + f_sel[1],
                        rep_head + f_sel[2], rep_head + f_sel[3]]
            rem = jnp.maximum(lens_l - i, 0)

            best = bdist = bkind = None
            for m in range(M):
                ld_c = jnp.minimum(ld_i[m], rem)
                pv = (ld_c >= 2) & (dd_i[m] >= 0) & live
                eq = [dd_i[m] == r for r in r_i]
                any_eq = eq[0] | eq[1] | eq[2] | eq[3]
                rix = jnp.where(eq[0], 0, jnp.where(eq[1], 1,
                                                    jnp.where(eq[2], 2, 3)))
                is_rep = pv & any_eq
                prb = jnp.where(eq[0], rep_base[0],
                                jnp.where(eq[1], rep_base[1],
                                          jnp.where(eq[2], rep_base[2],
                                                    jnp.where(eq[3], rep_base[3], 0))))
                dq = [field(i, 2 * M + 4 * m + q) for q in range(4)]
                dc_l = jnp.where(lps <= 0, dq[0][None, :],
                                 jnp.where(lps == 1, dq[1][None, :],
                                           jnp.where(lps == 2, dq[2][None, :],
                                                     dq[3][None, :])))
                cost = jnp.where(is_rep[None, :], prb[None, :] + ltr_t,
                                 mbase[None, :] + dc_l + ltm_t)
                lm = k <= ld_c[None, :]
                if full_len_only:
                    lm = lm & (k == ld_c[None, :])
                cost = jnp.where(lm & pv[None, :] & in_win, cost, INF)
                kind = jnp.where(is_rep, rix, RK_MATCH)
                if best is None:
                    best = cost
                    bdist = jnp.broadcast_to(dd_i[m][None, :], (R, LB))
                    bkind = jnp.broadcast_to(kind[None, :], (R, LB))
                else:
                    better = cost < best
                    best = jnp.where(better, cost, best)
                    bdist = jnp.where(better, dd_i[m][None, :], bdist)
                    bkind = jnp.where(better, kind[None, :], bkind)
            # rep0-continuation edge from the traced rep0 length
            rl_c = jnp.minimum(rl_i, rem)
            rep0_ok = live & (r_i[0] == r0p_i) & (rl_c >= 2)
            cost0 = jnp.where(rep0_ok[None, :] & (k <= rl_c[None, :]) & in_win,
                              rep_base[0][None, :] + ltr_t, INF)
            better = cost0 < best
            best = jnp.where(better, cost0, best)
            bdist = jnp.where(better, r0p_i[None, :], bdist)
            bkind = jnp.where(better, 0, bkind)

            impw = best < bp
            bp = jnp.where(impw, best, bp)
            bf = jnp.where(impw, k, bf)
            bc = jnp.where(impw, jnp.maximum(bdist, 0), bc)
            bk = jnp.where(impw, bkind, bk)

            # --- node i retires: its row becomes the empty node i + R ---
            at_i = rowid == ri
            bp = jnp.where(at_i, INF, bp)
            bf = jnp.where(at_i, 0, bf)
            bc = jnp.where(at_i, -1, bc)
            bk = jnp.where(at_i, RK_LIT, bk)
            hst = put_row(hst, ri, st_i)
            h0, h1, h2, h3 = (put_row(h, ri, r)
                              for h, r in zip((h0, h1, h2, h3), r_i))
            return (bp, bf, bc, bk, hst, h0, h1, h2, h3)

        zeros = jnp.zeros((R, LB), jnp.int32)
        init = (jnp.where(rowid == 0, 0, jnp.full((R, LB), INF, jnp.int32)),
                zeros, jnp.full((R, LB), -1, jnp.int32),
                jnp.full((R, LB), RK_LIT, jnp.int32),
                zeros, zeros, zeros, zeros, zeros)
        bp, bf, bc, *_ = jax.lax.fori_loop(0, N, step, init)
        rn = N & (R - 1)
        plgpu.store(out_ref.at[N, 0, lane], N - row_of(bf, rn), mask=real)
        plgpu.store(out_ref.at[N, 1, lane], row_of(bc, rn), mask=real)

    out = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(L, LB),),
        out_shape=jax.ShapeDtypeStruct((N + 1, 2, L), i32),
        compiler_params=plgpu.CompilerParams(num_warps=DP_KERNEL_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="lzma_dp_scan",
    )(packed, ltm, ltr, flags, st_tabs, lens.astype(i32))
    return jnp.moveaxis(out[:, 0], 0, 1), jnp.moveaxis(out[:, 1], 0, 1)


# ------------------------------------------------------------- pass D
@jax.jit
def extract_tokens(from_, choice, lens):
    """Backward path -> compacted (pos, len, dist) token stream.

    Pointer doubling marks the DP path from node lens[lane] back to 0
    (log2 N rounds, no serial walk); each on-path node i > 0 carries the
    edge (from_[i] -> i) whose token is (from_[i], i - from_[i], dist).
    Returns (t_pos, t_len, t_dist, t_valid, ntok), layouts identical to
    device_matcher.tokenize."""
    L, NP = from_.shape
    lanes = jnp.arange(L)
    lanes2 = lanes[:, None]
    reach = jnp.zeros((L, NP), jnp.int32).at[lanes, lens].set(1)
    h = from_
    steps = max(1, int(NP - 1).bit_length())
    def round_(k, carry):
        h, reach = carry
        hop = jnp.where(reach > 0, h, 0)
        reach = reach.at[lanes2, hop].max(reach)
        h = jnp.take_along_axis(h, h, axis=1)
        return (h, reach)
    h, reach = jax.lax.fori_loop(0, steps, round_, (h, reach))

    node = jnp.arange(NP, dtype=jnp.int32)[None, :]
    mark = (reach > 0) & (node > 0) & (node <= lens[:, None])
    tpos = from_
    tlen = node - from_
    # choice: -1 literal, else the wire distance (len-1 nodes with a
    # distance are shortReps — the TokenEncoder codes them as such)
    tdist = choice

    idx = jnp.cumsum(mark.astype(jnp.int32), axis=1) - 1
    tgt = jnp.where(mark, idx, NP)
    t_pos = jnp.zeros((L, NP), jnp.int32).at[lanes2, tgt].set(tpos, mode="drop")
    t_len = jnp.ones((L, NP), jnp.int32).at[lanes2, tgt].set(tlen, mode="drop")
    t_dist = jnp.full((L, NP), -1, jnp.int32).at[lanes2, tgt].set(
        tdist, mode="drop")
    ntok = jnp.sum(mark.astype(jnp.int32), axis=1)
    t_valid = jnp.arange(NP)[None, :] < ntok[:, None]
    return t_pos, t_len, t_dist, t_valid, ntok


def rep0_trace(t_pos, t_dist, t_valid, N: int):
    """rep0 in effect at every position, from a token stream.

    Scatter each match token's distance at its position, then forward-
    fill (last-match-before-or-at i) via a running max over marked
    indices — no serial walk.  Positions before the first match carry
    the initial rep0 = 0."""
    L, T = t_pos.shape
    lanes2 = jnp.arange(L)[:, None]
    is_match = t_valid & (t_dist >= 0)
    tgt = jnp.where(is_match, jnp.minimum(t_pos, N - 1), N)
    dist_at = jnp.zeros((L, N + 1), jnp.int32).at[lanes2, tgt].set(
        t_dist, mode="drop")[:, :N]
    marked = jnp.zeros((L, N + 1), jnp.int32).at[lanes2, tgt].set(
        1, mode="drop")[:, :N]
    posv = jnp.arange(N, dtype=jnp.int32)[None, :]
    last = jax.lax.cummax(jnp.where(marked > 0, posv, -1), axis=1)
    r0 = jnp.take_along_axis(dist_at, jnp.maximum(last, 0), axis=1)
    return jnp.where(last >= 0, r0, 0)


def _rep_match_lens(data, lens, r0pos, fb: int):
    """LCP of data[i:] with the rep0 source at every position (L, N),
    capped at fb — the vectorized GetMatchLen for one distance per
    position (InWindow.java:120-134 as spec)."""
    L, N = data.shape
    pos = jnp.arange(N, dtype=jnp.int32)[None, :]
    src = pos - r0pos - 1
    valid = src >= 0

    def body(t, carry):
        length, alive = carry
        a = jnp.take_along_axis(data, jnp.minimum(pos + t, N - 1), axis=1)
        b = jnp.take_along_axis(data, jnp.clip(src + t, 0, N - 1), axis=1)
        ok = alive & (a == b) & (pos + t < lens[:, None])
        return (length + ok.astype(jnp.int32), ok)

    length, _ = jax.lax.fori_loop(
        0, fb, body, (jnp.zeros((L, N), jnp.int32), valid))
    return length


def matched_lit_cost(data, probs_ep, r0pos, layout, lc: int, lp: int):
    """Matched-mode literal price per position (L, N), with the match
    byte taken from the rep0-by-position trace (LiteralEncoder.encode-
    Matched semantics, LiteralEncoder.java:26-40)."""
    EP0, EP1 = probs_ep
    L, N = data.shape
    lanes2 = jnp.arange(L)[:, None]
    pos = jnp.arange(N, dtype=jnp.int32)[None, :]
    prev = jnp.pad(data[:, :-1], ((0, 0), (1, 0))).astype(jnp.int32)
    sub = layout.literal + (
        ((pos & ((1 << lp) - 1)) << lc) + (prev >> (8 - lc))
    ) * LITERAL_CODER_SIZE
    byte = data.astype(jnp.int32)
    mb_ix = jnp.clip(pos - r0pos - 1, 0, N - 1)
    mbyte = jnp.take_along_axis(data.astype(jnp.int32), mb_ix, axis=1)
    x = byte ^ mbyte
    m = jnp.ones_like(byte)
    cost = jnp.zeros((L, N), jnp.int32)
    for k in range(8):
        b = (byte >> (7 - k)) & 1
        mbit = (mbyte >> (7 - k)) & 1
        prefix_eq = (x >> (8 - k)) == 0
        cx = sub + jnp.where(prefix_eq, ((1 + mbit) << 8) + m, m)
        cost = cost + jnp.where(b == 1, EP1[lanes2, cx], EP0[lanes2, cx])
        m = (m << 1) | b
    return cost


# ------------------------------------------------------------- pipeline
def _select_dp_pairs(cl, cd, counts, m_dp: int):
    """First m_dp ascending pairs per position, always keeping the
    longest list entry (overwrites slot m_dp-1 when the list is deeper)."""
    L, N, M = cl.shape
    if M <= m_dp:
        pad = m_dp - M
        return (jnp.pad(cl, ((0, 0), (0, 0), (0, pad))),
                jnp.pad(jnp.where(cl >= 2, cd, -1),
                        ((0, 0), (0, 0), (0, pad)), constant_values=-1))
    last = jnp.maximum(counts - 1, 0)[:, :, None]
    ld = cl[:, :, :m_dp]
    dd = jnp.where(cl[:, :, :m_dp] >= 2, cd[:, :, :m_dp], -1)
    tail_l = jnp.take_along_axis(cl, last, axis=2)[:, :, 0]
    tail_d = jnp.take_along_axis(cd, last, axis=2)[:, :, 0]
    deeper = (counts > m_dp)
    ld = ld.at[:, :, m_dp - 1].set(
        jnp.where(deeper, tail_l, ld[:, :, m_dp - 1]))
    dd = dd.at[:, :, m_dp - 1].set(
        jnp.where(deeper, tail_d, dd[:, :, m_dp - 1]))
    return ld, dd


def _seed_from_lists(cl, cd, counts, n, data=None, ext_from: int = 0,
                     ext_to: int = 0, lazy: bool = True,
                     min_len: int = 0):
    """Greedy/lazy statistics seed derived from the candidate LISTS —
    no second search.  The lists are ascending-length per position, so
    the greedy best is the LAST valid pair (longest length at its
    minimal discovered distance); the parse-path/compaction machinery
    is device_matcher's (shared _decide rules).  Replaces the round-4
    lazy `tokenize` seed pass, which re-ran its own find_best_matches —
    the per-phase probe (tools/dp_phase.py) measured that duplicate
    search at 35% of the whole DP pipeline."""
    from .device_matcher import MIN_MATCH, _compact, greedy_path

    max_n = cl.shape[0]
    last = jnp.maximum(counts - 1, 0)[:, None]
    bl = jnp.take_along_axis(cl, last, axis=1)[:, 0]
    bd = jnp.take_along_axis(cd, last, axis=1)[:, 0]
    has = (counts > 0) & (bl >= MIN_MATCH)
    if min_len > MIN_MATCH:
        has = has & (bl >= min_len)
    bl = jnp.where(has, bl, 0)
    bd = jnp.where(has, bd, 0)
    if ext_to > ext_from and data is not None:
        # extend the chosen match past the list depth (lists cap at the
        # RMQ sort depth / fb): the same K-free compare loop as
        # find_best_matches' tail extension — the seed statistics need
        # realistic LONG lengths even though the DP edges stay capped.
        # Only positions capped AT the list depth (blen == ext_from) can
        # grow, so the loop starts there.
        pos = jnp.arange(max_n, dtype=jnp.int32)
        src = pos - bd - 1

        def ext(t, blen):
            a = data[jnp.minimum(pos + t, max_n - 1)]
            b = data[jnp.clip(src + t, 0, max_n - 1)]
            grow = (blen == t) & (a == b) & (pos + t < n) & has
            return blen + grow.astype(jnp.int32)

        bl = jax.lax.fori_loop(ext_from, ext_to, ext, bl)
        bl = jnp.minimum(bl, jnp.maximum(n - pos, 0))
    on_path = greedy_path(bl, bd, n, max_n, 0, lazy)
    return _compact(bl, bd, on_path, n, lazy)


@partial(jax.jit, static_argnames=("fb", "m_dp", "tiers_key", "seed",
                                   "m_cap_search", "m_cap_order"))
def _candidates(data, lens, dict_size, *, fb, m_dp, tiers_key, seed,
                m_cap_search, m_cap_order):
    """Candidate pairs for the DP edges, the suffix rank/table the rep0
    length trace reuses, and the seed token stream."""
    from .device_matcher import _rmq_search, tokenize

    # candidate lists for the DP edges (shared across iterations); the
    # RMQ engine gives identical lists at any fb without the
    # gather-bound compare loop (ops/hybrid._list_engine rationale).
    # m_cap right-sizes the per-position unique-candidate set to the
    # DP's consumption (DESIGN-NOTES.md "Ratio knees"); the suffix
    # rank/table come back for reuse by the rep0-length trace (2
    # gathers/position instead of an fb-round loop)
    tiers = dict(tiers_key)
    cl, cd, counts, s_rank, s_T = jax.vmap(
        lambda d, n: _rmq_search(d, n, dict_size, fb, m_cap=m_cap_search,
                                 m_cap_order=m_cap_order, **tiers)
    )(data, lens)
    ld, dd = _select_dp_pairs(cl, cd, counts, m_dp)

    # pass A seed: lazy parse for the empirical statistics.  seed="lists"
    # reuses the candidate lists above (no second search); seed="lazy" is
    # an independent tokenize pass
    if seed not in ("lists", "lists2", "lists_ext", "lazy"):
        raise ValueError(f"unknown optimal-parse seed mode {seed!r} "
                         "(expected lists | lists2 | lists_ext | lazy)")
    if seed.startswith("lists"):
        from .device_matcher import MATCH_MAX

        # min_len=4 beats both the lazy tokenize seed and the raw-lists
        # seed; extending past the list depth measured slightly worse,
        # so the default does neither search nor extension
        # (DESIGN-NOTES.md "Ratio knees")
        depth = fb  # both searchers cap list lengths at fb
        ext_to = min(MATCH_MAX, 273) if seed == "lists_ext" else 0
        mn = 2 if seed == "lists2" else 4
        tp, tl, td, tv, _ = jax.vmap(
            lambda c, e, k, n, d: _seed_from_lists(
                c, e, k, n, data=d, ext_from=depth, ext_to=ext_to,
                min_len=mn)
        )(cl, cd, counts, lens, data)
    else:
        tp, tl, td, tv, _ = jax.vmap(
            lambda d, n: tokenize(d, n, dict_size, fb, 4)
        )(data, lens)
    return ld, dd, s_rank, s_T, (tp, tl, td, tv)


@partial(jax.jit, static_argnames=("lc", "lp", "pb", "fb"))
def _prices(data, lens, tokens, s_rank, s_T, *, lc, lp, pb, fb):
    """Price model, rep0 trace and rep0 match lengths from the block's
    own token stream (pass B)."""
    from .device_encoder import classify_tokens, lower_tokens
    from .device_matcher import rep_match_lens_rmq

    tp, tl, td, tv = tokens
    N = data.shape[1]
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    meta = classify_tokens(data, tp, tl, td, tv)
    ctx, bits, totals = lower_tokens(data, meta, tp, tl, td, tv,
                                     lc, lp, pb, 10 * N + 128)
    probs = empirical_probs(ctx, bits, totals, layout.size)
    r0pos = rep0_trace(tp, td, tv, N)
    replen = jax.vmap(
        lambda r, t, rp, n: rep_match_lens_rmq(r, t, rp, n, fb)
    )(s_rank, s_T, r0pos, lens)
    model = build_price_model(data, probs, lc, lp, pb, fb, r0pos=r0pos)
    return model, r0pos, replen


def tokenize_optimal(data, lens, dict_size, *, lc, lp, pb, fb,
                     m_dp=DEFAULT_M_DP, full_len_only=False,
                     tiers_key=(("k4", 4), ("k8", 2)), n_iter=1,
                     dp=None, seed="lists", m_cap_search=DP_M_CAP,
                     m_cap_order=DP_M_CAP_ORDER):
    """Full device pipeline: candidate lists -> empirical prices -> DP ->
    tokens.  data (L, N) u8, lens (L,).  Returns (t_pos, t_len, t_dist,
    t_valid, ntok) — same contract as device_matcher.tokenize, ready for
    the host TokenEncoder or the device lowering.

    `n_iter` > 1 re-derives the bit statistics from the DP's OWN token
    stream and reparses — the parse/price fixed-point iteration.  The
    lazy seed parse rarely lands rep-coded matches, so its is_rep /
    rep-length statistics underprice nothing; one extra round lets the
    model see the optimal parse's own symbol mix (the analogue of the
    reference's price adaptation tracking its own output).

    `dp` is the scan (dp_parse, dp_parse_band or dp_parse_triton, all
    token-identical); None picks the backend's (ops/kernels.py)."""
    if dp is None:
        from . import kernels

        dp = kernels.for_platform().dp_scan
    N = data.shape[1]
    ld, dd, s_rank, s_T, tokens = _candidates(
        data, lens, dict_size, fb=fb, m_dp=m_dp, tiers_key=tiers_key,
        seed=seed, m_cap_search=m_cap_search, m_cap_order=m_cap_order)
    for _ in range(max(1, n_iter)):
        model, r0pos, replen = _prices(data, lens, tokens, s_rank, s_T,
                                       lc=lc, lp=lp, pb=pb, fb=fb)
        from_, choice = dp(data, lens, ld, dd, model, fb, pb, full_len_only,
                           r0pos=r0pos, replen=replen)
        tp, tl, td, tv, ntok = extract_tokens(from_, choice, lens)
        # extract_tokens pads to N + fb + 1 columns; the lowering budget
        # is per-position, so trim back to N token slots (a block never
        # holds more than N tokens)
        tokens = (tp[:, :N], tl[:, :N], td[:, :N], tv[:, :N])
    return (*tokens, ntok)


def dp_scan_inputs(data, lens, dict_size, *, lc, lp, pb, fb):
    """Inputs of the first DP scan under the production settings of
    parse="optimal" (ld, dd, model, r0pos, replen) — the same compiled
    stages tokenize_optimal dispatches, for comparing scan
    implementations on identical inputs."""
    ld, dd, s_rank, s_T, tokens = _candidates(
        data, lens, dict_size, fb=fb, m_dp=DEFAULT_M_DP, tiers_key=DP_TIERS,
        seed="lists", m_cap_search=DP_M_CAP, m_cap_order=DP_M_CAP_ORDER)
    model, r0pos, replen = _prices(data, lens, tokens, s_rank, s_T,
                                   lc=lc, lp=lp, pb=pb, fb=fb)
    return ld, dd, model, r0pos, replen
