"""Sub-phase attribution of the DP pipeline's stats pass on chip:
classify (lax.scan state machine) | lower (slot scatters) | empirical
(arena scatter-adds).  Readback protocol, median of 3.

Usage: python tools/stats_phase.py [lanes] [log2_bs] [--cpu]
"""
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    globals().get("__file__", "tools/x.py"))))
sys.path.insert(0, _ROOT)
from lzma_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import numpy as np

if "--cpu" in sys.argv:
    sys.argv.remove("--cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
import jax
import jax.numpy as jnp

from lzma_tpu.bench.corpus import frozen_corpus
from lzma_tpu.core.layout import ProbLayout
from lzma_tpu.ops import device_parser as P
from lzma_tpu.ops.device_encoder import classify_tokens, lower_tokens
from lzma_tpu.ops.device_matcher import _rmq_search

L = int(sys.argv[1]) if len(sys.argv) > 1 else 32
BS = 1 << (int(sys.argv[2]) if len(sys.argv) > 2 else 16)
FB, LC, LP, PB = 32, 3, 0, 2
TIERS = dict(k4=12, k6=4, k8=6, k16=3, k32=2)

corpus = frozen_corpus()
reps = (L * BS + len(corpus) - 1) // len(corpus)
blob = (corpus * reps)[: L * BS]
arr = jnp.asarray(np.frombuffer(blob, np.uint8).reshape(L, BS))
lens = jnp.full((L,), BS, jnp.int32)
layout = ProbLayout(LC, LP, PB, pos_bits=PB)
max_bits = 10 * BS + 128
total = L * BS


@jax.jit
def f_seedtok(a):
    cl, cd, counts, rank, T = jax.vmap(
        lambda d, n: _rmq_search(d, n, jnp.int32(BS), FB, **TIERS))(a, lens)
    return jax.vmap(lambda c, e, k, n, d: P._seed_from_lists(
        c, e, k, n, data=d, ext_from=FB, ext_to=0, min_len=4)
    )(cl, cd, counts, lens, a)


@jax.jit
def f_classify(a, tp, tl, td, tv):
    return classify_tokens(a, tp, tl, td, tv)


@jax.jit
def f_lower(a, meta, tp, tl, td, tv):
    return lower_tokens(a, meta, tp, tl, td, tv, LC, LP, PB, max_bits)


@jax.jit
def f_empirical(ctx, bits, totals):
    return P.empirical_probs(ctx, bits, totals, layout.size)


def timed(name, fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn(*args)
        leaves = jax.tree_util.tree_leaves(out)
        _ = sum(int(jnp.sum(l.astype(jnp.int32))) for l in leaves[:2])
        ts.append(time.perf_counter() - t0)
    ts.sort()
    print(f"{name:10s} {ts[1]*1e3:8.0f} ms (min {ts[0]*1e3:.0f}, "
          f"max {ts[2]*1e3:.0f})")
    return out, ts[1]


print(f"config: {L} x {BS >> 10} KB, backend={jax.default_backend()}")
(tp, tl, td, tv, ntok), _ = timed("seedtok", f_seedtok, arr)
meta, t_c = timed("classify", f_classify, arr, tp, tl, td, tv)
(ctx, bits, totals), t_l = timed("lower", f_lower, arr, meta, tp, tl, td, tv)
probs, t_e = timed("empirical", f_empirical, ctx, bits, totals)
tot = t_c + t_l + t_e
print(f"stats sum {tot*1e3:.0f} ms (classify {100*t_c/tot:.0f}%, lower "
      f"{100*t_l/tot:.0f}%, empirical {100*t_e/tot:.0f}%)")
