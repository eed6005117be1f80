"""m_cap right-sizing sweep for the DP-pipeline candidate search:
the deep tier ladder computes ~29 candidate
columns/position while the DP consumes ~4 merged pairs; after the
round-5 cross-tier dedup, `m_cap` truncates each position's unique
candidate set to the m_cap nearest BEFORE the LCP queries.  This sweep
measures what that truncation costs in ratio (exact container sizes via
the native TokenEncoder) so the production cap sits at the measured
knee; chip speed per cap is measured separately (tools/dp_chip.py).

Also prints the unique-candidate count distribution (the overlap the
dedup removes) once.

Usage: python tools/mcap_sweep.py [size_mb] [caps...]   (cpu jax)
Env: MCAP_ORDER=near|rr (truncation priority; round 5)
"""
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    globals().get("__file__", "tools/x.py"))))
sys.path.insert(0, _ROOT)
from lzma_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

from lzma_tpu.bench.corpus import frozen_corpus
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.ops.device_parser import DP_TIERS, tokenize_optimal
from lzma_tpu.runtime import native

SIZE = (int(sys.argv[1]) if len(sys.argv) > 1 else 1) << 20
CAPS = [int(c) for c in sys.argv[2:]] or [0, 6, 8, 10, 12, 16]
BS, FB = 1 << 16, 32

data = frozen_corpus()[:SIZE]
L = len(data) // BS
data = data[: L * BS]
arr = jnp.asarray(np.frombuffer(data, np.uint8).reshape(L, BS))
lens = jnp.full((L,), BS, jnp.int32)
p = LzmaParams(dict_size=BS, fast_bytes=FB)

# unique-candidate distribution at the deep ladder (dedup headroom)
from lzma_tpu.ops.device_matcher import find_match_lists_rmq

cl, cd, counts = jax.vmap(
    lambda d, n: find_match_lists_rmq(d, n, jnp.int32(BS), FB,
                                      **dict(DP_TIERS)))(arr, lens)
# count valid (deduped) candidate columns per position: lens>0 columns
# in the PRE-merge sense are not exposed; report merged-pair stats and
# the ratio table which is what production consumes
cnp = np.asarray(counts)
print(f"merged pairs/pos: mean {cnp.mean():.2f} p99 "
      f"{np.percentile(cnp, 99):.0f} max {cnp.max()}")

# native bt4-opt anchor
blob_bt = native.encode_blocks(bytes(data), p, block_size=BS, num_threads=0)
print(f"anchor native bt4-opt: {len(blob_bt)} B")


ORDER = os.environ.get("MCAP_ORDER", "near")


def size_at(m_cap):
    t0 = time.perf_counter()
    tp, tl, td, tv, ntok = tokenize_optimal(
        arr, lens, jnp.int32(BS), lc=3, lp=0, pb=2, fb=FB,
        tiers_key=DP_TIERS, n_iter=2, m_cap_search=m_cap,
        m_cap_order=ORDER)
    jax.block_until_ready(tp)
    t_tok = time.perf_counter() - t0
    tpn, tln, tdn, tvn = (np.asarray(x) for x in (tp, tl, td, tv))
    nn = np.asarray(ntok)
    fp = np.concatenate([tpn[i, : nn[i]] for i in range(L)])
    fl = np.concatenate([tln[i, : nn[i]] for i in range(L)])
    fd = np.concatenate([tdn[i, : nn[i]] for i in range(L)])
    offsets = np.zeros(L, np.int64)
    np.cumsum(nn[:-1].astype(np.int64), out=offsets[1:])
    payload, sizes = native.encode_token_blocks(
        np.frombuffer(data, np.uint8), BS, 3, 0, 2,
        fp.astype(np.int32), fl.astype(np.int32), fd.astype(np.int32),
        offsets, nn.astype(np.int64))
    return sum(sizes) + 4 * L, t_tok


base = None
for cap in CAPS:
    sz, t_tok = size_at(cap)
    d_bt = (sz - len(blob_bt)) / len(blob_bt) * 100
    note = ""
    if base is None and cap == 0:
        base = sz
    elif base is not None:
        note = f"  vs m_cap=0 {(sz - base) / base * 100:+.3f}%"
    print(f"m_cap={cap or 'off':>3}: {sz} B  vs bt4-opt {d_bt:+.2f}%  "
          f"(cpu tokenize {t_tok:.1f}s){note}")
