"""Virtual-mesh scaling measurement.

Runs the sharded block codec on an N-device virtual CPU mesh
(N in {1,2,4,8}) over an MB-scale payload and records:
  - encode/decode step wall time and derived efficiency vs 1 device
  - the payload-gather cost: gather-to-all (all_gather, the multi-host
    form) vs sharded-out (no collective, the single-host form)

Caveat printed with the numbers: on a host with few physical cores all N
virtual devices timeshare those cores — compute cannot speed up with N; what
this isolates is the COLLECTIVE/overhead curve, i.e. how much the
gather design costs as N grows at fixed total work.

Usage: python tools/mesh_scaling.py [total_mb]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np

from lzma_tpu.bench.datagen import generate_bench_data
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.parallel.mesh import (
    _MeshHolder, _decode_step, _encode_step, _pad_lanes, make_mesh)


def main(total_mb=4):
    total = total_mb << 20
    bs = 1 << 16
    data = generate_bench_data(total)
    params = LzmaParams(dict_size=bs, fast_bytes=16)
    n_blocks = total // bs
    arr = np.frombuffer(data, np.uint8).reshape(n_blocks, bs)
    print(f"payload {total >> 20} MB, {n_blocks} x {bs >> 10} KB blocks")

    devs = jax.devices()
    rows = []
    for nd in (1, 2, 4, 8):
        mesh = make_mesh(devs[:nd])
        lanes = _pad_lanes(n_blocks, nd)
        a = np.zeros((lanes, bs), np.uint8)
        a[:n_blocks] = arr
        lens = np.full(lanes, bs, np.int32)
        lens[n_blocks:] = 0
        aj, lj = jnp.asarray(a), jnp.asarray(lens)
        hold = _MeshHolder(mesh)
        for gather in (True, False):
            kw = dict(lc=3, lp=0, pb=2, fb=16, mesh_holder=hold,
                      gather=gather)

            def enc():
                comp, clens = _encode_step(aj, lj, jnp.int32(bs), **kw)
                jax.block_until_ready(comp)
                return comp, clens

            comp, clens = enc()
            t0 = time.perf_counter()
            enc()
            t_enc = time.perf_counter() - t0

            comp_h = np.asarray(comp)
            clens_h = np.asarray(clens)
            cj = jnp.asarray(comp_h)
            clj = jnp.asarray(clens_h)
            sizes = jnp.asarray(lens)

            def dec():
                out, ok = _decode_step(
                    cj, clj, sizes, np.int64(bs), lc=3, lp=0, pb=2,
                    max_out=bs, mesh_holder=hold, gather=gather)
                jax.block_until_ready(out)
                return out, ok

            out, ok = dec()
            assert bool(np.asarray(ok)[:n_blocks].all())
            o = np.asarray(out)[:n_blocks]
            assert np.array_equal(o, arr), "round trip mismatch"
            t0 = time.perf_counter()
            dec()
            t_dec = time.perf_counter() - t0
            rows.append((nd, gather, t_enc, t_dec))
            print(f"devices={nd} gather={'all' if gather else 'sharded'}: "
                  f"enc {t_enc:6.2f}s ({total/t_enc/1e6:5.1f} MB/s)  "
                  f"dec {t_dec:6.2f}s ({total/t_dec/1e6:5.1f} MB/s)")
    # gather-cost isolation: same N, two designs
    print("\npayload-gather overhead (gather-all minus sharded, same N):")
    for nd in (1, 2, 4, 8):
        g = next(r for r in rows if r[0] == nd and r[1])
        s = next(r for r in rows if r[0] == nd and not r[1])
        print(f"  devices={nd}: enc +{(g[2]-s[2])*1e3:7.1f} ms   "
              f"dec +{(g[3]-s[3])*1e3:7.1f} ms")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
