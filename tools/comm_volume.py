"""Communication-volume accounting for the payload-gather designs:
count the bytes each design's COMPILED program moves
through collectives, at mesh sizes that can be compiled without the cards.

For each N in {8, 64, 256} virtual CPU devices, the three designs of the
ordered ragged result gather (parallel/mesh.py) are compiled over an
N-device mesh and their optimized HLO is scanned for collective
instructions; the table reports bytes-moved per design (the output-shape
bytes of every all-gather/all-reduce/collective-permute instruction,
the standard ring-algorithm accounting: each device sends/receives
(N-1)/N of the replicated output, so output bytes upper-bound the
per-link traffic and exactly measure the replication factor).

Designs:
  sharded-out   results stay block-sharded; host reads each shard once —
                NO collective (the single-host default)
  gather-all    all_gather of (sizes, padded payload) — every device
                ends with every block (required multi-host; round-1
                default everywhere)
  reduce-gather psum of one-hot-placed payloads — the "gather to
                coordinator via reduction" strawman; counted to show it
                moves MORE than all_gather (ring all-reduce transfers
                ~2x the buffer)

Each design runs once per N in a subprocess (device count is fixed at
process start by XLA_FLAGS).

Usage: python tools/comm_volume.py            # full table
       python tools/comm_volume.py --one N    # one mesh size (internal)
"""
import json
import os
import re
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    globals().get("__file__", "tools/x.py"))))
sys.path.insert(0, _ROOT)

# per-device local result shape: L lanes x B payload bytes (+ L sizes).
# 64 KB blocks, 4 blocks per device — MB-scale per-device payloads at
# pod widths (256 dev x 256 KB = 64 MB total), the design point where
# the replication factor is the first bandwidth cliff.
L, B = 4, 1 << 16


def collective_bytes(hlo_text: str) -> dict:
    """Sum output-shape bytes of collective instructions in optimized HLO."""
    sizes = {"all-gather": 0, "all-reduce": 0, "collective-permute": 0,
             "all-to-all": 0}
    dt_bytes = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
                "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8}
    # matches e.g.:  %ag = s32[256,4,65536] all-gather(...)
    pat = re.compile(
        r"=\s*(?:\()?\s*([a-z0-9]+)\[([0-9,]*)\][^=]*?\b"
        r"(all-gather|all-reduce|collective-permute|all-to-all)\(")
    for m in pat.finditer(hlo_text):
        dt, dims, op = m.group(1), m.group(2), m.group(3)
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        sizes[op] += n * dt_bytes.get(dt, 4)
    return sizes


def run_one(n_dev: int):
    import jax

    # virtual CPU devices: the count comes from XLA_FLAGS (see main)
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    assert jax.device_count() == n_dev, (jax.device_count(), n_dev)
    mesh = Mesh(np.asarray(jax.devices()), ("blocks",))

    def local_result(data_l):
        # stand-in for the device-local encode: the gather design is what
        # is being compiled/accounted, not the local compute
        return data_l + 1, jnp.sum(data_l, axis=1).astype(jnp.int32)

    def design_sharded(data_l):
        comp, lens = local_result(data_l)
        return comp, lens

    def design_gather_all(data_l):
        comp, lens = local_result(data_l)
        return (jax.lax.all_gather(comp, "blocks", tiled=True),
                jax.lax.all_gather(lens, "blocks", tiled=True))

    def design_reduce(data_l):
        comp, lens = local_result(data_l)
        i = jax.lax.axis_index("blocks")
        full = jnp.zeros((n_dev * L, B), comp.dtype)
        full = jax.lax.dynamic_update_slice(full, comp, (i * L, 0))
        fl = jnp.zeros((n_dev * L,), lens.dtype)
        fl = jax.lax.dynamic_update_slice(fl, lens, (i * L,))
        return (jax.lax.psum(full, "blocks"), jax.lax.psum(fl, "blocks"))

    data = jnp.zeros((n_dev * L, B), jnp.int32)
    out = {}
    for name, fn, ospec in [
        ("sharded-out", design_sharded, (P("blocks", None), P("blocks"))),
        ("gather-all", design_gather_all, (P(None, None), P(None))),
        ("reduce-gather", design_reduce, (P(None, None), P(None))),
    ]:
        f = jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=(P("blocks", None),), out_specs=ospec,
            check_vma=False))
        hlo = f.lower(data).compile().as_text()
        out[name] = collective_bytes(hlo)
    print(json.dumps({"n_dev": n_dev, "designs": out}))


def main():
    if "--one" in sys.argv:
        run_one(int(sys.argv[sys.argv.index("--one") + 1]))
        return
    total_payload = None
    rows = []
    for n in (8, 64, 256):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            f" --xla_force_host_platform_device_count={n}")
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", str(n)],
            capture_output=True, text=True, env=env, timeout=1200)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        if not line:
            print(f"N={n}: FAILED\n{r.stderr[-2000:]}")
            continue
        rows.append(json.loads(line[-1]))
    print(f"\nper-device local result: {L} x {B} B payload (int32 words) "
          f"+ {L} sizes; total payload = N x {L*B*4} B")
    print("fabric bytes = TOTAL ring-algorithm traffic derived from the "
          "HLO-counted per-device\ncollective output sizes: all-gather "
          "sends output x (N-1)/N per device = output x (N-1)\ntotal; "
          "ring all-reduce moves 2x that (reduce-scatter + all-gather "
          "phases)")
    print(f"{'N':>4} {'design':14} {'collective out B':>17} "
          f"{'fabric B':>16} {'x total payload':>16}")
    for row in rows:
        n = row["n_dev"]
        payload = n * L * B * 4  # total compressed payload bytes (int32)
        for name, s in row["designs"].items():
            out_b = sum(s.values())
            fabric = (s["all-gather"] * (n - 1)
                      + 2 * s["all-reduce"] * (n - 1)
                      + s["collective-permute"] + s["all-to-all"])
            print(f"{n:>4} {name:14} {out_b:>17,} {fabric:>16,} "
                  f"{fabric/payload:>15.1f}x")


if __name__ == "__main__":
    main()
