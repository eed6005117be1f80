"""Test env: JAX on a virtual 8-device CPU mesh.

Device tests validate multi-device sharding without accelerator hardware.
The platform is flipped through jax.config, which takes effect because no
backend has been initialized yet; it must run before anything calls
jax.devices().  `LZMA_TPU_TEST_PLATFORM=gpu` leaves the platform alone so
the `gpu`-marked tests can run on a card (chip_smoke.py runs them).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

try:
    import jax

    if os.environ.get("LZMA_TPU_TEST_PLATFORM") != "gpu":
        jax.config.update("jax_platforms", "cpu")
except ImportError:  # jax-less environments still run the scalar/native tests
    pass

REFERENCE_FIXTURE = "/root/reference/src/test/java/SevenZip/firefox.exe"


def fixture_bytes(limit=None):
    with open(REFERENCE_FIXTURE, "rb") as f:
        data = f.read() if limit is None else f.read(limit)
    return data


def has_reference():
    return os.path.exists(REFERENCE_FIXTURE)


import pytest


def traced_arrays(fn, *args):
    """Trace fn(*args) (arrays or jax.ShapeDtypeStruct; nothing runs)
    and return (arrays, calls): the avals of every array it makes
    outside its kernels, and for each pallas_call the avals of its
    operands and results."""
    import jax

    arrays, calls = [], []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                calls.append([v.aval for v in (*eqn.invars, *eqn.outvars)])
                continue
            arrays.extend(v.aval for v in eqn.outvars)
            for p in eqn.params.values():
                for sub in p if isinstance(p, (list, tuple)) else (p,):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return arrays, calls


def nbytes(aval):
    return aval.size * aval.dtype.itemsize


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled-executable references between test modules.

    The full suite accumulates hundreds of XLA CPU executables in one
    process; past that, a later compile can SEGFAULT inside
    backend_compile_and_load (LLVM JIT code-memory exhaustion, seen only
    with many preceding modules loaded, never in any subset).
    Per-module cache clearing keeps the live-executable population
    bounded; modules recompile what they reuse."""
    yield
    try:
        import jax

        jax.clear_caches()
    except Exception:
        pass


@pytest.fixture
def triton_interpret(monkeypatch):
    """Route the device codec's platform choice (ops/kernels.py) to its
    Pallas-Triton kernels in interpret mode, so the normal entry points
    (encode_batch, decode_batch, tokenize_optimal, the mesh steps) run
    the GPU kernels' code on the CPU.  Compiled programs are dropped on
    both sides: jitted callers (the mesh steps) must retrace through the
    patched choice."""
    from functools import partial

    import jax

    from lzma_tpu.ops import kernels
    from lzma_tpu.ops.device_parser import dp_parse_triton
    from lzma_tpu.ops.triton_decoder import decode_fsm_triton
    from lzma_tpu.ops.triton_serializer import serialize_triton

    chosen = kernels.Kernels(
        *(partial(k, interpret=True)
          for k in (dp_parse_triton, serialize_triton, decode_fsm_triton)))
    monkeypatch.setattr(kernels, "for_platform", lambda: chosen)
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX device platform is {dev.platform!r}); "
                    "run by chip_smoke.py on the card")
    return dev
