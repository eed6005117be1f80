"""Which implementation each device step runs: the Pallas-Triton kernel
on a GPU, the XLA form elsewhere — chosen by platform, never by a flag;
and where the compilation cache lives."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.ops import device_decoder, device_encoder, device_parser, kernels
from lzma_tpu.utils import compile_cache


class Reached(Exception):
    """Raised by a stand-in kernel once the entry point has called it."""


def _stand_in(calls):
    def kernel(*args, **kw):
        calls.append((args, kw))
        raise Reached
    return kernel


def test_cpu_runs_the_xla_forms():
    assert jax.default_backend() == "cpu"
    assert kernels.for_platform() == kernels.Kernels(
        device_parser.dp_parse_band, device_encoder.serialize_xla,
        device_decoder.decode_fsm_xla)


@pytest.fixture
def as_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def test_gpu_picks_the_dp_kernel(as_gpu):
    assert kernels.for_platform().dp_scan is device_parser.dp_parse_triton


def _encode_one_lane():
    data = jnp.asarray(np.frombuffer(b"abcabcabcd" * 8, np.uint8)[None, :])
    device_encoder.encode_lanes(data, jnp.asarray([80], jnp.int32),
                                jnp.int32(80), lc=3, lp=0, pb=2, fb=32)


def test_gpu_picks_the_range_coder_kernel(as_gpu, monkeypatch):
    from lzma_tpu.ops import triton_serializer

    calls = []
    monkeypatch.setattr(triton_serializer, "serialize_triton",
                        _stand_in(calls))
    monkeypatch.setattr(device_encoder, "serialize_xla",
                        lambda *a: pytest.fail("XLA coder on a GPU"))
    assert kernels.for_platform().serialize is triton_serializer.serialize_triton
    with pytest.raises(Reached):
        _encode_one_lane()
    assert len(calls) == 1


def test_gpu_picks_the_decoder_kernel(as_gpu, monkeypatch):
    from lzma_tpu.ops import triton_decoder

    calls = []
    monkeypatch.setattr(triton_decoder, "decode_fsm_triton", _stand_in(calls))
    monkeypatch.setattr(device_decoder, "decode_fsm_xla",
                        lambda *a, **k: pytest.fail("XLA FSM on a GPU"))
    assert kernels.for_platform().decode_fsm is triton_decoder.decode_fsm_triton
    with pytest.raises(Reached):
        device_decoder.decode_batch([bytes(20)], LzmaParams(), [64])
    (args, kw), = calls
    assert args[4:8] == (3, 0, 2, 64) and kw == {"preset": None}


def test_cpu_serialize_is_the_xla_coder(monkeypatch):
    calls = []
    monkeypatch.setattr(device_encoder, "serialize_xla", _stand_in(calls))
    with pytest.raises(Reached):
        _encode_one_lane()
    assert len(calls) == 1


def test_dp_kernel_rows_cover_the_band():
    # nodes i - fb .. i + fb must map to distinct ring rows
    for fb in (5, 16, 31, 32, 33, 128, 273):
        R = device_parser._ring_rows(fb)
        assert R > fb and R & (R - 1) == 0


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honors_the_variable(monkeypatch, tmp_path,
                                           restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_to_the_checkout(monkeypatch,
                                                restore_cache_dir):
    import os

    import lzma_tpu

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        lzma_tpu.__file__)))
    want = os.path.join(root, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_importing_the_library_sets_no_cache():
    import subprocess
    import sys

    code = ("import jax, lzma_tpu, lzma_tpu.ops.api, lzma_tpu.cli; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {k: v for k, v in __import__("os").environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"
