"""CLI surface tests (switch grammar parity with LzmaAlone.java:42-134)."""

import lzma
import subprocess
import sys

import pytest

from lzma_tpu.cli import CommandLine


def test_switch_grammar():
    c = CommandLine()
    assert c.parse(["e", "-d16", "-fb32", "-lc0", "-lp1", "-pb0", "-eos", "-mfbt2", "a", "b"])
    assert c.command == "e" and c.dict_size == 1 << 16 and c.fb == 32
    assert (c.lc, c.lp, c.pb) == (0, 1, 0) and c.eos and c.match_finder == "bt2"
    assert c.in_file == "a" and c.out_file == "b"


def test_switch_mode_toggle():
    c = CommandLine()
    assert c.parse(["e", "--", "-weird-name", "out"])
    assert c.in_file == "-weird-name"


def test_bad_switches_rejected():
    for args in (["x"], ["e", "-mfxx", "a", "b"], ["e", "-dxx", "a", "b"], ["b", "0"], ["e", "a", "b", "c"], [""]):
        assert not CommandLine().parse(args), args


def test_bt4b_alias():
    c = CommandLine()
    assert c.parse(["e", "-mfbt4b", "a", "b"])
    assert c.match_finder == "bt4"


def test_benchmark_passes_arg():
    c = CommandLine()
    assert c.parse(["b", "3"])
    assert c.num_passes == 3


@pytest.mark.parametrize("extra", [[], ["-bs8192", "-t2"]])
def test_cli_end_to_end(tmp_path, extra):
    src = tmp_path / "in.bin"
    comp = tmp_path / "out.lzma"
    back = tmp_path / "back.bin"
    data = (b"the cli must round trip " * 500)[:9001]
    src.write_bytes(data)
    run = lambda a: subprocess.run(
        [sys.executable, "-m", "lzma_tpu", *a], cwd="/root/repo", capture_output=True, text=True
    )
    r = run(["e", "-d16", "-fb16", *extra, str(src), str(comp)])
    assert r.returncode == 0, r.stderr
    r = run(["d", str(comp), str(back)])
    assert r.returncode == 0, r.stderr
    assert back.read_bytes() == data
    if not extra:  # single-stream .lzma must also decode with stock liblzma
        assert lzma.decompress(comp.read_bytes(), format=lzma.FORMAT_ALONE) == data


def test_cli_help(capsys):
    from lzma_tpu.cli import main

    assert main([]) == 0
    assert "Usage" in capsys.readouterr().out


def test_cli_invalid_params_clean_error(tmp_path, capsys):
    from lzma_tpu.cli import main

    src = tmp_path / "in.bin"
    src.write_bytes(b"hello world" * 100)
    dst = tmp_path / "out.lzma"
    # fb below 5 must print a clean error, not a traceback
    assert main(["e", "-fb4", str(src), str(dst)]) == 1
    assert "error:" in capsys.readouterr().out


def test_cli_corrupt_input_clean_error(tmp_path, capsys):
    from lzma_tpu.cli import main

    bad = tmp_path / "bad.lzma"
    bad.write_bytes(b"\x5d\x00\x00\x01\x00" + (200).to_bytes(8, "little") + b"\x00garbagegarbage")
    out = tmp_path / "out.bin"
    assert main(["d", str(bad), str(out)]) == 1
    assert "error:" in capsys.readouterr().out


def test_cli_hybrid_backend(tmp_path):
    jax = pytest.importorskip("jax")
    from lzma_tpu.runtime import native

    if not native.available():
        pytest.skip("hybrid needs the native runtime")
    from lzma_tpu.cli import main

    data = (b"hybrid cli roundtrip payload " * 400)[:9000]
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    out = tmp_path / "out.lztb"
    back = tmp_path / "back.bin"
    assert main(["e", "-backendhybrid", "-bs4096", "-d14",
                 str(src), str(out)]) == 0
    assert main(["d", "-backendhybrid", str(out), str(back)]) == 0
    assert back.read_bytes() == data
    # hybrid without -bs is an error
    assert main(["e", "-backendhybrid", str(src), str(out)]) == 1


def test_cli_explicit_native_fails_loud_when_unavailable(tmp_path, capsys, monkeypatch):
    """-backendnative must never silently substitute the scalar codec."""
    from lzma_tpu.cli import main
    from lzma_tpu.runtime import native

    monkeypatch.setattr(native, "available", lambda: False)
    src = tmp_path / "in.bin"
    src.write_bytes(b"hello" * 200)
    dst = tmp_path / "out"
    assert main(["e", "-backendnative", str(src), str(dst)]) == 1
    out = capsys.readouterr().out
    assert "error:" in out and "native" in out


def test_cli_tune_with_bad_switch_clean_error(tmp_path, capsys):
    """-tune validation errors must print 'error: ...', not a traceback."""
    from lzma_tpu.cli import main

    src = tmp_path / "in.bin"
    src.write_bytes(b"hello world" * 200)
    assert main(["e", "-tune", "-lc9", str(src), str(tmp_path / "o")]) == 1
    assert "error:" in capsys.readouterr().out


def test_cli_bench_bad_dict_clean_error(capsys):
    from lzma_tpu.cli import main

    assert main(["b", "-d17"]) == 1
    assert "error:" in capsys.readouterr().out


def test_cli_bench_hybrid_backend(monkeypatch):
    """`b -backendhybrid` rates the hybrid-optimal pipeline (round 3:
    every backend is ratable by the LzmaBench round trip).  The full
    2.25 MB benchmark pass is too slow for CI, so the harness is
    intercepted and the wired encode/decode functions round-trip a
    small payload instead."""
    import pytest

    pytest.importorskip("jax")
    from lzma_tpu.runtime import native

    if not native.available():
        pytest.skip("hybrid rating needs the native runtime")
    import lzma_tpu.cli as cli

    captured = {}

    def fake_benchmark(num_passes, dict_size, params=None, encode_fn=None,
                       decode_fn=None):
        captured["enc"] = encode_fn
        captured["dec"] = decode_fn

    monkeypatch.setattr(cli, "run_benchmark", fake_benchmark, raising=False)
    import lzma_tpu.bench.harness as harness

    monkeypatch.setattr(harness, "run_benchmark", fake_benchmark)
    assert cli.main(["b", "1", "-backendhybrid"]) == 0
    data = (b"cli hybrid bench payload " * 100)[:2000]
    comp = captured["enc"](data)
    assert captured["dec"](comp, len(data)) == data


def test_backend_device_switch():
    c = CommandLine()
    assert c.parse(["e", "-backenddevice", "a", "b"])
    assert c.backend == "device"
    assert not CommandLine().parse(["e", "-backendtpu", "a", "b"])


@pytest.fixture
def keep_cache_dir():
    import jax

    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cli_device_backend_roundtrip(tmp_path, keep_cache_dir):
    """e/d through the device backend in-process: a .lzma single stream
    and an LZTB container, both read back by liblzma or the device."""
    from lzma_tpu.cli import main

    data = (b"device backend cli " * 300)[:4000]
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    alone = tmp_path / "out.lzma"
    assert main(["e", "-backenddevice", "-q", "-d12", "-fb32", str(src),
                 str(alone)]) == 0
    assert lzma.decompress(alone.read_bytes(), format=lzma.FORMAT_ALONE) == data
    lztb = tmp_path / "out.lztb"
    back = tmp_path / "back.bin"
    assert main(["e", "-backenddevice", "-q", "-d12", "-fb32", "-bs1024",
                 str(src), str(lztb)]) == 0
    assert main(["d", "-backenddevice", "-q", str(lztb), str(back)]) == 0
    assert back.read_bytes() == data
