"""chip_smoke.py on the CPU: it refuses to run without a GPU or without
the codec beside it, and the container it pins is the CPU's."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except ValueError:
            pass
    return False


def test_smoke_refuses_without_gpu():
    r = _run(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not _printed_result(r.stdout)


def test_smoke_refuses_without_the_codec(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert not _printed_result(r.stdout)


def test_pinned_container_hash():
    """The device container of the pinned input, computed here on the
    CPU; chip_smoke.py requires the card's to be the same bytes."""
    import lzma_tpu
    from lzma_tpu.bench.corpus import text_part

    data = text_part()[:chip_smoke.PIN_BYTES]
    blob = lzma_tpu.compress(data, container="lztb", backend="device",
                             block_size=chip_smoke.PIN_BLOCK)
    assert hashlib.sha256(blob).hexdigest() == chip_smoke.PIN_SHA256
    assert lzma_tpu.decompress(blob) == data
