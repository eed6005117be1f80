"""Frozen real-file benchmark corpus.

There is no network (Silesia/Calgary/enwik unavailable — BASELINE
configs 0/1/4), so run-over-run ratio comparability comes from a
hash-pinned local corpus instead:

  text part   — 3 MiB of CPython stdlib sources, committed to the repo
                xz-compressed (bench/data/corpus_text.bin.xz) so it never
                drifts with the host's stdlib.
  binary part — ~1.1 MiB sliced from the reference's own golden fixture
                (/root/reference/src/test/java/SevenZip/firefox.exe,
                LzmaAloneTest.java:27-38; md5 pinned below), read at
                runtime from the mounted reference tree.  The whole file
                plus a slice from its 3/4 point, so the corpus mixes
                code/data/resource sections.

`frozen_corpus()` returns the ~4.1 MiB concatenation and verifies its
SHA-256, making every run's ratio/throughput numbers directly
comparable.
"""

from __future__ import annotations

import hashlib
import lzma
import os

_HERE = os.path.dirname(os.path.abspath(__file__))
TEXT_PATH = os.path.join(_HERE, "data", "corpus_text.bin.xz")
FIXTURE = "/root/reference/src/test/java/SevenZip/firefox.exe"
FIXTURE_MD5 = "5744fff8e72d105c138dae9e17bb29fe"

TEXT_SHA256 = "7077138c62b248a472eca5ce8ab94838a17f2d6746e3f4999bbb53f6617c287a"
CORPUS_SHA256 = "10711445fd42bc9665cd64cc996268e70682659de0b1a6a65661dedec5991142"
CORPUS_SIZE = (3 << 20) + 916960 + 232928  # text + fixture + 3/4-point slice


def text_part() -> bytes:
    with open(TEXT_PATH, "rb") as fh:
        text = lzma.decompress(fh.read())
    if hashlib.sha256(text).hexdigest() != TEXT_SHA256:
        raise RuntimeError("committed corpus text part corrupted")
    return text


def binary_part() -> bytes:
    """The 916,960-byte reference fixture plus a slice re-read from its
    3/4 point (the fixture is smaller than 1 MiB, so the head slice is
    the whole file; the tail slice re-covers the resource sections)."""
    with open(FIXTURE, "rb") as fh:
        fx = fh.read()
    if hashlib.md5(fx).hexdigest() != FIXTURE_MD5:
        raise RuntimeError("reference fixture bytes changed")
    a = fx[: 1 << 20]
    off = (len(fx) * 3 // 4) & ~0xFFF
    b = fx[off : off + (1 << 20)]
    return a + b


def available() -> bool:
    return os.path.exists(TEXT_PATH) and os.path.exists(FIXTURE)


def frozen_corpus() -> bytes:
    data = text_part() + binary_part()
    assert len(data) == CORPUS_SIZE, len(data)
    digest = hashlib.sha256(data).hexdigest()
    if CORPUS_SHA256 and digest != CORPUS_SHA256:
        raise RuntimeError(f"frozen corpus drifted: {digest}")
    return data


if __name__ == "__main__":
    data = text_part() + binary_part()
    print(len(data), hashlib.sha256(data).hexdigest())
