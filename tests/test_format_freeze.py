"""Wire-format freeze: exact container bytes pinned by hash.

The reference pins its encoder output exactly (size + md5 per config,
LzmaAloneTest.java:27-38) so that format or codec drift is a test
failure, not a silent change.  tests/test_golden_sizes.py does that for
the `.lzma` container; this file does the same for OUR LZTB container
in all three versions, including the trained dictionary (whose builder
is part of the v3 wire contract in practice: re-training with changed
defaults yields a different container).

If a change here is INTENTIONAL (format revision, trainer improvement),
update the hashes in the same commit and say so — that is the point.
"""

import hashlib

import pytest

from conftest import REFERENCE_FIXTURE, has_reference
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.parallel import blocks as blk
from lzma_tpu.utils.dicttrain import train_dictionary

PARAMS = LzmaParams(dict_size=1 << 16, fast_bytes=32)
N = 262144
BS = 1 << 15

GOLDEN = {
    "v1": (85729, "c83039c98ddc2c7449cf1afc643601b7"),
    "v2": (85768, "91d5eaac97fe12868582e8a1cf6dd767"),
    # dict/v3 re-pinned 2026-08-19: trainer d-mer table 2^17 -> 2^19
    # (measured ratio win) — the
    # new v3 container is 194 B smaller on this fixture
    "v3": (87108, "2a642dd2e9e7e14052b67f83dc7ce840"),
    "dict": (4096, "c56eac7ec9562d6992b36c0fe7f4d8a3"),
}


def _fixture():
    if not has_reference():
        pytest.skip("reference fixture unavailable")
    with open(REFERENCE_FIXTURE, "rb") as f:
        return f.read(N)


def _check(tag, blob):
    size, md5 = GOLDEN[tag]
    assert (len(blob), hashlib.md5(blob).hexdigest()) == (size, md5), (
        f"LZTB {tag} container bytes changed — if intentional, update "
        f"GOLDEN in the same commit: got ({len(blob)}, "
        f"{hashlib.md5(blob).hexdigest()!r})"
    )


@pytest.fixture(scope="module")
def codec():
    try:
        from lzma_tpu.runtime import native

        if native.available():
            return native
    except Exception:
        pass
    return blk  # scalar fallback is byte-identical (pinned elsewhere)


def test_lztb_v1_frozen(codec):
    _check("v1", codec.encode_blocks(_fixture(), PARAMS, block_size=BS))


def test_lztb_v2_frozen(codec):
    _check("v2", codec.encode_blocks(_fixture(), PARAMS, block_size=BS,
                                     preset_len=1 << 14))


def test_lztb_v3_and_trainer_frozen(codec):
    data = _fixture()
    d = train_dictionary(data, 4096)
    _check("dict", d)
    _check("v3", codec.encode_blocks(data, PARAMS, block_size=BS,
                                     dictionary=d))
