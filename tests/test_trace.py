"""Tracing / progress / profiling observability hooks."""

import io
import logging

from lzma_tpu.codec.encoder import LzmaEncoder
from lzma_tpu.codec.decoder import decode_stream
from lzma_tpu.format.properties import LzmaParams
from lzma_tpu.utils.trace import CodecTrace, RateLimitedProgress, trace_formatter
from lzma_tpu.utils.profiling import PhaseTimer


def test_encoder_symbol_trace():
    log = logging.getLogger("test.codec.trace")
    log.setLevel(logging.DEBUG)
    stream = io.StringIO()
    h = logging.StreamHandler(stream)
    h.setFormatter(trace_formatter())
    log.addHandler(h)
    try:
        p = LzmaParams(dict_size=1 << 12, fast_bytes=8)
        data = b"abcabcabcabc123123123"
        enc = LzmaEncoder(p, trace=CodecTrace(log))
        comp = enc.encode(data)
        assert decode_stream(comp, p, out_size=len(data)) == data
    finally:
        log.removeHandler(h)
    text = stream.getvalue()
    assert "literal" in text
    assert "match" in text or "rep" in text
    assert "matches=" in text


def test_trace_disabled_is_free():
    p = LzmaParams(dict_size=1 << 12, fast_bytes=8)
    data = b"no trace overhead " * 20
    quiet = logging.getLogger("test.codec.quiet")
    quiet.setLevel(logging.WARNING)
    a = LzmaEncoder(p).encode(data)
    b = LzmaEncoder(p, trace=CodecTrace(quiet)).encode(data)
    assert a == b


def test_progress_callback_cadence():
    calls = []
    p = LzmaParams(dict_size=1 << 14, fast_bytes=16)
    data = (b"progress reporting block " * 2000)[:40_000]
    LzmaEncoder(p).encode(data, progress=lambda i, o: calls.append((i, o)))
    assert calls, "progress should fire on >=4096-byte cadence"
    ins = [c[0] for c in calls]
    assert ins == sorted(ins)
    assert all(o > 0 for _, o in calls)


def test_rate_limited_progress():
    seen = []
    rp = RateLimitedProgress(lambda i, o: seen.append(i), interval=100)
    for i in range(0, 1000, 10):
        rp(i, i // 2)
    assert len(seen) <= 10


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    assert set(t.totals) == {"a", "b"}
    assert "a" in t.report()


def test_enable_trace_attaches_handler():
    import logging

    from lzma_tpu.utils.trace import enable_trace, logger

    h = enable_trace(io.StringIO())
    try:
        assert h in logger.handlers
        assert logger.isEnabledFor(logging.DEBUG)
    finally:
        logger.removeHandler(h)


def _capture(fn):
    log = logging.getLogger(f"test.codec.trace.{id(fn)}")
    log.setLevel(logging.DEBUG)
    stream = io.StringIO()
    h = logging.StreamHandler(stream)
    h.setFormatter(logging.Formatter("%(message)s"))
    log.addHandler(h)
    try:
        fn(CodecTrace(log))
    finally:
        log.removeHandler(h)
    # symbol lines only (the scalar trace interleaves the finder's
    # per-position match-list dumps, BinTree.java:139-150 analogue)
    return [ln for ln in stream.getvalue().splitlines()
            if ln.startswith("pos=") and "matches=" not in ln]


def test_device_trace_matches_scalar_trace():
    """the device token dump prints the scalar
    per-symbol format.  On an input whose parse is unambiguous (unique
    bytes -> all literals; then one exact long repeat) both backends
    make identical decisions, so the traces must be LINE-IDENTICAL."""
    from lzma_tpu.ops.device_encoder import encode_batch

    p = LzmaParams(dict_size=1 << 12, fast_bytes=32)
    data = bytes(range(200))  # strictly unique bytes: every parse is
    # 200 literals, so scalar and device decisions MUST coincide

    scalar_lines = _capture(
        lambda t: LzmaEncoder(p, trace=t).encode(data))
    device_lines = _capture(
        lambda t: encode_batch([data], p, trace=t))
    assert scalar_lines, "scalar trace produced no symbols"
    # the scalar encoder reports the FORCED first literal through its own
    # hook (first_literal — Encoder.java:860-878's special case); the
    # device stream has no such special case, so align by prepending it
    scalar_lines = ["pos=0 literal len=1"] + scalar_lines
    assert scalar_lines == device_lines

    # match formatting parity: a repeat prints the scalar `symbol` shape
    rep = data + data
    dev2 = _capture(lambda t: encode_batch([rep], p, trace=t))
    assert any("match dist=200 len=200" in ln for ln in dev2)


def test_device_trace_optimal_parse_mode():
    """The dump also rides the DP tokenizer (parse=optimal)."""
    from lzma_tpu.ops.device_encoder import encode_batch

    p = LzmaParams(dict_size=1 << 12, fast_bytes=32)
    data = (b"abcdefgh" * 40 + bytes(range(100)))[:400]
    lines = _capture(
        lambda t: encode_batch([data], p, parse="optimal", trace=t))
    assert lines and all(ln.startswith("pos=") for ln in lines)
    # decisions cover the block exactly
    covered = 0
    for ln in lines:
        covered += int(ln.rsplit("len=", 1)[1])
    assert covered == len(data)


def test_device_trace_dumps_match_lists():
    """Round 5: the device trace also dumps the
    finder's per-position candidate lists in the scalar `matches=` line
    format (BinTree.java:139-150 analogue) — ascending (len, dist)
    pairs at every decision position, from the same engine the parse
    consumed."""
    import re

    from lzma_tpu.ops.device_encoder import encode_batch

    p = LzmaParams(dict_size=1 << 12, fast_bytes=32)
    data = bytes(range(200)) + bytes(range(200))  # literals + one repeat

    log = logging.getLogger("test.codec.trace.matchdump")
    log.setLevel(logging.DEBUG)
    stream = io.StringIO()
    h = logging.StreamHandler(stream)
    h.setFormatter(logging.Formatter("%(message)s"))
    log.addHandler(h)
    try:
        encode_batch([data], p, trace=CodecTrace(log), parse="optimal")
    finally:
        log.removeHandler(h)
    lines = stream.getvalue().splitlines()
    mlines = [ln for ln in lines if "matches=" in ln]
    assert mlines, "device trace emitted no match-list lines"
    pat = re.compile(r"^pos=(\d+) matches=\[(.*)\]$")
    seen_pair = False
    for ln in mlines:
        m = pat.match(ln)
        assert m, ln
        body = m.group(2)
        if body:
            pairs = eval(f"[{body}]")
            lens_ = [a for a, _ in pairs]
            assert lens_ == sorted(lens_), ln  # ascending lengths
            seen_pair = True
    assert seen_pair, "no non-empty candidate list was dumped"
    # the repeat must surface at distance 199, length capped at fb=32
    # (list lengths cap at fb — the fillMatches contract; the parser's
    # past-fb extension happens downstream, like the reference's
    # read_match_distances)
    assert any("(32, 199)" in ln for ln in mlines)
