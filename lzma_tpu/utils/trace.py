"""Structured per-symbol trace logging + progress API.

Capability parity with the reference's observability hooks:
- per-symbol encoder decision traces at FINE level (Encoder.java:871-1018,
  BinTree.java:139-150) -> `CodecTrace` on the stdlib logging module,
  guarded so the hot path pays one attribute check when disabled;
- `ICodeProgress.SetProgress(inSize, outSize)` (ICodeProgress.java:3-5)
  -> plain callables `progress(in_size, out_size)` accepted by every
  encode entry point, fired on the reference's >=4096-byte cadence
  (Encoder.java:929-933);
- the test LogFormatter (LogFormatter.java:9-37) -> `trace_formatter()`.

The device path's analogue is coarser by design (device loops can't log per
symbol): per-block phase timings via `jax.profiler` traces — see
utils/profiling.py.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("lzma_tpu.codec")


class CodecTrace:
    """Per-symbol trace sink; enabled iff the logger accepts DEBUG."""

    def __init__(self, log: logging.Logger | None = None):
        self.log = log or logger
        self.enabled = self.log.isEnabledFor(logging.DEBUG)

    def symbol(self, pos: int, decision) -> None:
        if self.enabled:
            if decision.pos == -1:
                kind = "literal"
            elif decision.pos < 4:
                kind = f"rep{decision.pos}" if decision.length > 1 else "short-rep"
            else:
                kind = f"match dist={decision.pos - 4 + 1}"
            self.log.debug("pos=%d %s len=%d", pos, kind, decision.length)

    def matches(self, pos: int, pairs) -> None:
        if self.enabled:
            self.log.debug("pos=%d matches=%s", pos, pairs)

    def first_literal(self, byte: int) -> None:
        if self.enabled:
            self.log.debug("first byte %d as literal", byte)

    def tokens(self, lane: int, t_pos, t_len, t_dist, kinds, rep_idx,
               ntok: int) -> None:
        """Device-path decision dump: the token
        stream IS the decision stream, so each (pos, len, dist) token +
        its classify metadata prints in exactly the per-symbol format of
        `symbol()` — device and scalar traces read identically when the
        parses agree.  kinds/rep_idx come from classify_tokens (the same
        state machine the coder runs)."""
        if not self.enabled:
            return
        self.log.debug("lane=%d tokens=%d", lane, ntok)
        for j in range(ntok):
            d = int(t_dist[j])
            ln = int(t_len[j])
            if d < 0:
                kind = "literal"
            elif int(kinds[j]) == 2:          # K_REP
                k = int(rep_idx[j])
                kind = f"rep{k}" if ln > 1 else "short-rep"
            else:
                kind = f"match dist={d + 1}"
            self.log.debug("pos=%d %s len=%d", int(t_pos[j]), kind, ln)


def trace_formatter() -> logging.Formatter:
    """Compact single-line formatter for codec traces."""
    return logging.Formatter("%(relativeCreated)6dms %(name)s: %(message)s")


def enable_trace(stream=None) -> logging.Handler:
    """Convenience: route codec traces to a stream at DEBUG level."""
    h = logging.StreamHandler(stream)
    h.setFormatter(trace_formatter())
    logger.addHandler(h)
    logger.setLevel(logging.DEBUG)
    return h


class RateLimitedProgress:
    """Wraps a progress callable, reporting at most every `interval` input
    bytes (the reference reports per >=4096-byte block)."""

    def __init__(self, fn, interval: int = 1 << 12):
        self.fn = fn
        self.interval = interval
        self._last = 0

    def __call__(self, in_size: int, out_size: int) -> None:
        if in_size - self._last >= self.interval:
            self._last = in_size
            self.fn(in_size, out_size)
