"""The device codec's serial steps for this backend, chosen in one place.

Three steps of the device path are serial per lane: the optimal-parse
DP scan, the range coder and the decode FSM.  On a GPU each runs as one
Pallas-Triton kernel; elsewhere the plain XLA forms run.  Both give
identical tokens and bytes.  The choice follows the platform, never a
user flag.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax


class Kernels(NamedTuple):
    #: (data, lens, ld, dd, model, fb, pb, full_len_only, r0pos=, replen=)
    #: -> (from, choice), as device_parser.dp_parse_band
    dp_scan: Callable
    #: (ctx, bits, totals, arena_size, max_out) -> (out, out_lens), as
    #: device_encoder.serialize_xla
    serialize: Callable
    #: (comp, comp_lens, out_sizes, dict_size, lc, lp, pb, max_out,
    #: max_iters=0, preset=None) -> (out, ok, iters, out_pos), as
    #: device_decoder.decode_fsm_xla
    decode_fsm: Callable


def for_platform() -> Kernels:
    """The Triton kernels on a GPU, the XLA forms elsewhere."""
    if jax.default_backend() == "gpu":
        from .device_parser import dp_parse_triton
        from .triton_decoder import decode_fsm_triton
        from .triton_serializer import serialize_triton

        return Kernels(dp_parse_triton, serialize_triton, decode_fsm_triton)
    from .device_decoder import decode_fsm_xla
    from .device_encoder import serialize_xla
    from .device_parser import dp_parse_band

    return Kernels(dp_parse_band, serialize_xla, decode_fsm_xla)
