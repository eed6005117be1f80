"""LzmaAlone-compatible command line.

Same surface as the reference CLI (LzmaAlone.java:42-154): `e`/`d`/`b`
commands, `-d{N} -fb{N} -a{N} -lc{N} -lp{N} -pb{N} -eos -mf{bt2,bt4}`
switches, `--` to end switch parsing, same defaults (dict 2^23, fb 128,
lc3 lp0 pb2, bt4, max mode).  Extensions: `-mfhc4`/`-mffast4`,
`-backend{scalar,native,device,hybrid}`, `-bs{N}` block size + `-t{N}`
threads for the block-parallel LZTB container, `-ps{N}` shared preset
(LZTB v2), `-td{N}`/`-tdauto` trained dictionary (LZTB v3), `-tune`
measured lc/lp/pb selection, `-q` quiet.
"""

from __future__ import annotations

import sys

from .format.properties import LzmaParams
from .codec.encoder import encode_alone
from .codec.decoder import decode_alone

BANNER = "\nLZMA (JAX) 0.1  — capability parity with LZMA (Java) 4.61\n"

HELP = """
Usage:  lzma_tpu <e|d|b> [<switches>...] inputFile outputFile
  e: encode file
  d: decode file
  b: Benchmark
<Switches>
  -d{N}:  set dictionary - [0,28], default: 23 (8MB)
  -fb{N}: set number of fast bytes - [5, 273], default: 128
  -lc{N}: set number of literal context bits - [0, 8], default: 3
  -lp{N}: set number of literal pos bits - [0, 4], default: 0
  -pb{N}: set number of pos bits - [0, 4], default: 2
  -mf{MF_ID}: set Match Finder: [bt2, bt4, hc4, fast4], default: bt4
  -eos:   write End Of Stream marker
  -backend{B}: scalar | native | device | hybrid (default: native if
          built,
          else scalar; hybrid = device match search + native serialize,
          encode with -bs{N}, decodes via native; -a2 [default] runs the
          hybrid-OPTIMAL pipeline — device candidate lists + host optimal
          parse; -a0/-a1 the greedy/lazy device tokenizer)
  -bs{N}: block size (bytes) -> block-parallel LZTB container
  -ps{N}: shared preset-dictionary bytes for block-parallel mode (LZTB v2)
  -td{N}: train an N-byte dictionary from the input and store it in the
          container, priming every block (LZTB v3); -tdauto auto-sizes
          the dictionary against its storage cost
  -tune:  pick lc/lp/pb by measured cost on the input's first batch
  -t{N}:  worker threads for block-parallel mode
"""


class CommandLine:
    """Switch parser with the reference's exact grammar (LzmaAlone.java:42-134)."""

    def __init__(self):
        self.command = None
        self.num_passes = 10
        self.dict_size = 1 << 23
        self.dict_defined = False
        self.lc, self.lp, self.pb = 3, 0, 2
        self.fb = 128
        self.eos = False
        self.algorithm = 2
        self.match_finder = "bt4"
        self.backend = None
        self.block_size = 0
        self.preset_len = 0
        self.train_dict = 0
        self.tune = False
        self.threads = 0
        self.quiet = False
        self.in_file = None
        self.out_file = None

    def parse_switch(self, s: str) -> bool:
        try:
            if s.startswith("backend"):
                self.backend = s[7:]
                return self.backend in ("scalar", "native", "device", "hybrid")
            if s.startswith("bs"):
                self.block_size = int(s[2:])
            elif s.startswith("d"):
                self.dict_size = 1 << int(s[1:])
                self.dict_defined = True
            elif s.startswith("fb"):
                self.fb = int(s[2:])
            elif s.startswith("a"):
                self.algorithm = int(s[1:])
            elif s.startswith("lc"):
                self.lc = int(s[2:])
            elif s.startswith("lp"):
                self.lp = int(s[2:])
            elif s.startswith("pb"):
                self.pb = int(s[2:])
            elif s.startswith("ps"):
                self.preset_len = int(s[2:])
            elif s.startswith("eos"):
                self.eos = True
            elif s.startswith("mf"):
                mf = s[2:]
                if mf == "bt4b":  # accepted alias, treated as bt4 (LzmaAlone.java:65-66)
                    mf = "bt4"
                if mf not in ("bt2", "bt4", "hc4", "fast4"):
                    return False
                self.match_finder = mf
            elif s == "tune":
                self.tune = True
            elif s.startswith("td"):
                if s[2:] == "auto":
                    self.train_dict = "auto"
                else:
                    self.train_dict = int(s[2:])
                    if self.train_dict < 1:
                        return False
            elif s.startswith("t"):
                self.threads = int(s[1:])
            elif s.startswith("q"):
                self.quiet = True
            else:
                return False
            return True
        except ValueError:
            return False

    def parse(self, args) -> bool:
        pos = 0
        switch_mode = True
        for s in args:
            if not s:
                return False
            if switch_mode:
                if s == "--":
                    switch_mode = False
                    continue
                if s[0] == "-":
                    if not s[1:] or not self.parse_switch(s[1:].lower()):
                        return False
                    continue
            if pos == 0:
                cmd = s.lower()
                if cmd not in ("e", "d", "b"):
                    return False
                self.command = cmd
            elif pos == 1:
                if self.command == "b":
                    try:
                        self.num_passes = int(s)
                    except ValueError:
                        return False
                    if self.num_passes < 1:
                        return False
                else:
                    self.in_file = s
            elif pos == 2:
                self.out_file = s
            else:
                return False
            pos += 1
        return True

    def mode(self) -> str:
        """Parse mode from the reference's -a{N} switch (0=fast; our
        fast profile is greedy/lazy, SetAlgorithm is a stub upstream,
        Encoder.java:1127-1133)."""
        return {0: "greedy", 1: "lazy"}.get(self.algorithm, "optimal")

    def params(self) -> LzmaParams:
        return LzmaParams(
            lc=self.lc,
            lp=self.lp,
            pb=self.pb,
            dict_size=self.dict_size,
            fast_bytes=self.fb,
            match_finder=self.match_finder,
            write_eos=self.eos,
        )


def _pick_backend(name):
    """Resolve encode/decode callables for the chosen backend."""
    if name in (None, "native"):
        try:
            from .runtime import native

            if native.available():
                return native.encode_alone, native.decode_alone, "native"
        except Exception:
            if name == "native":
                raise
    if name == "device":
        from .ops import api as device_api

        return (
            lambda data, params, mode=None: device_api.encode_alone(data,
                                                                    params),
            device_api.decode_alone,
            "device",
        )
    return (
        lambda data, params, mode=None: encode_alone(data, params, mode=mode),
        lambda data: decode_alone(data),
        "scalar",
    )


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    print(BANNER)
    if not args:
        print(HELP)
        return 0
    cmd = CommandLine()
    if not cmd.parse(args):
        print("\nIncorrect command")
        return 1
    if cmd.backend in ("device", "hybrid"):
        from .utils.compile_cache import enable_compile_cache

        enable_compile_cache()
    try:
        return _dispatch(cmd)
    except (OSError, ValueError, RuntimeError) as e:
        # umbrella for paths without a dedicated handler (-tune
        # validation, bench validation, NativeUnavailable from explicit
        # backends): the CLI contract is "error: ..." + exit 1, never a
        # traceback
        print(f"error: {e}")
        return 1


def _dispatch(cmd: "CommandLine") -> int:
    if cmd.backend == "native":
        # explicit request: never silently substitute the scalar codec
        from .runtime import native as _native

        if not _native.available():
            print("error: -backendnative requested but the native runtime "
                  "is unavailable (python -m lzma_tpu.runtime.build)")
            return 1

    if cmd.command == "b":
        from .bench.harness import run_benchmark

        dict_size = cmd.dict_size if cmd.dict_defined else (1 << 21)
        # rate the selected backend (default: native when built, like e/d)
        enc_fn = dec_fn = None
        bench_params = LzmaParams(dict_size=dict_size)
        if cmd.backend in (None, "native"):
            from .runtime import native as _native

            if _native.available():
                def enc_fn(d):
                    return _native.encode_stream(d, bench_params)

                def dec_fn(comp, out_size):
                    return _native.decode_stream(comp, bench_params, out_size)
            elif cmd.backend == "native":
                # explicit request must not silently rate the scalar codec
                _native._lib()  # raises NativeUnavailable with the cause
        elif cmd.backend == "device":
            from .ops import api as _device

            def enc_fn(d):
                return _device.encode_stream(d, bench_params)

            def dec_fn(comp, out_size):
                return _device.decode_stream(comp, bench_params, out_size)

        elif cmd.backend == "hybrid":
            # hybrid-optimal: device candidate search + host optimal
            # parse for the encode half; decode rates the native coder
            from .ops.hybrid import encode_stream_hybrid_optimal
            from .runtime import native as _native

            _native._lib()  # hybrid serializes host-side; fail loud

            def enc_fn(d):
                return encode_stream_hybrid_optimal(d, bench_params)

            def dec_fn(comp, out_size):
                return _native.decode_stream(comp, bench_params, out_size)

        elif cmd.backend != "scalar":
            print(f"error: unsupported backend for b: {cmd.backend}")
            return 1

        run_benchmark(cmd.num_passes, dict_size, params=bench_params,
                      encode_fn=enc_fn, decode_fn=dec_fn)
        return 0

    if not cmd.in_file or not cmd.out_file:
        print(HELP)
        return 1

    import os

    if cmd.command == "e" and cmd.train_dict and not cmd.block_size:
        print("error: -td requires the block container (-bs{N})")
        return 1

    if cmd.command == "e" and cmd.tune and cmd.in_file:
        # measured lc/lp/pb selection on the input's first batch; every
        # encode path below reads the tuned values via cmd.params()
        from .parallel.filestream import DEFAULT_BATCH_BYTES
        from .utils.autotune import select_params

        try:
            with open(cmd.in_file, "rb") as f:
                sample = f.read(DEFAULT_BATCH_BYTES)
        except OSError as e:
            print(f"error: {e}")
            return 1
        tuned = select_params(sample, cmd.params(),
                              block_size=cmd.block_size or (1 << 20))
        cmd.lc, cmd.lp, cmd.pb = tuned.lc, tuned.lp, tuned.pb
        if not cmd.quiet:
            print(f"tuned: -lc{tuned.lc} -lp{tuned.lp} -pb{tuned.pb}")

    def _trained_dict(loaded: bytes | None = None) -> bytes:
        """Train from `loaded` when the caller already read the input."""
        if not cmd.train_dict:
            return b""
        from .parallel.filestream import DEFAULT_BATCH_BYTES
        from .utils.dicttrain import select_dictionary, train_dictionary

        if loaded is not None:
            sample = loaded[:DEFAULT_BATCH_BYTES]
        else:
            with open(cmd.in_file, "rb") as f:
                sample = f.read(DEFAULT_BATCH_BYTES)
        if cmd.train_dict == "auto":
            return select_dictionary(sample, cmd.params(),
                                     block_size=cmd.block_size)
        return train_dictionary(sample, cmd.train_dict)

    # Block-parallel file paths stream with O(batch) memory
    # (parallel/filestream.py); .lzma single streams are in-memory.
    try:
        if cmd.command == "e" and cmd.backend == "hybrid":
            if not cmd.block_size:
                print("error: -backendhybrid encodes the block container; "
                      "pass -bs{N}")
                return 1
            params = cmd.params().validated_for_encode()
            with open(cmd.in_file, "rb") as f:
                data = f.read()
            if cmd.algorithm >= 2:
                # device multi-tier candidate lists + host optimal parse (ratio ~ native bt4-opt at a fraction
                # of the host cost)
                from .ops.hybrid import encode_blocks_hybrid_optimal

                out = encode_blocks_hybrid_optimal(
                    data, params, block_size=cmd.block_size,
                    num_threads=cmd.threads, preset_len=cmd.preset_len,
                    dictionary=_trained_dict(data),
                )
                tag = "hybrid-optimal"
            else:
                from .ops.hybrid import encode_blocks_hybrid

                out = encode_blocks_hybrid(
                    data, params, block_size=cmd.block_size,
                    num_threads=cmd.threads, preset_len=cmd.preset_len,
                    dictionary=_trained_dict(data),
                )
                tag = "hybrid"
            with open(cmd.out_file, "wb") as f:
                f.write(out)
            if not cmd.quiet:
                print(f"e: {len(data)} -> {len(out)} bytes [{tag}]")
            return 0
        if cmd.command == "d" and cmd.backend == "hybrid":
            cmd.backend = None  # hybrid is an encode pipeline; decode native
        if cmd.command == "e" and cmd.block_size and cmd.backend in (None, "native"):
            from .parallel import filestream

            params = cmd.params().validated_for_encode()
            in_size = os.path.getsize(cmd.in_file)
            out_size = filestream.encode_file(
                cmd.in_file, cmd.out_file, params,
                block_size=cmd.block_size, num_threads=cmd.threads, mode=cmd.mode(),
                preset_len=cmd.preset_len, dictionary=_trained_dict(),
            )
            if not cmd.quiet:
                print(f"e: {in_size} -> {out_size} bytes [stream]")
            return 0
        if cmd.command == "e" and not cmd.block_size \
                and cmd.backend in (None, "native"):
            # single .lzma stream: O(dict)-memory sliding-window encode
            # (byte-identical to the in-memory path)
            from .runtime.native import NativeUnavailable

            try:
                from .parallel import filestream

                params = cmd.params().validated_for_encode()
                in_size = os.path.getsize(cmd.in_file)
                out_size = filestream.encode_file_alone(
                    cmd.in_file, cmd.out_file, params, mode=cmd.mode()
                )
                if not cmd.quiet:
                    print(f"e: {in_size} -> {out_size} bytes [stream]")
                return 0
            except NativeUnavailable:
                pass  # scalar in-memory fallback below
        if cmd.command == "d" and cmd.backend in (None, "native"):
            with open(cmd.in_file, "rb") as f:
                magic = f.read(4)
            if magic == b"LZTB":
                from .parallel import filestream

                in_size = os.path.getsize(cmd.in_file)
                out_size = filestream.decode_file(
                    cmd.in_file, cmd.out_file, num_threads=cmd.threads
                )
                if not cmd.quiet:
                    print(f"d: {in_size} -> {out_size} bytes [stream]")
                return 0
            # single .lzma stream: O(dict)-memory circular-window decode
            from .core.rangecoder import CorruptStreamError
            from .runtime.native import NativeUnavailable

            try:
                from .parallel import filestream

                in_size = os.path.getsize(cmd.in_file)
                out_size = filestream.decode_file_alone(
                    cmd.in_file, cmd.out_file
                )
                if not cmd.quiet:
                    print(f"d: {in_size} -> {out_size} bytes [stream]")
                return 0
            except NativeUnavailable:
                pass
            except CorruptStreamError as e:
                print(f"error: {e}")
                return 1
    except OSError as e:
        print(f"error: {e.strerror}: {e.filename}")
        return 1
    except ValueError as e:
        print(f"error: {e}")
        return 1

    try:
        with open(cmd.in_file, "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"error: cannot read {cmd.in_file}: {e.strerror}")
        return 1

    from .core.rangecoder import CorruptStreamError

    try:
        enc, dec, backend = _pick_backend(cmd.backend)
        if cmd.command == "e":
            params = cmd.params().validated_for_encode()
            if cmd.block_size:
                if backend == "device":
                    from .ops import api as device_api

                    out = device_api.encode_blocks(
                        data, params, block_size=cmd.block_size,
                        preset_len=cmd.preset_len,
                        dictionary=_trained_dict(data),
                    )
                else:
                    from .parallel.blocks import encode_blocks

                    out = encode_blocks(
                        data, params, block_size=cmd.block_size,
                        num_threads=max(cmd.threads, 1),
                        preset_len=cmd.preset_len,
                        dictionary=_trained_dict(data),
                    )
            else:
                out = enc(data, params, mode=cmd.mode())
        else:
            if data[:4] == b"LZTB":
                if backend == "device":
                    from .ops import api as device_api

                    out = device_api.decode_blocks(data)
                else:
                    from .parallel.blocks import decode_blocks

                    out = decode_blocks(data, num_threads=max(cmd.threads, 1))
            else:
                out = dec(data)
    except (ValueError, CorruptStreamError) as e:
        print(f"error: {e}")
        return 1
    try:
        with open(cmd.out_file, "wb") as f:
            f.write(out)
    except OSError as e:
        print(f"error: cannot write {cmd.out_file}: {e.strerror}")
        return 1
    if not cmd.quiet:
        print(f"{cmd.command}: {len(data)} -> {len(out)} bytes [{backend}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
