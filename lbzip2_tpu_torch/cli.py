"""lbzip2-compatible command-line front end.

Reproduces the reference CLI surface (src/main.c): invocation-name
personalities, LBZIP2/BZIP2/BZIP environment variables, the clustered
short-option FSM with -n/-m option arguments and K/M/G/... suffixes,
long options (including historical no-ops), file-management rules
(suffix table, skip rules, O_EXCL output with metadata restore, unlink
of inputs), terminal-safety refusals, copy passthrough under -cdf,
signal-safe partial-output cleanup, and exit codes 0/1/4.

Counterpart of lbzip2_tpu/cli.py with the port's engines behind it.
Engine selection (``LBZIP2_TPU_ENGINE``): ``auto`` streams through
``CompressScheduler`` / ``decompress_stream`` (the latter takes the
port's device stages when ``LBZ2_DEVICE_HUFF`` / ``LBZ2_DEVICE_DECODE``
are on), ``device`` runs ``codec.encoder.compress`` and
``decompress_parallel``, ``oracle`` the sequential reference codec.
The device engines run on ``DEVICE``.

    python -m lbzip2_tpu_torch [options] [FILE ...]   # lbzip2
"""

from __future__ import annotations

import os
import signal
import stat
import sys

from lbzip2_tpu_torch import __version__
from lbzip2_tpu_torch.core.constants import StreamError

DEVICE = "cuda"  # the device of the port's engines (tests use "cpu")

EX_OK = 0
EX_FAIL = 1
EX_WARN = 4

ENV_VARS = ("LBZIP2", "BZIP2", "BZIP")

# (compressed suffix, decompressed suffix, participates in "is it
# already compressed" checks) — src/main.c:643-651.
SUFFIXES = [
    (".bz2", "", True),
    (".tbz2", ".tar", True),
    (".tbz", ".tar", True),
    (".tz2", ".tar", True),
    ("", ".out", False),
]

OM_STDOUT, OM_DISCARD, OM_REGF = "stdout", "discard", "regf"

USAGE = """\
Usage:
1. PROG [-n WTHRS] [-k|-c|-t] [-d|-z] [-1 .. -9] [-f] [-u] [-v] [-S] \
[FILE ...]
2. PROG -h|-V

PROG is one of lbzip2, lbunzip2, lbzcat (or their l-less aliases).

Options:
  -n WTHRS           : Set the number of (P)VM worker threads.
  -k, --keep         : Don't remove FILE operands after processing.
  -c, --stdout       : Write output to standard output.
  -t, --test         : Test decompression; discard output.
  -d, --decompress   : Force decompression.
  -z, --compress     : Force compression.
  -1 .. -9           : Set block size to 100K .. 900K (--fast/--best).
  -f, --force        : Open non-regular files; overwrite; read/write tty.
  -u, --sequential   : Perform splitting input blocks sequentially.
  -v, --verbose      : Log each file's progress and compression ratio.
  -S                 : Print condition variable statistics (no-op).
  -s, --small, -q, --quiet, --repetitive-fast, --repetitive-best,
  --exponential      : Accepted for compatibility; ignored.
  -m MEM             : Cap worker count to fit the memory bound.
  -h, --help         : Print this help and exit.
  -L, -V, --license, --version : Print version info and exit.

Environment variables LBZIP2, BZIP2 and BZIP are inserted (in this
order) before command-line arguments, split on whitespace, no escaping.
"""


class Options:
    def __init__(self):
        self.decompress = False
        self.bs100k = 9
        self.force = False
        self.keep = False
        self.verbose = False
        self.small = False
        self.ultra = False
        self.print_cctrs = False
        self.outmode = OM_REGF
        self.num_worker = 0
        self.max_mem = 0
        self.operands: list[str] = []


class Fail(Exception):
    pass


class _Ctx:
    def __init__(self, pname: str):
        self.pname = pname
        self.warned = False
        self.opathn: str | None = None  # partial output to unlink on abort


def _fail(ctx: _Ctx, msg: str):
    raise Fail(f"{ctx.pname}: {msg}")


def _warn(ctx: _Ctx, msg: str):
    sys.stderr.write(f"{ctx.pname}: {msg}\n")
    ctx.warned = True


def _info(ctx: _Ctx, msg: str):
    sys.stderr.write(f"{ctx.pname}: {msg}\n")


def _xstrtol(ctx: _Ctx, s: str, opt: str, lower: int, upper: int) -> int:
    """Integer with single-letter binary suffix (src/main.c:158-193)."""
    suffixes = "EePpTtGgMmKk"
    body, mult = s, 0
    if s and s[-1] in suffixes:
        body = s[:-1]
        idx = suffixes.index(s[-1])
        mult = (len(suffixes) - idx + 1) // 2 * 10
    try:
        val = int(body, 10)
        if val < 0:
            raise ValueError
    except ValueError:
        val = None
    if val is not None:
        val <<= mult
    if val is None or not (lower <= val <= upper):
        _fail(ctx, f'failed to parse "{s}" from "-{opt}" as an integer in '
                   f'[{lower}..{upper}], specify "-h" for help')
    return val


def parse_args(ctx: _Ctx, argv: list[str], environ=os.environ) -> Options:
    opts = Options()

    pname = ctx.pname
    if pname in ("bunzip2", "lbunzip2"):
        opts.decompress = True
    elif pname in ("bzcat", "lbzcat"):
        opts.decompress = True
        opts.outmode = OM_STDOUT

    args: list[str] = []
    for ev in ENV_VARS:
        val = environ.get(ev)
        if val:
            args.extend(val.split())
    args.extend(argv)

    def set_outmode(ch):
        if opts.outmode == (OM_DISCARD if ch == "c" else OM_STDOUT):
            _fail(ctx, '"-c" and "-t" are incompatible, specify "-h" for help')
        if ch == "c":
            opts.outmode = OM_STDOUT
        else:
            opts.outmode = OM_DISCARD
            opts.decompress = True

    def set_decompress(ch):
        opts.decompress = ch == "d"
        if opts.outmode == OM_DISCARD:
            opts.outmode = OM_REGF

    LONG_NOOPS = {"quiet", "repetitive-fast", "repetitive-best",
                  "exponential"}
    i = 0
    stopped = False
    while i < len(args):
        a = args[i]
        i += 1
        if stopped or not a.startswith("-") or a == "-":
            opts.operands.append(a)
            continue
        if a.startswith("--"):
            name = a[2:]
            if name == "":
                stopped = True
            elif name == "stdout":
                set_outmode("c")
            elif name == "test":
                set_outmode("t")
            elif name == "decompress":
                set_decompress("d")
            elif name == "compress":
                set_decompress("z")
            elif name == "fast":
                opts.bs100k = 1
            elif name == "best":
                opts.bs100k = 9
            elif name == "force":
                opts.force = True
            elif name == "keep":
                opts.keep = True
            elif name == "small":
                opts.small = True
            elif name == "sequential":
                opts.ultra = True
            elif name == "verbose":
                opts.verbose = True
            elif name == "help":
                sys.stdout.write(USAGE.replace("PROG", pname))
                raise SystemExit(EX_OK)
            elif name in ("license", "version"):
                sys.stdout.write(
                    f"{pname} version {__version__} (lbzip2_tpu_torch)\n")
                raise SystemExit(EX_OK)
            elif name not in LONG_NOOPS:
                _fail(ctx, f'unknown option "{a}", specify "-h" for help')
            continue
        # cluster of short options
        j = 1
        while j < len(a):
            c = a[j]
            if c in "ct":
                set_outmode(c)
            elif c in "dz":
                set_decompress(c)
            elif c in "123456789":
                opts.bs100k = int(c)
            elif c == "f":
                opts.force = True
            elif c == "k":
                opts.keep = True
            elif c == "s":
                opts.small = True
            elif c == "u":
                opts.ultra = True
            elif c == "v":
                opts.verbose = True
            elif c == "S":
                opts.print_cctrs = True
            elif c == "q":
                pass
            elif c == "h":
                sys.stdout.write(USAGE.replace("PROG", pname))
                raise SystemExit(EX_OK)
            elif c in "LV":
                sys.stdout.write(
                    f"{pname} version {__version__} (lbzip2_tpu_torch)\n")
                raise SystemExit(EX_OK)
            elif c in "nm":
                val = a[j + 1:]
                if not val:
                    if i >= len(args):
                        _fail(ctx, f'option "-{c}" requires an argument, '
                                   'specify "-h" for help')
                    val = args[i]
                    i += 1
                if c == "n":
                    opts.num_worker = _xstrtol(ctx, val, c, 1, 2 ** 16)
                else:
                    opts.max_mem = _xstrtol(ctx, val, c, 1, 2 ** 63)
                break
            else:
                _fail(ctx, f'unknown option "-{c}", specify "-h" for help')
            j += 1

    # Finalize (src/main.c:594-626).
    if opts.outmode == OM_REGF and not opts.operands:
        opts.outmode = OM_STDOUT

    if opts.decompress:
        if not opts.operands and sys.stdin.isatty():
            _fail(ctx, "won't read compressed data from a terminal, "
                       'specify "-h" for help')
    else:
        if opts.outmode == OM_STDOUT and sys.stdout.isatty():
            _fail(ctx, "won't write compressed data to a terminal, "
                       'specify "-h" for help')

    if opts.num_worker == 0:
        opts.num_worker = os.cpu_count() or 1

    # Enforce -m by capping the worker count to the reference memory
    # model (src/process.c:624-646 leaves this as a TODO; we apply it):
    #   compress  ~ W * (2*bs in-slots + out slots + encoder arena
    #               ~13*bs + suffix-sort scratch ~16*bs) ~= W * 31*bs
    #   expand    ~ W * (4*256 KiB in + 16*900000 out + tt 3.6 MB)
    if opts.max_mem:
        bs = opts.bs100k * 100000
        per_w = (31 * bs) if not opts.decompress else \
            (4 * 262144 + 16 * 900000 + 3600000)
        cap = max(1, int(opts.max_mem // per_w))
        if cap < opts.num_worker:
            if opts.verbose:
                _warn(ctx, f"capping workers {opts.num_worker} -> {cap} "
                           f"to honor -m {opts.max_mem}")
            opts.num_worker = cap

    # --small is parsed but force-disabled, as in the reference
    # (src/main.c:920-923).
    opts.small = False
    return opts


def _suffix_xform(path: str, for_output: bool) -> str | None:
    """Compressed-suffix check / decompressed-name construction."""
    for compr, decompr, chk in SUFFIXES:
        if (chk or for_output) and path.endswith(compr):
            if for_output:
                return path[:len(path) - len(compr)] + decompr
            return path
    return None


def _engine_compress(data: bytes, opts: Options) -> bytes:
    engine = os.environ.get("LBZIP2_TPU_ENGINE", "auto")
    if engine == "device":
        from lbzip2_tpu_torch.codec.encoder import compress as dev_compress
        return dev_compress(data, opts.bs100k,
                            sequential_split=opts.ultra, device=DEVICE)
    if engine == "oracle":
        from lbzip2_tpu_torch.ref.encoder import compress as ref_compress
        return ref_compress(data, opts.bs100k,
                            sequential_split=opts.ultra)
    from lbzip2_tpu_torch.parallel.encode import compress_parallel
    return compress_parallel(data, opts.bs100k,
                             n_workers=opts.num_worker,
                             sequential_split=opts.ultra)


def _engine_decompress(data: bytes, opts: Options) -> bytes:
    engine = os.environ.get("LBZIP2_TPU_ENGINE", "auto")
    if engine == "oracle":
        from lbzip2_tpu_torch.ref.decoder import decompress as ref_dec
        return ref_dec(data)
    if engine == "device" or (opts.num_worker > 1 and len(data) > 1 << 20):
        from lbzip2_tpu_torch.parallel.decode import decompress_parallel
        return decompress_parallel(data, n_workers=opts.num_worker,
                                   device=DEVICE)
    from lbzip2_tpu_torch.codec.decoder import decompress as prod_dec
    return prod_dec(data)


class _NullWriter:
    def write(self, b):
        return len(b)


def _work(ctx: _Ctx, opts: Options, infd, outfd,
          in_size: int | None = None, in_name: str = "") -> tuple[int, int]:
    """Read input, transform, write output.  Returns (in_len, out_len)."""
    engine = os.environ.get("LBZIP2_TPU_ENGINE", "auto")
    if not opts.decompress and engine == "auto" and not opts.ultra:
        # Streaming bounded-memory path (reference memory policy).
        from lbzip2_tpu_torch.parallel.scheduler import CompressScheduler
        sched = CompressScheduler(
            opts.bs100k, opts.num_worker, outfd or _NullWriter(),
            verbose=opts.verbose, in_size=in_size, progress_name=in_name)
        return sched.run(infd.read)
    if opts.decompress and engine == "auto":
        # Streaming decode (sniff 4-byte header like src/process.c:664).
        from lbzip2_tpu_torch import native as _native
        header = infd.read(4)
        magic_ok = (len(header) == 4 and header[:3] == b"BZh"
                    and 0x31 <= header[3] <= 0x39)
        sink = outfd if outfd is not None else _NullWriter()
        if magic_ok and _native.native_available():
            from lbzip2_tpu_torch.parallel.decode import decompress_stream
            first = [header]

            def read_chunk(n):
                if first:
                    return first.pop() + infd.read(max(0, n - 4))
                return infd.read(n)

            try:
                return decompress_stream(read_chunk, sink.write,
                                         n_workers=opts.num_worker,
                                         verbose=opts.verbose,
                                         in_size=in_size,
                                         progress_name=in_name,
                                         device=DEVICE)
            except StreamError as e:
                from lbzip2_tpu_torch.core.constants import ERROR_MESSAGES
                _fail(ctx, f"{in_name}: compressed data error: "
                           f"{ERROR_MESSAGES.get(e.code, e.code.name)}")
        if not magic_ok:
            if opts.force and outfd is sys.stdout.buffer:
                # copy passthrough (src/process.c:584-608)
                sink.write(header)
                total = len(header)
                while True:
                    chunk = infd.read(1 << 20)
                    if not chunk:
                        break
                    sink.write(chunk)
                    total += len(chunk)
                return total, total
            _fail(ctx, f"{in_name}: not a valid bzip2 file")
        data = header + infd.read()
    else:
        data = infd.read()
    if not opts.decompress:
        out = _engine_compress(data, opts)
    else:
        magic_ok = (len(data) >= 4 and data[:3] == b"BZh"
                    and 0x31 <= data[3] <= 0x39)
        if magic_ok:
            try:
                out = _engine_decompress(data, opts)
            except StreamError as e:
                from lbzip2_tpu_torch.core.constants import ERROR_MESSAGES
                _fail(ctx, f"{in_name}: compressed data error: "
                           f"{ERROR_MESSAGES.get(e.code, e.code.name)}")
        elif opts.force and outfd is sys.stdout.buffer:
            out = data  # copy passthrough (src/process.c:584-608)
        else:
            _fail(ctx, f"{in_name}: not a valid bzip2 file")
    if outfd is not None:
        outfd.write(out)
    return len(data), len(out)


def _process_operand(ctx: _Ctx, opts: Options, operand: str | None) -> None:
    # --- input_init (src/main.c:703-761) ---
    instat = None
    if operand is None:
        infd = sys.stdin.buffer
        in_name = "stdin"
    else:
        if not opts.force:
            try:
                instat = os.lstat(operand)
            except OSError as e:
                _warn(ctx, f'skipping "{operand}": lstat(): {e.strerror}')
                return
            if opts.outmode == OM_REGF and not stat.S_ISREG(instat.st_mode):
                _warn(ctx, f'skipping "{operand}": not a regular file')
                return
            if (opts.outmode == OM_REGF and not opts.keep
                    and instat.st_nlink > 1):
                _warn(ctx, f'skipping "{operand}": more than one links')
                return
        if not opts.decompress and _suffix_xform(operand, False) is not None:
            _warn(ctx, f'skipping "{operand}": compressed suffix')
            return
        try:
            infd = open(operand, "rb")
        except OSError as e:
            _warn(ctx, f'skipping "{operand}": open(): {e.strerror}')
            return
        instat = os.fstat(infd.fileno())
        in_name = f'"{operand}"'

    # --- output_init (src/main.c:795-861) ---
    outfd = None
    opath = None
    if opts.outmode == OM_STDOUT:
        outfd = sys.stdout.buffer
        out_name = "stdout"
    elif opts.outmode == OM_DISCARD:
        outfd = None
        out_name = "the bit bucket"
    else:
        assert operand is not None
        if opts.decompress:
            opath = _suffix_xform(operand, True)
        else:
            opath = operand + ".bz2"
        if opts.force:
            try:
                os.unlink(opath)
            except OSError:
                pass
        try:
            fd = os.open(opath, os.O_WRONLY | os.O_CREAT | os.O_EXCL,
                         instat.st_mode & 0o600 if instat else 0o600)
        except OSError as e:
            _warn(ctx, f'skipping "{operand}": open("{opath}"): '
                       f'{e.strerror}')
            infd is not sys.stdin.buffer and infd.close()
            return
        outfd = os.fdopen(fd, "wb")
        ctx.opathn = opath
        out_name = f'"{opath}"'

    if opts.verbose:
        verb = "decompressing" if opts.decompress else "compressing"
        _info(ctx, f"{verb} {in_name} to {out_name}")

    in_size = instat.st_size if (instat and stat.S_ISREG(instat.st_mode)) \
        else None
    in_len, out_len = _work(ctx, opts, infd, outfd, in_size, in_name)

    # --- finalize (src/main.c:935-962) ---
    if opts.outmode == OM_REGF:
        assert opath is not None
        outfd.flush()  # all data on disk before restoring timestamps
        try:
            os.fchown(outfd.fileno(), instat.st_uid, instat.st_gid)
            if instat.st_mode & 0o7000:
                _warn(ctx, f'"{opath}": won\'t restore any of setuid, '
                           'setgid, sticky')
            os.fchmod(outfd.fileno(), instat.st_mode & 0o777)
        except OSError as e:
            _warn(ctx, f'fchown/fchmod("{opath}"): {e.strerror}')
        os.utime(outfd.fileno(), ns=(instat.st_atime_ns, instat.st_mtime_ns))
        outfd.close()
        ctx.opathn = None
        if not opts.keep:
            try:
                os.unlink(operand)
            except FileNotFoundError:
                pass
            except OSError as e:
                _warn(ctx, f'unlink("{operand}"): {e.strerror}')

    if opts.verbose and in_len > 0 and out_len > 0:
        plain = in_len if not opts.decompress else out_len
        compr = in_len ^ out_len ^ plain
        ratio = compr / plain
        savings = 1 - ratio
        mag = 1 / ratio if ratio < 1 else ratio
        pre, post = ("1:", "") if ratio < 1 else ("", ":1")
        _info(ctx, f"{in_name}: compression ratio is {pre}{mag:.3f}{post}, "
                   f"space savings is {100 * savings:.2f}%")

    if operand is not None:
        infd.close()


# Blocked process-wide for the life of the CLI (reference
# signals.c:89-104): an EPIPE/EFBIG write() fails with errno instead of
# killing a thread mid-pipeline, while the signal stays *pending* on
# the process; the failure path then "promotes" it — cleanup first,
# then die BY the signal (so callers observe death-by-SIGPIPE/XFSZ
# exactly as with the reference binary).
_PROMOTABLE = tuple(getattr(signal, n) for n in ("SIGPIPE", "SIGXFSZ")
                    if hasattr(signal, n))


def _cleanup_output(ctx: _Ctx):
    if ctx.opathn:
        try:
            os.unlink(ctx.opathn)
        except OSError:
            pass
        ctx.opathn = None


def _promote_pending():
    """Die by any pending SIGPIPE/SIGXFSZ (reference bailout(),
    signals.c:262-315).  No-op when none is pending — in-process
    callers (tests, library use) just see the EX_FAIL return."""
    try:
        pending = signal.sigpending()
    except (AttributeError, OSError):
        return
    for s in _PROMOTABLE:
        if s in pending:
            try:
                sys.stderr.flush()
                signal.signal(s, signal.SIG_DFL)
                signal.pthread_sigmask(signal.SIG_UNBLOCK, {s})
                # pending signal delivers here; belt-and-braces:
                os.kill(os.getpid(), s)
            except (ValueError, OSError):
                return


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv
    pname = os.path.basename(argv[0]) if argv else "lbzip2"
    ctx = _Ctx(pname)

    def _sig_cleanup(signum, frame):
        _cleanup_output(ctx)
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    for s in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(s, _sig_cleanup)
        except ValueError:
            pass  # non-main thread (tests)
    try:
        signal.pthread_sigmask(signal.SIG_BLOCK, set(_PROMOTABLE))
    except (AttributeError, OSError, ValueError):
        pass

    try:
        opts = parse_args(ctx, argv[1:])
        if opts.operands:
            for op in opts.operands:
                _process_operand(ctx, opts, op)
        else:
            _process_operand(ctx, opts, None)
    except Fail as e:
        sys.stderr.write(str(e) + "\n")
        _cleanup_output(ctx)
        return EX_FAIL
    except OSError as e:
        import errno as _errno
        if isinstance(e, BrokenPipeError) or \
                e.errno in (_errno.EPIPE, _errno.EFBIG):
            # reference suppresses the EPIPE/EFBIG message
            # (main.c:111-112) and dies by the promoted signal
            _cleanup_output(ctx)
            _promote_pending()
            return EX_FAIL
        sys.stderr.write(f"{pname}: {e.strerror}\n")
        _cleanup_output(ctx)
        return EX_FAIL
    return EX_WARN if ctx.warned else EX_OK


if __name__ == "__main__":
    sys.exit(main())
