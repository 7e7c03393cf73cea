"""The port's front end (lbzip2_tpu_torch/cli.py) with its default
engine, on the CPU: it streams through the port's own CompressScheduler
and decompress_stream (which take the device stages when their switches
are on), and gives the JAX CLI's bytes, exit codes and messages, for
good input, damaged input and bad options alike.  ``cli.DEVICE`` is set
to "cpu" here: the port runs the kernels' plain versions.
"""

import bz2
import signal

import numpy as np
import pytest

from lbzip2_tpu import cli as jcli
from lbzip2_tpu import native
from lbzip2_tpu_torch import cli
from lbzip2_tpu_torch.codec import encoder
from lbzip2_tpu_torch.parallel import decode

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")


def _data(n=7000, seed=2):
    rng = np.random.default_rng(seed)
    return bytes(rng.integers(97, 110, n, dtype=np.uint8))


@pytest.fixture(autouse=True)
def default_engine(monkeypatch):
    """The default engine with both device stages on, on the CPU, and
    the signal state that the CLIs' main changes put back afterwards."""
    for k in ("LBZIP2", "BZIP2", "BZIP", "LBZIP2_TPU_ENGINE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(cli, "DEVICE", "cpu")
    monkeypatch.setattr(decode, "DEVICE_HUFF", True)
    monkeypatch.setattr(decode, "DEVICE_IBWT", True)
    handlers = {s: signal.getsignal(s)
                for s in (signal.SIGINT, signal.SIGTERM)}
    mask = signal.pthread_sigmask(signal.SIG_BLOCK, [])
    yield
    for s, h in handlers.items():
        signal.signal(s, h)
    signal.pthread_sigmask(signal.SIG_SETMASK, mask)


@pytest.fixture()
def spies(monkeypatch):
    calls = {"compress": [], "decompress_parallel": []}

    def wrap(mod, name):
        fn = getattr(mod, name)

        def spy(*a, **kw):
            calls[name].append(kw.get("device"))
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    wrap(encoder, "compress")
    wrap(decode, "decompress_parallel")
    return calls


@pytest.mark.parametrize("size", [0, 7000, 300_000])
def test_default_engine_matches_jax_cli(tmp_path, spies, size):
    """The default engine streams: CompressScheduler in, and
    decompress_stream out, the port's own; same bytes as the JAX CLI."""
    data = _data(size)
    level = "-1"  # the fixture's IBWT rows hold level-1 blocks
    mine, theirs = tmp_path / "mine.txt", tmp_path / "theirs.txt"
    mine.write_bytes(data)
    theirs.write_bytes(data)
    assert cli.main(["lbzip2", level, "-k", str(mine)]) == 0
    assert jcli.main(["lbzip2", level, "-k", str(theirs)]) == 0
    out = (tmp_path / "mine.txt.bz2").read_bytes()
    assert out == (tmp_path / "theirs.txt.bz2").read_bytes()
    mine.unlink()
    assert cli.main(["lbunzip2", str(tmp_path / "mine.txt.bz2")]) == 0
    assert mine.read_bytes() == data
    assert spies == {"compress": [], "decompress_parallel": []}
    s = decode.last_stats  # the fixture's switches: both stages ran
    assert s["device_huff"] and s["ibwt_rows"] >= s["blocks"]
    assert s["blocks"] == len(decode.block_payloads(out)) >= bool(size)


@pytest.mark.parametrize("damage", ["crc", "truncated", "magic"])
def test_default_engine_errors_match_jax_cli(tmp_path, capsysbinary,
                                             damage):
    blob = bytearray(bz2.compress(_data(20_000), 1))
    if damage == "crc":
        blob[10] ^= 0xFF
    elif damage == "truncated":
        blob = blob[:len(blob) // 2]
    else:
        blob[1] ^= 0xFF
    f = tmp_path / "bad.bz2"
    f.write_bytes(bytes(blob))
    rc = cli.main(["lbzip2", "-d", "-c", str(f)])
    mine = capsysbinary.readouterr().err
    want_rc = jcli.main(["lbzip2", "-d", "-c", str(f)])
    theirs = capsysbinary.readouterr().err
    assert rc == want_rc == 1
    assert mine == theirs and mine


@pytest.mark.parametrize("argv", [["lbzip2", "--help"], ["lbzcat", "-h"],
                                  ["lbzip2", "--no-such-option"],
                                  ["lbzip2", "-n", "0", "-c"],
                                  ["lbunzip2", "/no/such/file.bz2"]])
def test_options_and_messages_match_jax_cli(capsysbinary, argv):
    def run(main):
        try:
            rc = main(list(argv))
        except SystemExit as e:  # --help leaves through sys.exit
            rc = ("exit", e.code)
        return rc, capsysbinary.readouterr()
    assert run(cli.main) == run(jcli.main)
