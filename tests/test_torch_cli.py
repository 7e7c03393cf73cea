"""The port's own front end (lbzip2_tpu_torch/cli.py) on the CPU.

With LBZIP2_TPU_ENGINE=device its compress and decompress call the
port's engines (checked with spies) and give the JAX CLI's bytes, exit
codes and messages; it touches nothing of the JAX CLI's module; nothing
imports jax.  ``cli.DEVICE`` is set to "cpu" here: the port runs the
kernels' plain versions.  The default (streaming) engine is in
test_torch_cli_stream.py.
"""

import bz2
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from lbzip2_tpu import cli as jcli
from lbzip2_tpu import native
from lbzip2_tpu.parallel.encode import compress_parallel
from lbzip2_tpu_torch import cli
from lbzip2_tpu_torch.codec import encoder
from lbzip2_tpu_torch.parallel import decode

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="needs C toolchain")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ENGINES = (jcli._engine_compress, jcli._engine_decompress)


def _data(n=7000, seed=2):
    rng = np.random.default_rng(seed)
    return bytes(rng.integers(97, 110, n, dtype=np.uint8))


@pytest.fixture(autouse=True)
def device_engine(monkeypatch):
    """The device engine on the CPU, both device stages on, and the
    signal state that lbzip2_tpu.cli.main changes put back afterwards."""
    for k in ("LBZIP2", "BZIP2", "BZIP"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("LBZIP2_TPU_ENGINE", "device")
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


def test_compress_calls_the_port_and_matches_jax_cli(tmp_path, spies,
                                                     monkeypatch):
    data = _data()
    mine, theirs = tmp_path / "mine.txt", tmp_path / "theirs.txt"
    mine.write_bytes(data)
    theirs.write_bytes(data)
    assert cli.main(["lbzip2", "-9", "-k", str(mine)]) == 0
    assert spies["compress"] == ["cpu"]
    monkeypatch.delenv("LBZIP2_TPU_ENGINE")  # the JAX CLI's default
    assert jcli.main(["lbzip2", "-9", "-k", str(theirs)]) == 0
    out = (tmp_path / "mine.txt.bz2").read_bytes()
    assert out == (tmp_path / "theirs.txt.bz2").read_bytes()
    assert out == compress_parallel(data, 9)
    assert (jcli._engine_compress, jcli._engine_decompress) == JAX_ENGINES


@pytest.mark.parametrize("argv", [["lbzip2", "-d", "-k"], ["lbunzip2", "-k"],
                                  ["bunzip2", "-k"]])
def test_decompress_calls_the_port(tmp_path, spies, argv):
    data = _data(300_000)
    f = tmp_path / "x.bz2"
    f.write_bytes(bz2.compress(data, 1))
    assert cli.main(argv + [str(f)]) == 0
    assert spies["decompress_parallel"] == ["cpu"]
    assert spies["compress"] == []
    assert (tmp_path / "x").read_bytes() == data
    assert decode.last_stats["ibwt_rows"] >= 3  # the device stages ran


@pytest.mark.parametrize("pname", ["lbzcat", "bzcat"])
def test_lbzcat_personality(tmp_path, spies, capsysbinary, pname):
    data = _data()
    f = tmp_path / "x.bz2"
    f.write_bytes(compress_parallel(data, 9) + bz2.compress(b"tail", 1))
    assert cli.main([pname, str(f)]) == 0
    assert capsysbinary.readouterr().out == data + b"tail"
    assert spies["decompress_parallel"] == ["cpu"]


@pytest.mark.parametrize("damage", ["crc", "payload", "truncated", "magic"])
def test_corrupt_input_matches_jax_cli(tmp_path, capsysbinary, damage):
    blob = bytearray(bz2.compress(_data(20_000), 1))
    if damage == "crc":
        blob[10] ^= 0xFF
    elif damage == "payload":
        blob[200] ^= 0x10
    elif damage == "truncated":
        blob = blob[:len(blob) // 2]
    else:
        blob[1] ^= 0xFF
    f = tmp_path / "bad.bz2"
    f.write_bytes(bytes(blob))
    rc = cli.main(["lbzip2", "-d", "-c", str(f)])
    mine = capsysbinary.readouterr().err
    assert (jcli._engine_compress, jcli._engine_decompress) == JAX_ENGINES
    want_rc = jcli.main(["lbzip2", "-d", "-c", str(f)])
    theirs = capsysbinary.readouterr().err
    assert rc == want_rc == 1
    assert mine == theirs and mine  # same message, same stream error


def test_engines_restored_after_a_failing_engine(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("no device")
    monkeypatch.setattr(encoder, "compress", broken)
    f = tmp_path / "x.txt"
    f.write_bytes(b"abc")
    with pytest.raises(RuntimeError, match="no device"):
        cli.main(["lbzip2", "-k", str(f)])
    assert (jcli._engine_compress, jcli._engine_decompress) == JAX_ENGINES


def test_other_engines_are_the_jax_clis(tmp_path, spies, monkeypatch):
    """The oracle engine is the port's own copy of the sequential
    reference codec, as in the JAX CLI; the device engines stay out."""
    monkeypatch.setenv("LBZIP2_TPU_ENGINE", "oracle")
    f = tmp_path / "x.txt"
    f.write_bytes(b"oracle engine " * 50)
    assert cli.main(["lbzip2", "-k", str(f)]) == 0
    assert spies == {"compress": [], "decompress_parallel": []}
    assert bz2.decompress((tmp_path / "x.txt.bz2").read_bytes()) == \
        b"oracle engine " * 50


def _child(args, data, env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("LBZIP2", "BZIP2", "BZIP", "LBZIP2_TPU_ENGINE")}
    env.update(env_extra)
    return subprocess.run([sys.executable] + args, input=data,
                          capture_output=True, env=env, cwd=ROOT,
                          timeout=300)


def test_module_entry_point_and_no_jax():
    """python -m lbzip2_tpu_torch is lbzip2; the device engine imports
    no jax; without CUDA the device engine fails (no CPU fallback)."""
    data = _data()
    r = _child(["-m", "lbzip2_tpu_torch", "-9", "-c"], data, {})
    assert r.returncode == 0 and r.stdout == compress_parallel(data, 9)
    code = ("import sys\n"
            "from lbzip2_tpu_torch import cli\n"
            "cli.DEVICE = 'cpu'\n"
            "rc = cli.main(['lbzcat'])\n"
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.')]\n"
            "sys.exit(rc)\n")
    r = _child(["-c", code], r.stdout, {"LBZIP2_TPU_ENGINE": "device",
                                        "LBZ2_DEVICE_HUFF": "1",
                                        "LBZ2_DEVICE_DECODE": "1"})
    assert r.returncode == 0, r.stderr
    assert r.stdout == data
    r = _child(["-m", "lbzip2_tpu_torch", "-c"], data,
               {"LBZIP2_TPU_ENGINE": "device", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and not r.stdout
    assert b"CUDA is not available" in r.stderr
