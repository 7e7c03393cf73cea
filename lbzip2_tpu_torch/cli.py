"""lbzip2-compatible front end of the port.

A wrapper around ``lbzip2_tpu.cli.main``: the same personalities
(``lbzip2``, ``lbunzip2``, ``lbzcat`` and their aliases, picked from
``argv[0]``), options, file handling, messages and exit codes.  Its
``_work`` looks the engines up by name at call time, so for the
duration of ``main`` this module binds its own ``_engine_compress`` and
``_engine_decompress`` there and restores the originals afterwards.

With ``LBZIP2_TPU_ENGINE=device`` they run the port: ``compress`` of
``lbzip2_tpu_torch.codec.encoder`` and ``decompress_parallel`` of
``lbzip2_tpu_torch.parallel.decode`` (device stages per
``LBZ2_DEVICE_HUFF`` / ``LBZ2_DEVICE_DECODE``), on ``DEVICE``.  Every
other engine is the JAX CLI's own.

    python -m lbzip2_tpu_torch [options] [FILE ...]   # lbzip2
"""

from __future__ import annotations

import os
import sys

from lbzip2_tpu import cli as _cli

DEVICE = "cuda"  # the device of the port's engines (tests use "cpu")

_jax_compress = _cli._engine_compress
_jax_decompress = _cli._engine_decompress


def _device_engine() -> bool:
    return os.environ.get("LBZIP2_TPU_ENGINE", "auto") == "device"


def _engine_compress(data: bytes, opts: _cli.Options) -> bytes:
    if _device_engine():
        from lbzip2_tpu_torch.codec.encoder import compress
        return compress(data, opts.bs100k, sequential_split=opts.ultra,
                        device=DEVICE)
    return _jax_compress(data, opts)


def _engine_decompress(data: bytes, opts: _cli.Options) -> bytes:
    if _device_engine():
        from lbzip2_tpu_torch.parallel.decode import decompress_parallel
        return decompress_parallel(data, n_workers=opts.num_worker,
                                   device=DEVICE)
    return _jax_decompress(data, opts)


def main(argv: list[str] | None = None) -> int:
    """Run the CLI with the port's engines; the personality comes from
    ``argv[0]`` (default ``sys.argv``), as in ``lbzip2_tpu.cli.main``."""
    saved = _cli._engine_compress, _cli._engine_decompress
    _cli._engine_compress = _engine_compress
    _cli._engine_decompress = _engine_decompress
    try:
        return _cli.main(sys.argv if argv is None else argv)
    finally:
        _cli._engine_compress, _cli._engine_decompress = saved
