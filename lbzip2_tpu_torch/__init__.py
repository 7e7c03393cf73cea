"""PyTorch + CUDA port of lbzip2_tpu, the bzip2-compatible codec.

The JAX package ``lbzip2_tpu`` stays the reference; this package mirrors
its layout (``core/``, ``native/``, ``ref/``, ``ops/``, ``codec/``,
``parallel/``, ``cli.py``) under the same names and keeps its own copy
of everything it needs: it imports torch, never jax, and nothing of
``lbzip2_tpu``.  Entry points:
``lbzip2_tpu_torch.codec.encoder.compress(data, 9, device="cuda")``,
``lbzip2_tpu_torch.parallel.decode.decompress_parallel`` /
``decompress_stream`` and ``python -m lbzip2_tpu_torch``.
"""

__version__ = "0.1.0"
