"""PyTorch + CUDA port of the lbzip2_tpu level-9 device-chain compressor.

The JAX package ``lbzip2_tpu`` stays the reference; this package mirrors
its layout (``ops/``, ``codec/``) and reuses its jax-free parts
(``core``, ``ref``, ``native`` and the scheduler in ``codec.encoder``).
Entry point: ``lbzip2_tpu_torch.codec.encoder.compress(data, 9,
device="cuda")``.  Nothing here imports jax.
"""
