"""Format core: constants, CRC32, bitstream I/O."""

from lbzip2_tpu_torch.core import bits, constants, crc32  # noqa: F401
