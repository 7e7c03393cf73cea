"""Sequential spec-exact reference codec (the oracle layer).

Analogue of the reference's tests/minbzcat.c role: a readable,
sequential implementation every parallel/device path is tested against.
"""

from lbzip2_tpu_torch.ref.encoder import compress  # noqa: F401
