"""Several devices: hash-sharded counting, the all-to-all exchange and the
collective merges over ``torch.distributed`` (port of
kmerutils_tpu/parallel/)."""

from . import mesh  # noqa: F401
from . import collective  # noqa: F401
