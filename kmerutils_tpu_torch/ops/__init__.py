from . import bitops  # noqa: F401
from . import merge  # noqa: F401
from . import rng  # noqa: F401
from . import tournament  # noqa: F401
