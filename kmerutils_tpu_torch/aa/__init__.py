from . import alphabet  # noqa: F401
from . import kmeraa  # noqa: F401
