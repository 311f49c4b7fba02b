from . import fastx  # noqa: F401
from . import formats  # noqa: F401
