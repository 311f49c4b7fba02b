from . import params  # noqa: F401
from . import probminhash  # noqa: F401
from . import jaccard  # noqa: F401
