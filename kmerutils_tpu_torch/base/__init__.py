from . import alphabet  # noqa: F401
from . import sequence  # noqa: F401
from . import kmer  # noqa: F401
