from . import params  # noqa: F401
from . import probminhash  # noqa: F401
from . import superminhash  # noqa: F401
from . import densminhash  # noqa: F401
from . import setsketch  # noqa: F401
from . import jaccard  # noqa: F401
from . import minhash  # noqa: F401
from . import seqminhash  # noqa: F401
