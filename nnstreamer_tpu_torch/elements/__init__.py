"""Built-in pipeline elements of the slice. Importing this package
registers their classes (the reference's registerer/nnstreamer.c:88-114
equivalent)."""

from . import sources  # noqa: F401
from . import sinks  # noqa: F401
from . import filter  # noqa: F401
from . import converter  # noqa: F401
from . import decoder  # noqa: F401
from . import batch  # noqa: F401
from . import transform  # noqa: F401
