"""Built-in pipeline elements of the port. Importing this package
registers their classes (the reference's registerer/nnstreamer.c:88-114
equivalent)."""

from . import sources  # noqa: F401
from . import sinks  # noqa: F401
from . import filter  # noqa: F401
from . import converter  # noqa: F401
from . import decoder  # noqa: F401
from . import batch  # noqa: F401
from . import transform  # noqa: F401
from . import mux_demux  # noqa: F401
from . import merge_split  # noqa: F401
from . import aggregator  # noqa: F401
from . import crop  # noqa: F401
from . import cond  # noqa: F401
from . import rate  # noqa: F401
from . import repo  # noqa: F401
from . import sparse  # noqa: F401
from . import trainer  # noqa: F401
from ..query import server as _query_server  # noqa: F401
from ..query import client as _query_client  # noqa: F401
from ..query import pubsub as _query_pubsub  # noqa: F401
try:
    from ..query import grpc_io as _query_grpc  # noqa: F401
except ImportError:  # grpcio genuinely absent
    pass
from . import media  # noqa: F401
from . import iio  # noqa: F401
