"""nnstreamer_tpu_torch — the stream-AI pipeline framework on PyTorch and CUDA.

The PyTorch/CUDA port of ``nnstreamer_tpu``: the same tensor-typed
streaming graphs (converter → filter → decoder), element registry and
model zoo, with ``torch.Tensor``s resident on the GPU between elements
and hand-written CUDA kernels (``ops/kernels``) where the JAX package had
Pallas kernels. Module names follow the JAX package's so each counterpart
is easy to find. Entry points run on ``cuda`` unless the caller asks for
another device.
"""

__version__ = "0.1.0"

from . import core
from .core import (  # noqa: F401 — primary public types
    Buffer,
    Caps,
    TensorDType,
    TensorFormat,
    TensorInfo,
    TensorMemory,
    TensorsConfig,
    TensorsInfo,
)


def _register_builtins() -> None:
    """Import built-in element/filter/decoder registrations
    (the reference's gst_nnstreamer_init, registerer/nnstreamer.c:88-114)."""
    from . import elements  # noqa: F401
    from . import filters  # noqa: F401
    from . import decoders  # noqa: F401
