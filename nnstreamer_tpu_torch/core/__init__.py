"""Core runtime: tensor type system, buffers, meta, config, registry, logging."""

from .types import (
    ANY,
    AUDIO_FORMATS,
    Caps,
    RANK_LIMIT,
    TENSOR_COUNT_LIMIT,
    TensorDType,
    TensorFormat,
    TensorInfo,
    TensorsConfig,
    TensorsInfo,
    VIDEO_FORMATS,
    config_to_caps,
    dimension_string,
    dims_to_shape,
    parse_dimension,
    shape_to_dims,
)
from .buffer import Buffer, TensorMemory, now_ns, NS_PER_SEC
from .meta import TensorMetaInfo, wrap_flex, unwrap_flex, META_SIZE
from .registry import (
    SubpluginType,
    get_all_subplugins,
    get_subplugin,
    has_subplugin,
    register_subplugin,
    unregister_subplugin,
)
from .config import Config, get_config, reset_config
from .hw import AcceleratorSpec, cuda_available, resolve_device
from .log import logger

__all__ = [
    "ANY", "AUDIO_FORMATS", "Caps", "RANK_LIMIT", "TENSOR_COUNT_LIMIT",
    "TensorDType", "TensorFormat", "TensorInfo", "TensorsConfig", "TensorsInfo",
    "VIDEO_FORMATS", "config_to_caps", "dimension_string", "dims_to_shape",
    "parse_dimension", "shape_to_dims",
    "Buffer", "TensorMemory", "now_ns", "NS_PER_SEC",
    "TensorMetaInfo", "wrap_flex", "unwrap_flex", "META_SIZE",
    "SubpluginType", "get_all_subplugins", "get_subplugin", "has_subplugin",
    "register_subplugin", "unregister_subplugin",
    "Config", "get_config", "reset_config",
    "AcceleratorSpec", "cuda_available", "resolve_device",
    "logger",
]
