"""framework=tensorflow — frozen GraphDef (.pb) serving.

Port of nnstreamer_tpu/filters/tf_backend.py (reference equivalent:
ext/nnstreamer/tensor_filter/tensor_filter_tensorflow.cc: a TF session
around a frozen graph, inputname/outputname-addressed feeds and fetches,
DT_STRING inputs fed the raw buffer bytes, tensor_filter_tensorflow.cc:
490-530). Registered as ``tensorflow`` with the aliases ``tensorflow1`` and
``tf``, with the JAX filter's errors: names required, an operation missing,
a dtype or an element count that disagrees, a file that is not a GraphDef.

TensorFlow is imported at ``open()`` only, so the rest of the framework
never pays its import cost. The session runs on the host, as the JAX
filter's does, and TensorFlow is kept off the card: a CUDA build of it maps
nearly all of a card's memory when it first makes its GPU devices, so the
filter hides the GPUs from it before any session
(``tf.config.set_visible_devices([], "GPU")``, and a session config of no
GPU). Each output is placed on the filter's device (one copy up a frame on
the card; the host array itself under ``device=cpu``).
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.buffer import TensorMemory
from ..core.types import TensorInfo, TensorsInfo
from .base import FilterFramework, FilterProps, register_filter


def _hide_gpus(tf: Any) -> None:
    """Make no GPU device visible to TensorFlow. Devices it made already
    stay (``RuntimeError``); the session's config asks for no GPU then."""
    try:
        tf.config.set_visible_devices([], "GPU")
    except RuntimeError:
        pass


@register_filter
class TensorFlowFilter(FilterFramework):
    NAME = "tensorflow"
    ALIASES = ("tensorflow1", "tf")
    ALLOCATE_IN_INVOKE = True

    def __init__(self) -> None:
        super().__init__()
        self._sess: Any = None
        self._graph: Any = None
        self._device: Optional[torch.device] = None
        self._feed_names: List[str] = []
        self._feed_is_string: List[bool] = []
        self._fetch_names: List[str] = []
        self._out_expect: List[tuple] = []

    def open(self, props: FilterProps) -> None:
        super().open(props)
        import tensorflow as tf  # noqa: PLC0415 — heavy, open()-time only

        _hide_gpus(tf)
        self._device = props.accelerator.pick_device(props.device)
        path = props.model_path
        if not path or not os.path.isfile(path):
            raise FileNotFoundError(f"tensorflow: model file {path!r}")
        gd = tf.compat.v1.GraphDef()
        try:
            with open(path, "rb") as f:
                gd.ParseFromString(f.read())
        except Exception as e:
            raise RuntimeError(
                f"tensorflow: {path!r} is not a frozen GraphDef: {e}") from e
        self._graph = tf.Graph()
        with self._graph.as_default():
            tf.import_graph_def(gd, name="")

        self._in_info = props.input_info
        self._out_info = props.output_info
        if (self._in_info is None or self._out_info is None
                or any(t.name is None for t in self._in_info)
                or any(t.name is None for t in self._out_info)):
            # the reference requires explicit names for the tensorflow
            # backend (tensor_filter_tensorflow.cc validateTensor asserts
            # the named op exists; there is no name-less introspection)
            raise ValueError(
                "tensorflow: input/output names are required "
                "(inputname=/outputname= with input=/inputtype=/output=/outputtype=)")

        self._feed_names, self._feed_is_string = [], []
        for t in self._in_info:
            op = self._op_or_raise(t.name)
            dtype = op.outputs[0].dtype
            self._feed_is_string.append(dtype == tf.string)
            if dtype != tf.string and dtype.as_numpy_dtype != t.dtype.np_dtype:
                raise ValueError(
                    f"tensorflow: input {t.name!r} is {dtype.name} in the "
                    f"graph, props declare {t.dtype.name}")
            self._feed_names.append(t.name + ":0")
        self._fetch_names = []
        for t in self._out_info:
            op = self._op_or_raise(t.name)
            dtype = op.outputs[0].dtype
            if dtype != tf.string and dtype.as_numpy_dtype != t.dtype.np_dtype:
                raise ValueError(
                    f"tensorflow: output {t.name!r} is {dtype.name} in the "
                    f"graph, props declare {t.dtype.name}")
            shape = op.outputs[0].shape
            if shape.rank is not None:
                known = [int(d) for d in shape if d is not None]
                declared = int(np.prod(t.shape))
                if known and len(known) == shape.rank \
                        and int(np.prod(known)) != declared:
                    raise ValueError(
                        f"tensorflow: output {t.name!r} is {shape} in the "
                        f"graph ({int(np.prod(known))} elements), props "
                        f"declare {declared}")
            self._fetch_names.append(t.name + ":0")
        # per-output (element count, dtype) for invoke-time validation of
        # graphs whose static shape is unknown until run
        self._out_expect = [
            (int(np.prod(t.shape)), t.dtype.np_dtype) for t in self._out_info]

        threads = {}
        if props.num_threads > 0:
            threads = dict(intra_op_parallelism_threads=props.num_threads,
                           inter_op_parallelism_threads=props.num_threads)
        config = tf.compat.v1.ConfigProto(device_count={"GPU": 0}, **threads)
        self._sess = tf.compat.v1.Session(graph=self._graph, config=config)

    def _op_or_raise(self, name: str):
        try:
            return self._graph.get_operation_by_name(name)
        except KeyError:
            raise ValueError(
                f"tensorflow: graph has no operation named {name!r}") from None

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        return self._in_info, self._out_info

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        # names came from props; only dims/types may be renegotiated
        named = TensorsInfo(tuple(
            TensorInfo(dims=i.dims, dtype=i.dtype, name=d.name)
            for i, d in zip(in_info, self._in_info)))
        self._in_info = named
        return self._out_info

    def invoke(self, inputs: Sequence[TensorMemory]) -> Sequence[TensorMemory]:
        feed = {}
        for name, is_str, mem, info in zip(
                self._feed_names, self._feed_is_string, inputs, self._in_info):
            host = mem.host()
            if is_str:
                # DT_STRING op: the raw buffer bytes become one scalar
                # string element (tensor_filter_tensorflow.cc:502-530)
                feed[name] = np.array(np.ascontiguousarray(host).tobytes(),
                                      dtype=object)
            else:
                feed[name] = np.ascontiguousarray(host).reshape(info.shape)
        outs = self._sess.run(self._fetch_names, feed_dict=feed)
        mems = []
        on_host = self._device.type == "cpu"
        for i, (o, (count, dt)) in enumerate(zip(outs, self._out_expect)):
            arr = np.asarray(o)
            if arr.size != count or arr.dtype != dt:
                # declared output props must match what the session produced
                # (the reference rejects mismatched output=, runTest 3F_n)
                raise RuntimeError(
                    f"tensorflow: output {i} is {arr.shape} {arr.dtype}, "
                    f"props declare {count} elements of {dt}")
            mems.append(TensorMemory(arr) if on_host else TensorMemory(
                torch.from_numpy(np.ascontiguousarray(arr)).to(self._device)))
        return mems

    def close(self) -> None:
        if self._sess is not None:
            self._sess.close()
            self._sess = None
        self._graph = None
        super().close()
