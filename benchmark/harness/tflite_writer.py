"""Frozen copy of chip_smoke.py's .tflite writer (tflite_bytes, TFLiteNet, ssd_anchors, SSD_POSTPROCESS, write_ssd_mobilenet_v2_tflite).

Changes from the original: the weights come from one draw of a
``torch.Generator`` on the run's device (one normal buffer sliced leaf by
leaf), not leaf by leaf from numpy; the quantized form is left out; and the
class heads are centred with the benchmark's own plain reference
(``reference/tflite_net.py``), never with the program's importer. The net
object keeps its op list, which the reference interprets, so the file the
program loads and the function the reference computes come from the same
arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from . import fbs

#: schema TensorType and BuiltinOperator codes the writer uses
TFL_F32, TFL_I32 = 0, 2
TFL_ADD, TFL_CONCAT, TFL_CONV, TFL_DWCONV = 0, 2, 3, 4
TFL_LOGISTIC, TFL_RESHAPE, TFL_CUSTOM = 14, 22, 32
RELU6, LINEAR = 3, 0
#: TFLite_Detection_PostProcess of ssd_mobilenet_v2_coco as
#: export_tflite_ssd_graph.py writes it
SSD_POSTPROCESS = {"max_detections": 10, "max_classes_per_detection": 1,
                   "detections_per_class": 100, "use_regular_nms": False,
                   "nms_score_threshold": 1e-8, "nms_iou_threshold": 0.6,
                   "num_classes": 90, "y_scale": 10.0, "x_scale": 10.0,
                   "h_scale": 5.0, "w_scale": 5.0}


def tflite_flexbuffer_map(values: dict) -> bytes:
    """A custom operator's options: a FlexBuffers map of ints, floats and
    bools."""
    b = fbs.FlexBuilder()
    start = b.start()
    for key, v in values.items():
        b.key(key)
        if isinstance(v, bool):
            b.bool(v)
        elif isinstance(v, float):
            b.float(v)
        else:
            b.sint(int(v))
    b.end_map(start)
    return bytes(b.finish())


def tflite_bytes(tensors: list, operators: list, inputs: list,
                 outputs: list) -> bytes:
    """A one-subgraph ``.tflite`` flatbuffer (buffer 0 empty, version 3,
    identifier ``TFL3``). ``tensors``: dicts of ``shape``, ``type``,
    ``data`` (numpy or None) and ``name``; ``operators``: dicts of
    ``code``, ``inputs``, ``outputs``, ``options`` ((union type, [(slot,
    packer, value, default), ...]) or None), ``custom_code`` and
    ``custom_options``."""
    b = fbs.Builder(1 << 20)
    buffers = []
    b.start_object(1)
    buffers.append(b.end_object())
    buffer_of = []
    for t in tensors:
        if t.get("data") is None:
            buffer_of.append(0)
            continue
        data = b.create_byte_vector(np.ascontiguousarray(t["data"]).tobytes())
        b.start_object(1)
        b.add_uoffset(0, data)
        buffers.append(b.end_object())
        buffer_of.append(len(buffers) - 1)
    tables = []
    for t, buf in zip(tensors, buffer_of):
        shape = b.create_vector(fbs.I32, t["shape"])
        name = b.create_string(t.get("name", ""))
        b.start_object(8)
        b.add_uoffset(0, shape)
        b.add_scalar(1, fbs.I8, t["type"], 0)
        b.add_scalar(2, fbs.U32, buf, 0)
        b.add_uoffset(3, name)
        tables.append(b.end_object())
    codes = []
    for op in operators:
        key = (op["code"], op.get("custom_code"))
        if key not in codes:
            codes.append(key)
    code_tables = []
    for code, custom in codes:
        custom_off = b.create_string(custom) if custom else None
        b.start_object(4)
        b.add_scalar(0, fbs.I8, min(code, 127), 0)
        if custom_off is not None:
            b.add_uoffset(1, custom_off)
        b.add_scalar(3, fbs.I32, code, 0)
        code_tables.append(b.end_object())
    op_tables = []
    for op in operators:
        ins = b.create_vector(fbs.I32, op["inputs"])
        outs = b.create_vector(fbs.I32, op["outputs"])
        opt = op.get("options")
        opt_off = None
        if opt is not None:
            b.start_object(1 + max((s for s, _, _, _ in opt[1]), default=0))
            for slot, packer, value, default in opt[1]:
                b.add_scalar(slot, packer, value, default)
            opt_off = b.end_object()
        custom_off = (b.create_byte_vector(op["custom_options"])
                      if op.get("custom_options") else None)
        b.start_object(9)
        b.add_scalar(0, fbs.U32, codes.index((op["code"], op.get("custom_code"))), 0)
        b.add_uoffset(1, ins)
        b.add_uoffset(2, outs)
        if opt_off is not None:
            b.add_scalar(3, fbs.U8, opt[0], 0)
            b.add_uoffset(4, opt_off)
        if custom_off is not None:
            b.add_uoffset(5, custom_off)
        op_tables.append(b.end_object())
    tensor_vec = b.create_offset_vector(tables)
    in_vec = b.create_vector(fbs.I32, inputs)
    out_vec = b.create_vector(fbs.I32, outputs)
    op_vec = b.create_offset_vector(op_tables)
    b.start_object(5)
    b.add_uoffset(0, tensor_vec)
    b.add_uoffset(1, in_vec)
    b.add_uoffset(2, out_vec)
    b.add_uoffset(3, op_vec)
    subgraph = b.end_object()
    subgraphs = b.create_offset_vector([subgraph])
    code_vec = b.create_offset_vector(code_tables)
    buffer_vec = b.create_offset_vector(buffers)
    desc = b.create_string("written by the benchmark")
    b.start_object(8)
    b.add_scalar(0, fbs.U32, 3, 0)
    b.add_uoffset(1, code_vec)
    b.add_uoffset(2, subgraphs)
    b.add_uoffset(3, desc)
    b.add_uoffset(4, buffer_vec)
    model = b.end_object()
    return bytes(b.finish(model, b"TFL3"))


def _conv_options(stride: int, act: int) -> tuple:
    # Conv2DOptions: 0 padding (SAME), 1 stride_w, 2 stride_h, 3 activation
    return (1, [(0, fbs.I8, 0, 0), (1, fbs.I32, stride, 0), (2, fbs.I32, stride, 0),
                (3, fbs.I8, act, 0)])


def _dwconv_options(stride: int, act: int) -> tuple:
    # DepthwiseConv2DOptions: 0 padding, 1/2 strides, 3 depth_multiplier,
    # 4 activation
    return (2, [(0, fbs.I8, 0, 0), (1, fbs.I32, stride, 0), (2, fbs.I32, stride, 0),
                (3, fbs.I32, 1, 0), (4, fbs.I8, act, 0)])


class TFLiteNet:
    """A TFLite graph under construction: NHWC float32 activations, convs
    with their folded-BatchNorm bias. Weight tensors are declared with
    their standard deviation (He-normal for a ReLU6 conv, LeCun-normal for
    a linear one; biases 0.05) and filled by ``draw``."""

    def __init__(self) -> None:
        self.tensors: List[Dict[str, Any]] = []
        self.operators: List[Dict[str, Any]] = []
        self.inputs: list = []
        self.outputs: list = []

    def tensor(self, shape, data=None, type_=TFL_F32, name="", **role) -> int:
        self.tensors.append(dict(shape=tuple(int(d) for d in shape), type=type_,
                                 data=data, name=name, **role))
        return len(self.tensors) - 1

    def act(self, shape, name="") -> int:
        return self.tensor(shape, name=name, role="act")

    def shape(self, i: int) -> tuple:
        return self.tensors[i]["shape"]

    def _param(self, shape, std: float) -> int:
        return self.tensor(shape, role="param", std=float(std))

    def conv(self, x: int, cout: int, k: int = 1, stride: int = 1,
             act: int = RELU6, gain: float = 1.0, name: str = "") -> int:
        n, h, w, cin = self.shape(x)
        std = np.sqrt((2.0 if act == RELU6 else 1.0) / (k * k * cin)) * gain
        wt = self._param((cout, k, k, cin), std)
        bias = self._param((cout,), 0.05)
        y = self.act((n, -(-h // stride), -(-w // stride), cout), name)
        self.operators.append(dict(code=TFL_CONV, inputs=[x, wt, bias], outputs=[y],
                                   options=_conv_options(stride, act),
                                   stride=stride, act=act))
        return y

    def dwconv(self, x: int, stride: int, act: int = RELU6) -> int:
        n, h, w, c = self.shape(x)
        wt = self._param((1, 3, 3, c), np.sqrt((2.0 if act == RELU6 else 1.0) / 9))
        bias = self._param((c,), 0.05)
        y = self.act((n, -(-h // stride), -(-w // stride), c))
        self.operators.append(dict(code=TFL_DWCONV, inputs=[x, wt, bias], outputs=[y],
                                   options=_dwconv_options(stride, act),
                                   stride=stride, act=act))
        return y

    def add(self, a: int, b: int) -> int:
        y = self.act(self.shape(a))
        self.operators.append(dict(code=TFL_ADD, inputs=[a, b], outputs=[y]))
        return y

    def reshape(self, x: int, shape, name: str = "") -> int:
        s = self.tensor((len(shape),), np.asarray(shape, np.int32), TFL_I32)
        y = self.act(shape, name)
        self.operators.append(dict(code=TFL_RESHAPE, inputs=[x, s], outputs=[y]))
        return y

    def mobilenet_v2_body(self, x: int, width: float) -> tuple:
        """MobileNet-v2's body (TF-slim ``mobilenet_v2``, depth multiplier
        ``width``): returns (the 15th layer's expansion output, the last
        1x1 conv's)."""
        def depth(c):
            d = max(8, int(c * width + 4) // 8 * 8)
            return d + 8 if d < 0.9 * c * width else d

        y = self.conv(x, depth(32), 3, 2)
        blocks = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                  (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        layer, tap = 2, None
        for t, c, n, s in blocks:
            for i in range(n):
                cin = self.shape(y)[-1]
                h = y
                if t != 1:
                    h = self.conv(h, cin * t)
                    if layer == 15:
                        tap = h  # layer_15/expansion_output
                h = self.dwconv(h, s if i == 0 else 1)
                h = self.conv(h, depth(c), act=LINEAR)
                y = self.add(y, h) if i > 0 else h
                layer += 1
        return tap, self.conv(y, depth(1280) if width > 1 else 1280)

    def draw(self, seed: int, device: Any) -> None:
        """Fill every parameter tensor from one normal draw of a
        ``torch.Generator`` seeded with ``seed`` on ``device``."""
        params = [t for t in self.tensors if t.get("role") == "param"]
        total = sum(int(np.prod(t["shape"])) for t in params)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        flat = torch.randn(total, generator=gen, device=device,
                           dtype=torch.float32).cpu().numpy()
        at = 0
        for t in params:
            n = int(np.prod(t["shape"]))
            t["data"] = (flat[at:at + n].reshape(t["shape"])
                         * np.float32(t["std"])).astype(np.float32)
            at += n

    def write(self, path: str) -> int:
        blob = tflite_bytes(self.tensors, self.operators, self.inputs, self.outputs)
        with open(path, "wb") as f:
            f.write(blob)
        return len(blob)


def ssd_anchors(grids: list, num_layers: int = 6, min_scale: float = 0.2,
                max_scale: float = 0.95) -> np.ndarray:
    """ssd_mobilenet_v2_coco's ``multiple_grid_anchor_generator`` (aspect
    ratios 1, 2, 1/2, 3, 1/3, the interpolated scale, the lowest layer
    reduced to 3 boxes): (N, 4) [ycenter, xcenter, h, w], cell-major."""
    scales = [min_scale + (max_scale - min_scale) * i / (num_layers - 1)
              for i in range(num_layers)] + [1.0]
    rows = []
    for layer, g in enumerate(grids):
        if layer == 0:
            boxes = [(0.1, 1.0), (scales[0], 2.0), (scales[0], 0.5)]
        else:
            boxes = [(scales[layer], ar) for ar in (1.0, 2.0, 0.5, 3.0, 1 / 3)]
            boxes.append((np.sqrt(scales[layer] * scales[layer + 1]), 1.0))
        for y in range(g):
            for x in range(g):
                for s, ar in boxes:
                    rows.append(((y + 0.5) / g, (x + 0.5) / g,
                                 s / np.sqrt(ar), s * np.sqrt(ar)))
    return np.asarray(rows, np.float32)


def build_ssd_mobilenet_v2(size: int, width: float, num_classes: int,
                           extra_depths: List[int]) -> dict:
    """ssd_mobilenet_v2_coco as ``export_tflite_ssd_graph.py`` writes it,
    float32, weights not yet drawn: the MobileNet-v2 body, feature maps at
    layer_15's expansion, layer_19 and four extra 1x1/3x3-stride-2 pairs
    (``extra_depths`` × ``width``), 1x1 box and class predictors (3
    anchors a cell on the first map, 6 after), ``num_classes`` + 1 class
    columns through LOGISTIC and ``TFLite_Detection_PostProcess``
    (``SSD_POSTPROCESS``, anchors a constant). Returns the net and the
    indices a reference and the head centring need."""
    net = TFLiteNet()
    x = net.tensor((1, size, size, 3), name="normalized_input_image_tensor",
                   role="input")
    net.inputs = [x]
    tap, top = net.mobilenet_v2_body(x, width)
    maps = [tap, top]
    y = top
    for d in extra_depths:
        d = max(16, int(d * width))
        y = net.conv(net.conv(y, d // 2), d, 3, 2)
        maps.append(y)
    cols = num_classes + 1
    boxes, classes, grids, class_convs = [], [], [], []
    for i, m in enumerate(maps):
        _, h, w, _ = net.shape(m)
        grids.append(h)
        a = 3 if i == 0 else 6
        boxes.append(net.reshape(net.conv(m, a * 4, act=LINEAR, gain=0.5),
                                 (1, h * w * a, 4)))
        logit = net.conv(m, a * cols, act=LINEAR)
        class_convs.append(net.operators[-1])
        classes.append(net.reshape(logit, (1, h * w * a, cols)))
    anchors = ssd_anchors(grids)
    n = len(anchors)

    def concat(parts, last, name):
        y = net.act((1, n, last), name)
        net.operators.append(dict(code=TFL_CONCAT, inputs=parts, outputs=[y],
                                  options=(10, [(0, fbs.I32, 1, 0)])))
        return y

    box_enc = concat(boxes, 4, "raw_outputs/box_encodings")
    logits = concat(classes, cols, "raw_outputs/class_logits")
    return {"net": net, "box_enc": box_enc, "logits": logits, "anchors": anchors,
            "grids": grids, "class_convs": class_convs}


def finish_ssd(built: dict, post: dict) -> None:
    """Append LOGISTIC and the detection post-process to a built SSD and
    set its outputs."""
    net, n = built["net"], len(built["anchors"])
    cols = net.shape(built["logits"])[-1]
    scores = net.act((1, n, cols), "class_predictions")
    net.operators.append(dict(code=TFL_LOGISTIC, inputs=[built["logits"]],
                              outputs=[scores]))
    anchor_t = net.tensor((n, 4), built["anchors"], name="anchors")
    m = int(post["max_detections"])
    outs = [net.act((1, m, 4), "TFLite_Detection_PostProcess"),
            net.act((1, m), "TFLite_Detection_PostProcess:1"),
            net.act((1, m), "TFLite_Detection_PostProcess:2"),
            net.act((1,), "TFLite_Detection_PostProcess:3")]
    net.operators.append(dict(code=TFL_CUSTOM, custom_code="TFLite_Detection_PostProcess",
                              custom_options=tflite_flexbuffer_map(post),
                              inputs=[built["box_enc"], scores, anchor_t], outputs=outs))
    net.outputs = outs
