"""core/data.py's casts on the card (marked ``cuda``; they skip without
one). In range, the card's casts equal the CPU's. Out of range a C cast
has no defined result, and the card's differs from the CPU's: its values
are pinned here as ``typecast_array``'s docstring states them (torch
2.11 with CUDA 12.8 on the H100)."""

import math

import pytest

torch = pytest.importorskip("torch")

from nnstreamer_tpu_torch.core.data import typecast_array, typecast_value  # noqa: E402
from nnstreamer_tpu_torch.core.types import TensorDType  # noqa: E402

pytestmark = pytest.mark.cuda

IN_RANGE = [300.5, -1.0, -3.7, 3.7, 255.9, 70000.0, -129.0, 0.5, -0.0]
WILD = [300.5, -1.0, 1e10, -1e10, math.nan, 2.0 ** 32 + 5]
#: the card's results for WILD (torch 2.11, CUDA 12.8, H100)
CARD = {"uint8": [44, 255, 0, 0, 0, 5],
        "int8": [44, -1, -1, 0, 0, -1],
        "int32": [300, -1, 2147483647, -2147483648, -2147483648, 2147483647],
        "uint32": [300, 0, 4294967295, 0, 2147483648, 4294967295]}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dt", ["int8", "uint8", "int16", "uint16", "int32",
                                "int64", "float16", "bfloat16", "float32"])
def test_in_range_casts_equal_the_cpu(card, dt):
    vals = IN_RANGE
    if not getattr(torch, dt).is_floating_point:
        info = torch.iinfo(getattr(torch, dt))
        vals = [v for v in IN_RANGE if info.min <= v <= info.max]
    x = torch.tensor(vals, dtype=torch.float64)
    got = typecast_array(x.to(card), TensorDType(dt))
    assert got.device == card and got.dtype == getattr(torch, dt)
    assert torch.equal(got.cpu(), typecast_array(x, TensorDType(dt)))
    assert typecast_value(x[:1].to(card), TensorDType(dt)) == \
        typecast_value(x[:1], TensorDType(dt))


@pytest.mark.parametrize("dt", sorted(CARD))
def test_out_of_range_casts_on_the_card(card, dt):
    x = torch.tensor(WILD, dtype=torch.float64, device=card)
    assert typecast_array(x, TensorDType(dt)).cpu().tolist() == CARD[dt]
