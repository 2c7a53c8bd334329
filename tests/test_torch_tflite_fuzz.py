"""Seeded fuzz of the port's TFLite importer: the cases of
``tests/test_tflite_fuzz.py`` with the same seeds and builders.

Each random float chain (conv / dwconv / pool / elementwise / activation /
resize / reduce / softmax) goes through the JAX importer under ``jax.jit``,
the port's on the CPU and ``tf.lite.Interpreter``: port against JAX within
``torch_tflite_parity``'s float32 tolerance (rtol 1e-5 / atol 1e-6), port
against the interpreter within the JAX case's 1e-4. Each random uint8
quantized chain: port against JAX at most one code apart on at most 2% of
the codes, top-1 equal; port against the interpreter within the JAX case's
three steps.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import test_tflite_fuzz as J  # noqa: E402 — the JAX cases' builders
import torch_tflite_parity as P  # noqa: E402
from nnstreamer_tpu_torch.models.tflite_import import parse_tflite  # noqa: E402


@pytest.mark.parametrize("case", range(24))
def test_fuzz_chain_matches_interpreter(case, tmp_path):
    rng = np.random.default_rng(1000 + case)
    h = int(rng.integers(4, 12))
    w = int(rng.integers(4, 12))
    c = int(rng.integers(1, 4))
    gb = J._GraphBuilder(rng, (1, h, w, c))
    for _ in range(int(rng.integers(2, 7))):
        gb.add_random_op()
    if not gb.operators:  # every step degenerate (rare)
        pytest.skip("degenerate case")
    blob = gb.finish()
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    (ref,) = J._interp_run(blob, x)
    (ours,) = P.run_both(blob, tmp_path, x)
    assert ours.shape == ref.shape, \
        f"case {case}: shape {ours.shape} vs {ref.shape}"
    np.testing.assert_allclose(
        ours, ref, rtol=1e-4, atol=1e-4,
        err_msg=f"case {case}: ops={[o['code'] for o in gb.operators]}")


@pytest.mark.parametrize("case", range(8))
def test_fuzz_quant_chain_bounded_drift(case, tmp_path):
    rng = np.random.default_rng(7000 + case)
    for _attempt in range(6):
        blob, _ = J._build_quant_chain(rng, int(rng.integers(2, 5)))
        if blob is None:
            continue
        path = P.write(blob, tmp_path, "q.tflite")
        m = parse_tflite(path)
        in_shape = m.tensors[m.inputs[0]].shape
        x = rng.integers(0, 255, in_shape, dtype=np.uint8)
        (ref,) = J._interp_run(blob, x)
        if len(np.unique(ref)) >= 8:
            break
    else:
        pytest.skip("no non-degenerate grid found")
    (ours,) = P.run_both(path, tmp_path, x)
    assert ours.dtype == ref.dtype == np.uint8
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert int(diff.max()) <= 3, \
        f"case {case}: quant drift {int(diff.max())} steps"
