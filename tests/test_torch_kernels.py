"""The torch port's epilogue kernels against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; those are held
bit-exact against ``nnstreamer_tpu.ops.pallas.epilogue``'s kernels run in
interpret mode and against its ``*_reference`` functions, on the same
numpy inputs. The CUDA kernels themselves are held against the plain
versions on the card (``cuda`` marker; skipped without a GPU, and by
``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nnstreamer_tpu.ops.pallas import epilogue as jep  # noqa: E402
from nnstreamer_tpu_torch.ops.kernels import epilogue as tep  # noqa: E402


def _class_scores(case: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if case == "ssd_slice":  # the detection path's (anchors, classes - 1)
        return rng.normal(size=(2916, 91)).astype(np.float32)[:, 1:]
    if case == "ties":
        x = rng.integers(0, 3, size=(40, 33)).astype(np.float32)
        x[0] = 1.5  # all-equal row: index 0
        x[1, [4, 20, 31]] = 9.0  # first max wins
        return x
    if case == "L_not_multiple_of_32":
        return rng.normal(size=(17, 45)).astype(np.float32)
    if case == "L_is_1":
        return rng.normal(size=(9, 1)).astype(np.float32)
    if case == "neg_inf_row":
        x = rng.normal(size=(6, 70)).astype(np.float32)
        x[2] = -np.inf
        return x
    raise ValueError(case)


CLASS_CASES = ["ssd_slice", "ties", "L_not_multiple_of_32", "L_is_1",
               "neg_inf_row"]


@pytest.mark.parametrize("case", CLASS_CASES)
def test_class_reduce_plain_bit_exact_with_pallas(case):
    x = _class_scores(case)
    kb, ki = jep.class_reduce(np.ascontiguousarray(x), interpret=True)
    rb, ri = jep.class_reduce_reference(x)
    pb, pi = tep.class_reduce_plain(torch.from_numpy(np.ascontiguousarray(x)))
    assert pb.dtype == torch.float32 and pi.dtype == torch.int32
    for b, i in ((kb, ki), (rb, ri)):
        np.testing.assert_array_equal(np.asarray(b), pb.numpy())
        np.testing.assert_array_equal(np.asarray(i), pi.numpy())


def test_class_reduce_wrapper_on_cpu_runs_plain_on_strided_rows():
    base = torch.from_numpy(np.random.default_rng(2).normal(
        size=(50, 91)).astype(np.float32))
    view = base[:, 1:]  # the decoder's background-dropped column view
    before = tep.class_reduce.launches
    got = tep.class_reduce(view)
    want = tep.class_reduce_plain(view.contiguous())
    assert tep.class_reduce.launches == before  # no kernel on the CPU
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _boxes(k: int, seed: int, *, zero_area: bool = False):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 1.0, (k, 2)).astype(np.float32)
    wh = rng.uniform(0.02, 0.4, (k, 2)).astype(np.float32)
    x0, y0 = c[:, 0], c[:, 1]
    x1, y1 = x0 + wh[:, 0], y0 + wh[:, 1]
    if zero_area:
        x1[::3] = x0[::3]  # zero width
        y1[1::3] = y0[1::3]  # zero height
    scores = np.sort(rng.uniform(0, 1, k).astype(np.float32))[::-1]
    return [np.array(a, np.float32) for a in (x0, y0, x1, y1, scores)]


NMS_CASES = [
    ("K1", 1, 0.5, 0.5, {}),
    ("K7", 7, 0.5, 0.3, {}),
    ("K64", 64, 0.5, 0.5, {}),
    ("K256", 256, 0.5, 0.5, {}),
    ("all_below_threshold", 64, 0.5, 1.5, {}),
    ("zero_area_boxes", 64, 0.5, 0.1, {"zero_area": True}),
    ("tight_iou", 256, 0.3, 0.2, {}),
]


@pytest.mark.parametrize("name,k,iou,thr,kw", NMS_CASES,
                         ids=[c[0] for c in NMS_CASES])
def test_nms_sweep_plain_bit_exact_with_pallas(name, k, iou, thr, kw):
    cols = _boxes(k, seed=k + len(name), **kw)
    kern = jep.nms_sweep(*cols, iou_threshold=iou, threshold=thr,
                         interpret=True)
    ref = jep.nms_sweep_reference(*cols, iou, thr)
    plain = tep.nms_sweep_plain(*(torch.from_numpy(c) for c in cols),
                                iou_threshold=iou, threshold=thr)
    np.testing.assert_array_equal(np.asarray(kern), plain.numpy())
    np.testing.assert_array_equal(np.asarray(ref), plain.numpy())
    if name == "all_below_threshold":
        assert (plain.numpy() == -1.0).all()


@pytest.mark.parametrize("k", [1000, 1025, 1917])
def test_nms_sweep_plain_bit_exact_with_reference_large_k(k):
    # K past the old one-block limit of 512, past the kernel's
    # shared-memory relation (1024), and the TFLite SSD's 1917 anchors
    cols = _boxes(k, seed=k)
    ref = np.asarray(jep.nms_sweep_reference(*cols, 0.5, 0.3))
    plain = tep.nms_sweep_plain(*(torch.from_numpy(c) for c in cols),
                                iou_threshold=0.5, threshold=0.3)
    np.testing.assert_array_equal(ref, plain.numpy())
    assert 0 < int((plain.numpy() > 0).sum()) < k


@pytest.mark.parametrize("k", [1025, 1917, 2048, 4097])
def test_nms_scratch_layout_is_every_chunk_slab_in_order(k):
    # past NMS_SMEM_MAX_K the kernel builds the relation chunk-major: chunk
    # c's slab is its 32 rows by the tiles c // 32 .. T - 1 of their words,
    # slabs back to back in chunk order, the order its sweep reads them
    words = -(-k // 32)
    tiles = -(-words // 32)
    starts, n = [], 0
    for c in range(words):
        starts.append(n)
        n += tiles - c // 32
    assert [tep.nms_slab_tile(c, k) for c in range(words + 1)] == starts + [n]
    assert tep.nms_scratch_words(k) == n * tep.NMS_TILE_WORDS
    assert tep.nms_scratch_words(tep.NMS_SMEM_MAX_K) == 0


def test_nms_sweep_duplicate_boxes_keep_first():
    cols = _boxes(32, seed=5)
    for c in cols[:4]:
        c[8:12] = c[8]  # four identical boxes: IoU exactly 1
    plain = tep.nms_sweep_plain(*(torch.from_numpy(c) for c in cols),
                                iou_threshold=0.5, threshold=0.0).numpy()
    ref = np.asarray(jep.nms_sweep_reference(*cols, 0.5, 0.0))
    np.testing.assert_array_equal(ref, plain)
    assert plain[8] == cols[4][8] and (plain[9:12] == -1.0).all()


def test_wrappers_raise_off_cpu_and_cuda():
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tep.class_reduce(meta)
    col = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tep.nms_sweep(col, col, col, col, col, iou_threshold=0.5,
                      threshold=0.5)
    with pytest.raises(ValueError, match="unsupported device"):
        tep.segment_colorize(meta, torch.zeros((256, 4), dtype=torch.uint8))


# --------------------------------------------------------------------------- #
# segment_colorize
# --------------------------------------------------------------------------- #

def _palette(rows: int = 256) -> np.ndarray:
    """Every entry distinct in its four bytes, so a wrong row shows."""
    rng = np.random.default_rng(3)
    return rng.integers(0, 255, (rows, 4), dtype=np.uint8)


def _logits(case: str) -> np.ndarray:
    rng = np.random.default_rng(17)
    if case == "deeplab_257":  # the segmentation path's (H, W, classes)
        return rng.normal(size=(257, 257, 21)).astype(np.float32)
    if case == "ties":
        x = rng.integers(0, 3, size=(31, 21)).astype(np.float32)
        x[0] = 0.5  # all-equal pixel: class 0
        x[1, [3, 9, 20]] = 7.0  # first max wins
        return x
    if case.startswith("C"):  # C=1 / C=150 / C=300 (argmax >= 256 fills)
        c = int(case[1:])
        x = rng.normal(size=(5, 7, c)).astype(np.float32)
        if c == 300:
            x[0, :, 280] = 50.0
        return x
    if case == "neg_inf_pixel":
        x = rng.normal(size=(9, 21)).astype(np.float32)
        x[4] = -np.inf
        return x
    raise ValueError(case)


COLORIZE_CASES = ["deeplab_257", "ties", "C1", "C150", "C300",
                  "neg_inf_pixel"]


@pytest.mark.parametrize("case", COLORIZE_CASES)
def test_segment_colorize_plain_bit_exact_with_pallas(case):
    x, pal = _logits(case), _palette()
    kern = np.asarray(jep.segment_colorize(x, pal, interpret=True))
    ref = np.asarray(jep.segment_colorize_reference(x, pal))
    plain = tep.segment_colorize_plain(torch.from_numpy(x), torch.from_numpy(pal))
    assert plain.dtype == torch.uint8 and plain.shape == x.shape[:-1] + (4,)
    np.testing.assert_array_equal(ref, plain.numpy())
    if case != "C300":  # the TPU kernel fills (0, 0, 0, 0) past row 255
        np.testing.assert_array_equal(kern, plain.numpy())
    if case == "C300":
        assert (plain.numpy()[0] == 255).all()


@pytest.mark.parametrize("dtype", ["int32", "uint8", "float32"])
def test_segment_colorize_ids_plain_bit_exact_with_pallas(dtype):
    ids = np.random.default_rng(5).integers(0, 21, (33, 17)).astype(dtype)
    pal = _palette()
    kern = np.asarray(jep.segment_colorize(ids, pal, pre_argmaxed=True,
                                           interpret=True))
    ref = np.asarray(jep.segment_colorize_reference(ids, pal,
                                                    pre_argmaxed=True))
    plain = tep.segment_colorize_plain(torch.from_numpy(ids),
                                       torch.from_numpy(pal), pre_argmaxed=True)
    np.testing.assert_array_equal(ref, plain.numpy())
    np.testing.assert_array_equal(kern, plain.numpy())


def test_segment_colorize_nan_takes_first_nan_class():
    # the reference's contract (jnp.argmax: first NaN wins); the TPU kernel
    # gives class C here instead, a divergence inside the JAX package
    x = np.array([[1.0, np.nan, 3.0], [np.nan, np.nan, 0.0],
                  [2.0, 5.0, np.nan]], np.float32)
    pal = _palette()
    ref = np.asarray(jep.segment_colorize_reference(x, pal))
    plain = tep.segment_colorize_plain(torch.from_numpy(x),
                                       torch.from_numpy(pal)).numpy()
    np.testing.assert_array_equal(ref, plain)
    np.testing.assert_array_equal(plain, pal[[1, 0, 2]])


def test_segment_colorize_out_of_range_ids_follow_take_fill():
    ids = np.array([-1.5, 20.9, -1, -256, -257, 256, 300, 0, 255, -100],
                   np.float32)
    pal = _palette()
    ref = np.asarray(jep.segment_colorize_reference(ids, pal,
                                                    pre_argmaxed=True))
    plain = tep.segment_colorize_plain(torch.from_numpy(ids),
                                       torch.from_numpy(pal),
                                       pre_argmaxed=True).numpy()
    np.testing.assert_array_equal(ref, plain)
    fill = np.full(4, 255, np.uint8)
    want = [pal[255], pal[20], pal[255], pal[0], fill, fill, fill, pal[0],
            pal[255], pal[156]]
    np.testing.assert_array_equal(plain, np.stack(want))


def test_segment_colorize_short_palette_fills_past_its_rows():
    x = np.random.default_rng(8).normal(size=(40, 12)).astype(np.float32)
    pal = _palette(8)
    ref = np.asarray(jep.segment_colorize_reference(x, pal))
    plain = tep.segment_colorize_plain(torch.from_numpy(x),
                                       torch.from_numpy(pal)).numpy()
    np.testing.assert_array_equal(ref, plain)
    assert (plain == 255).all(axis=-1).any()


def test_segment_colorize_wrapper_on_cpu_runs_plain_on_strided_rows():
    base = torch.from_numpy(np.random.default_rng(6).normal(
        size=(9, 11, 30)).astype(np.float32))
    view = base[..., 4:25]  # 21 classes, rows 30 apart
    pal = torch.from_numpy(_palette())
    before = tep.segment_colorize.launches
    routes = dict(tep.segment_colorize.launches_by_route)
    got = tep.segment_colorize(view, pal)
    want = tep.segment_colorize_plain(view.contiguous(), pal)
    assert tep.segment_colorize.launches == before  # no kernel on the CPU
    assert tep.segment_colorize.launches_by_route == routes
    assert torch.equal(got, want)


# --------------------------------------------------------------------------- #
# on the card: kernels against their plain versions
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLASS_CASES)
def test_class_reduce_kernel_matches_plain(cuda_device, case):
    x = torch.from_numpy(np.ascontiguousarray(_class_scores(case))).to(cuda_device)
    before = tep.class_reduce.launches
    got = tep.class_reduce(x)
    want = tep.class_reduce_plain(x)
    assert tep.class_reduce.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name,k,iou,thr,kw", NMS_CASES,
                         ids=[c[0] for c in NMS_CASES])
def test_nms_sweep_kernel_matches_plain(cuda_device, name, k, iou, thr, kw):
    cols = [torch.from_numpy(c).to(cuda_device)
            for c in _boxes(k, seed=k + len(name), **kw)]
    before = tep.nms_sweep.launches
    got = tep.nms_sweep(*cols, iou_threshold=iou, threshold=thr)
    want = tep.nms_sweep_plain(*cols, iou_threshold=iou, threshold=thr)
    assert tep.nms_sweep.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 33, 513, 1000, 1024, 1025, 1055, 1056,
                               1057, 1917, 2048, 4097])
@pytest.mark.parametrize("iou", [0.5, 0.1], ids=["iou0.5", "iou0.1"])
def test_nms_sweep_kernel_bit_exact_up_to_k2048(cuda_device, k, iou):
    # the chunked sweep across word boundaries, the shared-memory relation
    # up to K 1024 and the global one past it: K 1055-1057 around the end of
    # a whole word (33 of them), the TFLite SSD's 1917, and K 4097 with five
    # tiles a row
    cols = [torch.from_numpy(c).to(cuda_device) for c in _boxes(k, seed=k)]
    before = tep.nms_sweep.launches
    got = tep.nms_sweep(*cols, iou_threshold=iou, threshold=0.2)
    want = tep.nms_sweep_plain(*cols, iou_threshold=iou, threshold=0.2)
    assert tep.nms_sweep.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_nms_sweep_kernel_bit_exact_as_the_tflite_op_calls_it(cuda_device):
    # TFLite_Detection_PostProcess's fast path: 1917 anchors, the score
    # column the 0/1 indicator of the threshold, threshold 0.5, IoU 0.6,
    # every row alive
    cols = [torch.from_numpy(c).to(cuda_device) for c in _boxes(1917, seed=23)]
    cols[4] = torch.ones_like(cols[4])
    before = tep.nms_sweep.launches
    got = tep.nms_sweep(*cols, iou_threshold=0.6, threshold=0.5)
    want = tep.nms_sweep_plain(*cols, iou_threshold=0.6, threshold=0.5)
    assert tep.nms_sweep.launches == before + 1
    assert torch.equal(got, want)
    assert 0 < int((want > 0).sum()) < 1917


@pytest.mark.cuda
@pytest.mark.parametrize("case", COLORIZE_CASES + ["strided", "ids"])
def test_segment_colorize_kernel_matches_plain(cuda_device, case):
    pal = torch.from_numpy(_palette()).to(cuda_device)
    pre = case == "ids"
    if case == "strided":
        x = torch.from_numpy(_logits("deeplab_257")).to(cuda_device)[..., 2:19]
    elif pre:
        x = torch.tensor([-1, 20, -256, -257, 256, 300, 0, 255, 7],
                         dtype=torch.int32, device=cuda_device)
    else:
        x = torch.from_numpy(_logits(case)).to(cuda_device)
    route = {"strided": "row", "ids": "ids"}.get(case, "bulk")
    _colorize_on_card(x, pal, pre, route)


def _colorize_on_card(x, pal, pre: bool, route: str) -> None:
    before = tep.segment_colorize.launches
    routes = dict(tep.segment_colorize.launches_by_route)
    got = tep.segment_colorize(x, pal, pre_argmaxed=pre)
    want = tep.segment_colorize_plain(x, pal, pre_argmaxed=pre)
    torch.cuda.synchronize()
    assert tep.segment_colorize.launches == before + 1
    routes[route] += 1
    assert tep.segment_colorize.launches_by_route == routes
    assert torch.equal(got, want)


def _card_logits(case: str, dev) -> torch.Tensor:
    rng = np.random.default_rng(23)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    if case == "ragged_last_tile":  # 66049 = 258 * 256 + 1 pixels
        return normal(257, 257, 21)
    if case == "offset_by_one_float":  # a base 4 bytes off 16-byte alignment
        return normal(257 * 257 * 21 + 1)[1:].view(257, 257, 21)
    if case == "batched":
        return normal(4, 257, 257, 21)
    if case.startswith("batched_slice"):  # tensor_unbatch's per-frame views
        i = int(case[-1])
        return normal(4, 257, 257, 21)[i:i + 1][0]
    if case.startswith("strided_C"):
        c = int(case[len("strided_C"):])
        return normal(67, c + 3)[:, 1:c + 1]
    if case == "zeros_and_nan":
        x = normal(300, 21)
        x[3, 5] = float("nan")
        x[4, [0, 7]] = float("nan")
        x[5] = float("-inf")
        x[6] = -1.0
        x[6, [2, 9]] = torch.tensor([-0.0, 0.0], device=dev)  # a tie: class 2
        return x
    c = int(case[1:])  # "C<classes>"
    x = normal(67, c)
    x[::7, c // 2] = float("nan")
    return x


COLORIZE_CARD_CASES = [
    ("ragged_last_tile", "bulk"), ("offset_by_one_float", "bulk"),
    ("batched", "bulk"), ("batched_slice1", "bulk"), ("batched_slice2", "bulk"),
    ("batched_slice3", "bulk"), ("zeros_and_nan", "bulk"),
    ("C1", "bulk"), ("C21", "bulk"), ("C150", "bulk"), ("C300", "bulk"),
    ("C4096", "bulk"), ("C12000", "row"), ("strided_C1", "row"),
    ("strided_C21", "row"), ("strided_C150", "row"), ("strided_C4096", "row"),
    ("strided_C12000", "row"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case,route", COLORIZE_CARD_CASES,
                         ids=[c[0] for c in COLORIZE_CARD_CASES])
def test_segment_colorize_kernel_routes_bit_exact(cuda_device, case, route):
    pal = torch.from_numpy(_palette()).to(cuda_device)
    _colorize_on_card(_card_logits(case, cuda_device), pal, False, route)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["aligned", "offset_by_one", "seven"])
def test_segment_colorize_ids_kernel_bit_exact(cuda_device, case):
    pal = torch.from_numpy(_palette()).to(cuda_device)
    ids = torch.from_numpy(np.random.default_rng(29).integers(
        -300, 300, 257 * 257 + 1).astype(np.int32)).to(cuda_device)
    x = {"aligned": ids[:-1], "offset_by_one": ids[1:], "seven": ids[:7]}[case]
    _colorize_on_card(x, pal, True, "ids")


@pytest.mark.cuda
@pytest.mark.parametrize("pre", [False, True], ids=["logits", "ids"])
def test_segment_colorize_palette_off_word_alignment(cuda_device, pre):
    # a contiguous palette view one byte into its storage: the wrapper
    # copies it, since the kernels read a row as one 4-byte word
    buf = torch.zeros(256 * 4 + 1, dtype=torch.uint8, device=cuda_device)
    buf[1:] = torch.from_numpy(_palette().reshape(-1)).to(cuda_device)
    pal = buf[1:].view(256, 4)
    assert pal.is_contiguous() and pal.data_ptr() % 4 == 1
    x = (torch.from_numpy(np.random.default_rng(37).integers(-300, 300, (33, 17)).astype(
        np.int32)).to(cuda_device) if pre else _card_logits("C21", cuda_device))
    _colorize_on_card(x, pal, pre, "ids" if pre else "bulk")


def _card_scores(case: str, dev) -> torch.Tensor:
    rng = np.random.default_rng(31)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    if case == "zeros_and_nan_payloads":
        x = torch.full((301, 90), -1.0, device=dev)  # not a multiple of 8 rows a block
        x[0, [3, 7]] = torch.tensor([-0.0, 0.0], device=dev)
        x[1, [3, 7]] = torch.tensor([0.0, -0.0], device=dev)
        x[2, [5, 80]] = -0.0
        words = np.array([0x7FC00001, 0xFFC00002, 0xFFC00003, 0x7FC00004,
                          0x7F800001], np.uint32).view(np.int32)
        bits = x.view(torch.int32)
        for (r, c), w in zip([(3, 10), (3, 40), (4, 2), (4, 70), (6, 89)], words):
            bits[r, c] = int(w)
        x[5] = float("-inf")
        return x
    if case == "n_not_multiple_of_rows":  # 2917 rows, 365 blocks of 8
        return normal(2917, 91)[:, 1:]
    if case == "offset_by_one_float":
        return normal(1001 * 90 + 1)[1:].view(1001, 90)
    if case == "strided":
        return normal(77, 301)[:, 3:300]
    return normal(1001, int(case[1:]))  # "L<classes>"


CLASS_CARD_CASES = ["zeros_and_nan_payloads", "n_not_multiple_of_rows",
                    "offset_by_one_float", "strided", "L1", "L21", "L150", "L300",
                    "L4096"]


@pytest.mark.parametrize("case", CLASS_CARD_CASES)
def test_class_reduce_wrapper_on_cpu_matches_reference_on_card_cases(case):
    # the inputs the card's cases hold the kernel to, on the CPU: the plain
    # version the kernel is compared with follows the JAX reference there
    x = _card_scores(case, torch.device("cpu"))
    best, idx = tep.class_reduce(x)
    rb, ri = jep.class_reduce_reference(x.contiguous().numpy())
    np.testing.assert_array_equal(np.asarray(ri), idx.numpy())
    np.testing.assert_array_equal(np.asarray(rb), best.numpy())


@pytest.mark.parametrize("case", [c[0] for c in COLORIZE_CARD_CASES])
def test_segment_colorize_wrapper_on_cpu_matches_reference_on_card_cases(case):
    x = _card_logits(case, torch.device("cpu"))
    pal = _palette()
    got = tep.segment_colorize(x, torch.from_numpy(pal))
    want = np.asarray(jep.segment_colorize_reference(x.contiguous().numpy(), pal))
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLASS_CARD_CASES)
def test_class_reduce_kernel_bit_exact_on_card_cases(cuda_device, case):
    x = _card_scores(case, cuda_device)
    before = tep.class_reduce.launches
    got = tep.class_reduce(x)
    want = tep.class_reduce_plain(x)
    torch.cuda.synchronize()
    assert tep.class_reduce.launches == before + 1
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].isnan(), want[0].isnan())
    assert torch.equal(got[0][~got[0].isnan()], want[0][~want[0].isnan()])
    # the score is the winning element itself: its sign of zero, its payload
    own = x[torch.arange(x.shape[0], device=cuda_device), got[1].long()]
    assert torch.equal(got[0].view(torch.int32), own.contiguous().view(torch.int32))
