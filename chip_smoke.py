"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):
  1. build the CUDA kernels from ``nnstreamer_tpu_torch/ops/kernels/csrc``
     (one nvcc per source, started together) and print the build time;
  2. print the card's name and power limit (nvidia-smi);
  3. hold each of the seven kernels bit-exact against its plain PyTorch
     version on the card (flash_attention within its stated tolerance),
     at its path's shapes and at edge cases, then time kernel, plain version
     and (where one exists) the PyTorch yardstick: device time per call from
     CUDA-graph replay (the ``ms`` numbers of the kernels line), and the
     eager per-call time, which the host's launch path sets for calls this
     small; then run bounding_box's device reduce for the postprocess and
     OpenVINO modes on CUDA tensors against the same reduce on the CPU and
     the host decode;
     the models' uint8 preprocess on all 256 values must be bit-equal on the
     card and on the CPU;
  4. drive the SSD-MobileNet-v2 300x300 detection pipeline (91 classes,
     width 1.0, seeded random weights) over 64 random frames with the
     kernels' launch counts reset just before and read just after: the
     counts must equal the frame count, the model output must stay on the
     card, detections must come out, and one frame's fused device reduce
     must agree with the host decode path (rtol 1e-4);
  5. drive the MobileNet-v2 224 classification pipeline over a few frames
     and check each label against the model's own argmax; then README.md's
     headline nns-launch pipeline (videotestsrc ! tensor_converter !
     tensor_transform ! tensor_filter model=zoo://mobilenet_v2 !
     tensor_decoder image_labeling ! tensor_sink; 64 random 224x224 frames,
     width 1.0, 1001 classes, bf16) through the port's CLI, then parsed
     with the transform fused into the filter's invoke and not: one invoke
     per frame, logits on the card and bit-equal between the two runs,
     labels equal to their argmax, SingleShot on a frame equal to its
     pipeline logits;
  6. drive the DeepLab-v3 257x257 segmentation pipeline (21 classes, width
     1.0, bf16) over 64 random frames with ``segment_colorize`` fused into
     the filter's invoke: one launch per frame, every one on the ``bulk``
     route (``launches_by_route``), canvases on the card, and
     every canvas bit-equal to the host decode of the logits the fused
     invoke produced for it, with more than one class in each;
  7. drive the same model behind ``tensor_batch max_batch=4`` …
     ``tensor_unbatch`` over 30 frames (the last group padded), the decoder
     at its default ``async_depth``: 30 canvases in order with their pts,
     one launch per frame, all on the ``bulk`` route (the slices sit 4, 8
     and 12 bytes off 16-byte alignment), each canvas bit-equal to the host
     decode of its own slice of the batched logits;
  8. drive the PoseNet 257 pose pipeline (heatmap-offset) over 16 frames:
     the decoder's device reduce must give the host decode's keypoints,
     and tied heatmap cells must resolve to the first one on the card;
     then gpu_smoke (utils/probes.py): every item passes, and the CUDA
     normalize_u8 and quantize_affine launch;
  9. LM serving at the bench LM's full width (V 8192, d_model 1024, 16
     heads, 8 layers, d_ff 4096; seeded random weights): ``LMEngine`` with
     max_len 1024, 8 slots, chunk 16 serves the bench's 24-request greedy
     mix, over float32 params and over their w8a8 form; tokens/s, prefills,
     decode steps, waste and launches are printed, ``dequant_gelu_requant``
     must launch once per layer per prefill and per decode step of the
     w8a8 engine, and three requests re-run alone in a 1-slot engine must
     give the same tokens (the engine's exactness contract; before it, one
     decode step over 8 slots must give each slot's K/V and logits the
     bits of the slot stepped alone);
  9b. the multi-tenant card (bench.py's ``_multiplex_lane`` at full width):
     8 pipelines ``videotestsrc pattern=random seed=7+i ! tensor_converter !
     tensor_filter model=zoo://mobilenet_v2?width=1.0&size=224 !
     tensor_sink`` of 64 frames on one ``DeviceEngine(max_coalesce=8)`` and
     then each dispatching alone; then the same 8 beside 2 fused SSD-300
     pipelines (64 frames each) and the float32 LM engine serving the 24
     requests, enrolled, on one engine and then without it: every MobileNet
     label equal to the run without the engine (the logits' largest
     difference printed), SSD boxes and canvases byte-equal with
     ``class_reduce`` and ``nms_sweep`` once a frame, the LM's tokens equal;
     merged steady frames/s (an engine run leaves out each width's first,
     capturing batch; a direct run each stream's first frame), coalesce
     widths, occupancy, tenant waits, captures by width, coalesce fallbacks,
     the dispatch loop's seconds by tenant and the card's busy share
     (nvidia-smi's utilization.gpu every 100 ms); then ``python -m
     nnstreamer_tpu_torch.cli --sched 8 --sched-tenants cam:2`` on the
     README's headline string exits 0 and prints its ``sched:`` line;
  9c. the paged KV cache on bench.py's paged serving lane at full width
     (``_serving_paged_lane``: 32 paged slots on a pool of 128 pages of 64
     tokens against the 8-slot contiguous engine, the same KV bytes; 64
     greedy requests sharing a 128-token prefix, prompts 160-256 tokens,
     32-128 generated), over float32 params and their w8a8 form: first the
     two admission routes (the window prefill of a whole prompt and the
     prefix hit's suffix window over the shared pages) must give the
     suffix's K/V rows and first-token logits bit for bit, their distance
     from the dense ``lm_prefill_masked`` printed; one paged decode step
     over 32 slots must give each slot's logits and page writes the bits of
     the slot stepped alone, and replayed as a graph the eager step's (pages
     1..n: the null page's writes are unordered); a copy-on-write and
     host-offload case (one slot, 5 pages) must equal the contiguous
     engine and count COW copies, offloads and re-uploads; then the mix on
     both engines with graphs, a second mix (seed 8) on the same engines
     (replays only), and the first again eagerly: every request's tokens
     equal across engines and modes, three requests equal to their 1-slot
     paged runs, ``hit_requests`` >= 31, ``pages_peak`` <= 128,
     ``dequant_gelu_requant`` 8 x (prefills + decode steps) on w8a8;
     tokens/s of both engines and their ratio, waste, peak memory, prefix
     hit rate, evictions, COW copies, a chunk's gather and scatter device
     ms and the captures by signature are printed;
 10. the flash prefill pipeline ``appsrc ! tensor_filter ! tensor_sink``
     over a prefill bundle of the same model, B 8 × T 1024, with flash
     attention (one ``flash_attention`` launch per layer) and dense, in two
     lanes: bf16 params (every launch on the ``wgmma`` route; last-token
     logits of flash and dense within the bf16 bound) and float32 params
     (every launch on the ``tf32x3`` route; within PREFILL_F32_TOL); the
     tokens/s of all four runs;
 11. the filter's own options on the card: a ``bucket=4`` pipeline of
     flexible frames and a ``bucket=4,resize=12:9`` one, each bit-equal to
     the same pipeline on CPU tensors;
 12. the repo-LSTM composite loop (bench.py:280-298 without its query
     hop): ``appsrc → tensor_mux sync_mode=nosync ← tensor_reposrc →
     tensor_filter model=zoo://lstm_cell?features=64&input_size=32 →
     tensor_demux tensorpick=0,1:2 → [queue → tensor_sink], [queue →
     tensor_reposink]``, one frame in flight, 16 warm-up frames then 192
     timed: frames/s and round trip p50 (push to the sink's read), every
     replayed output byte-equal to the eager one, the card within LSTM_TOL
     of the CPU after 208 recurrent steps, and exactly one host-to-card and
     one card-to-host copy a frame (the state stays on the card);
 13. crop → bucketed classifier: 64 1920x1080 frames with 1-9 seeded boxes
     through ``tensor_crop → tensor_filter model=zoo://mobilenet_v2
     custom="bucket=4,resize=224:224"``: one graph a padded size, frames/s
     and regions/s over the steady frames, logits byte-equal to eager and
     frame 0's to the bundle called on its own regions;
 14. tensor_mux/demux, tensor_merge/split (a strided view into flat
     regions), tensor_aggregator, tensor_if, tensor_rate and the sparse
     codec on tensors on the card, each byte for byte against the same
     pipeline on CPU tensors, outputs on the card (the codec's on the
     host);
 15. the media conversions on card tensors byte for byte against the CPU
     (RGBA 1080p videoscale, BGRx -> RGB, RGB -> GRAY8, audioconvert S16LE
     <-> F32LE and S16LE -> U8); then the video path, parsed from its launch
     string on a card pipeline: 1920x1080 random frames ``! videoscale !
     video/x-raw,width=300,height=300 ! videoconvert format=RGB !
     tensor_converter ! tensor_filter model=SSD-300 ! tensor_decoder
     mode=bounding_box ! tensor_sink``, 64 frames with graphs and 64 eagerly:
     every scaled frame stays on the card and equals the same element run on
     the CPU byte for byte (Pillow's BILINEAR, ops/resample.py), one 1080p
     frame is copied up a frame (through videoscale's pinned staging) and no
     memory is copied up after it, ``class_reduce`` and ``nms_sweep`` launch
     once a frame; steady fps, videoscale's host ms a frame and device ms a
     1080p frame;
 16. an interop hop into SSD-300, for each wire format (FlexBuffers,
     FlatBuffers, protobuf; the port's own codecs): 300x300 random frames
     ``! tensor_converter ! tensor_decoder mode=<fmt> ! other/<fmt> !
     tensor_converter ! tensor_filter model=SSD-300 ! tensor_decoder
     mode=bounding_box ! tensor_sink``, 64 frames with graphs: boxes, labels
     and canvases byte-equal to the same frames without the hop,
     ``class_reduce`` and ``nms_sweep`` once a frame; frames/s with and
     without the hop, host ms a frame to encode and to parse, wire bytes a
     frame; then SSD's two raw outputs of one frame through each format,
     parsed back byte-equal;
 17. python3 post-processing at full width: MobileNet-v2 224's 1001 logits
     ``! tee`` into ``tensor_filter framework=python3`` (a numpy softmax in
     the reference's script contract) and a raw-logits sink, 32 frames: each
     output byte-equal to the same numpy function on its frame's logits; the
     filter's host ms and bytes copied from the card a frame;
 18. the C filters on card tensors: native/examples/scaler_filter.c built
     with gcc under ``custom=factor=3.5``, a filter generated by
     ``nns-new-filter-torch --kind c`` and built with its Makefile, and a
     custom-easy callable whose card tensor reaches the sink on the card;
 19. online fine-tuning at full width: ``appsrc ! tee ! queue !
     tensor_trainer model=zoo://mobilenet_v2 optimizer=adam
     learning_rate=1e-3 checkpoint_path=... resume=true`` beside ``t. !
     queue ! tensor_filter model=zoo://mobilenet_v2 is-updatable=true !
     tensor_sink`` (224, 1001 classes, bf16 compute, float32 masters), 24
     frames of 16 images alternating two fixed batches: the loss falls, the
     zoo's shared module is unchanged, the EOS checkpoint reloads bit-equal
     to the masters; a second pipeline resumes at frame 24 and, hot-swapped
     to the trained bundle while running, serves its eager forward's logits
     bit for bit (unlike the initial model's); frames/s, step ms and peak
     memory; then the element on the card against the CPU at float32 (TF32
     off), 3 steps at batch 4 with adam and with sgd: losses within
     TRAIN_LOSS_RTOL, each leaf's change of the masters within
     TRAIN_CHANGE_RTOL of the CPU's (a fault of this run's own masters, a
     skipped update, a flipped sign or a leaf left out, must fail that
     check), sgd's masters within TRAIN_SGD_ATOL; adam's run again step by
     step on both devices: each step's gradients and the masters beyond
     1e-5 apart after it;
 9d. obs on the card (after the multi-tenant phase): bench.py's
     ssd_mobilenet_300_fps string (64 frames, async-depth 64) through the
     CLI with ``--metrics-port 0 --trace --watchdog --profile
     --events-dump`` and without, in turns (off, on, off, on), a second
     thread scraping ``/metrics``, ``/healthz``, ``/readyz``,
     ``/debug/traces``, ``/debug/events`` and ``/debug/profile`` while the
     frames flow: boxes and reduce rows bit-equal to the obs-off run,
     ``nnstpu_pipeline_buffers_total`` = 64 for every element, one
     ``pipeline.element`` span per element per frame, every route 200 while
     the pipeline plays, device lanes labelled ``class_reduce`` and
     ``nms_sweep``, every sampled dispatch's CUDA-event device time in (0,
     host interval + wait], the sampled invoke beside the filter's own graph
     replayed; then the paged w8a8 lane (phase 9c's requests, a new 32-slot
     engine, the mix and a second mix) with metrics, tracing, health,
     events and the profiler on and off, in turns, ``/metrics`` scraped in
     a loop through the engine's captures: tokens equal, the
     ``nnstpu_serving_kv_*`` series equal ``kv_stats``, prefill and decode
     engine records and a ``cuda.dequant_gelu_requant`` kernel record; then
     ``gpu_smoke``, two flash bf16 prefill batches and one fused DeepLab-v3
     frame under the profiler: all seven ``cuda.*`` kernel labels
     recorded; frames/s and tokens/s with obs off and on, beside the card;
 20. print the card's name and power limit again, the launches of each path
     (every count set to 0 just before the path and read just after), the
     graphs of each path, the stream paths' rates, the ``kernels`` JSON line,
     then the device line last.

Every pipeline path (SSD, classification, the headline fused and unfused,
DeepLab fused and batched, PoseNet, the flash and dense prefill lanes, the
``bucket=`` and ``resize=`` pipelines, the repo loop and crop → bucketed
filter), SingleShot and both LM engines run
their filter invokes (the engine: its admit prefill, decode chunk and verify
window) as CUDA graphs (``core/graphs.py``): the first call of a signature
runs eagerly and is captured, later calls replay. Each path's graph counts
are reset just before it and read just after: it fails unless it replayed,
and unless it captured at least one and at most as many signatures as its
inputs have distinct shapes, each after one eager warm-up; its captures,
replays, warm-ups, rate and the memory reserved after it are printed. Each
path then runs again on the same inputs inside ``graphs.disabled()`` (the
eager reference): every output must be bit-equal to the replayed one (the
SSD reduce rows and detections, the DeepLab canvases and slices, the pose
heatmaps, the headline logits, the prefill logits, the filter options'
rows), the LM mix must give the same tokens and stats, and both rates are
printed side by side; one 8-slot decode step replayed as a graph must give
the eager step's K/V and logits bit for bit. The kernels' launch counts are
asserted on the graph runs, where replays add each graph's launches (SSD
64 and 64, DeepLab 64 and 30 all on ``bulk``, flash one per layer per batch
on its route, ``dequant_gelu_requant`` once per layer per w8a8 prefill and
decode step). The fused DeepLab run checks its canvases against the host
decode of the logits its eager run hands the epilogue (a replay runs no
Python, so only the eager run can record them). The interop, python3 and C
filter paths (16-18) run once, with graphs: their references are the same
frames without the hop, numpy, and the C arithmetic.

Phase 3 first times three untimed rounds of the launch floor (a process's
first two timings read short), then measures the floor (a one-element fill
replayed as the kernels are) right after ``class_reduce``, ``nms_sweep``
and the ids route of ``segment_colorize`` and prints it beside each. It holds ``class_reduce`` bit for bit
(index, score and the score's bits, which are the winning element's own:
+0.0/-0.0 ties, NaN payloads) at L 1 to 4096, N not a multiple of a
block's rows, strided rows and a base one float off, and
``segment_colorize`` on each route (``bulk``, ``row``, ``ids``,
each case asserting its route): the ragged last block, C 1 to 12000,
strided rows, a base one float off, the batched (4, 257, 257, 21) input and
its four slices, ids offset by one, and a palette off 4-byte alignment.
It holds ``normalize_u8`` on every uint8 value at 1/127.5 and 1/255 to
float32 and bf16, at sizes 1 to 1920x1080x3, on strided and unaligned views
and float inputs, and ``quantize_affine`` on NaN, inf, 1e9, ties and zero
points 0 and 128; both for each type pair at every boundary of their
tiling (``preprocess.tiling``: n 1, 15, 16, 17, a tile +-1, the persistent
grid's tiles +-1), on views 1-15 bytes off alignment and on an output that
shares the input's offset, ``normalize_u8`` also uint8 to bf16 at 2^31 + 17
elements, each call one launch (both timed at 224 and 1080p:
``normalize_u8`` beside ``torch.add(bias, x, alpha=scale, out=y)``,
``quantize_affine`` beside ``torch.quantize_per_tensor``, whose differing
values are counted). The ids route of ``segment_colorize`` is also timed on
ids in range beside ``pal[ids]``. It also
holds ``flash_attention`` (causal and full, float32 and bf16,
normalised and residual, ragged L, D 1 to 512, strided views; each case
printed with its route: ``wgmma`` for bf16 at D 64 and 128 with L 70, 200
and 1000, the LM's split-head views uncopied and a view off 16-byte
alignment copied, ``tf32x3`` for the rest, float32 always, D 136 to 512 in
128-column chunks), ``nms_sweep`` bit for bit at K 1 to 2048 (past the
shared-memory relation at K 1025 and 2048) and on IoUs that sit exactly on
or one float above the threshold, with the launch floor (a one-element
fill replayed as the kernel is) beside its bound and the phase split of
``scripts/nms_phase_split.py``, and ``dequant_gelu_requant`` (R 1,
3, 8, 33, 132 and 512 by F 4096, 1000, 11 and 70000, float32 and bf16, a
zero row each; timed at R 8 and 512) against their plain versions, and one w8a8 MLP
at the serving shape bit for bit against its composition with the plain
epilogue.

Exits non-zero without a card or without the package beside it.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from fractions import Fraction

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SSD_SPEC = "zoo://ssd_mobilenet_v2?size=300&num_classes=91"
CLS_SPEC = "zoo://mobilenet_v2"
SEG_SPEC = "zoo://deeplab_v3?size=257&num_classes=21"
POSE_SPEC = "zoo://posenet?size=257"
SSD_FRAMES = 64
CLS_FRAMES = 8
SEG_FRAMES = 64
SEG_BATCH, SEG_BATCH_FRAMES = 4, 30  # 7 full groups + 1 padded
POSE_FRAMES = 16
#: the bench LM (bench.py _LM_DIMS): vocab, d_model, heads, layers
LM_DIMS = (8192, 1024, 16, 8)
LM_MAX_LEN, LM_SLOTS, LM_CHUNK = 1024, 8, 16
#: bench.py's serving mix: prompt lengths and generation budgets cycle
LM_REQUESTS, LM_PROMPTS, LM_GENS = 24, (64, 192, 384, 512), (32, 64, 96, 128)
LM_ISOLATED = (0, 9, 22)  # requests re-run alone in a 1-slot engine
#: bench.py's paged serving lane (_serving_paged_lane) at its full width:
#: 32 paged slots on a pool of 128 pages of 64 tokens against the 8-slot
#: contiguous engine, the same KV bytes; 64 greedy requests sharing a
#: 128-token prefix, prompts 160-256 tokens, 32-128 generated
PAGED_SLOTS, PAGE_SIZE = 32, 64
PAGED_POOL = LM_SLOTS * LM_MAX_LEN // PAGE_SIZE
PAGED_REQUESTS, PAGED_PREFIX = 64, 128
PAGED_PROMPTS, PAGED_GENS = (160, 192, 224, 256), (32, 64, 96, 128)
PAGED_ISOLATED = (0, 33, 62)  # requests re-run alone in a 1-slot paged engine
#: the copy-on-write and offload case: a pool of 5 pages, one slot, host
#: offload, a 96-token shared prefix (a page and a half)
COW_POOL, COW_PREFIX = 5, 96
FLASH_B, FLASH_T, FLASH_FRAMES = 8, 1024, 8
#: README.md's headline nns-launch pipeline, as the README prints it
HEADLINE = ("videotestsrc ! tensor_converter ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! tensor_filter "
            "framework=xla-tpu model=zoo://mobilenet_v2 ! tensor_decoder "
            "mode=image_labeling option1=labels.txt ! tensor_sink")
HEADLINE_FRAMES = 64

#: IoU arithmetic per candidate pair in nms_sweep: 2 min, 2 max, 2 sub,
#: 2 clamp, 1 mul, 1 add, 1 sub, 1 div, 1 compare
NMS_OPS_PER_PAIR = 13
#: dequant_gelu_requant per element: 2 mul (dequant), 8 for gelu plus its
#: tanh, abs and max (absmax), div, rint and 2 clamps (requant)
DGR_OPS_PER_ELEMENT = 17

#: flash_attention against its plain version: (rtol, atol) by dtype — the
#: JAX package's bf16 bound (tests/test_pallas.py); the float32 one from
#: summation order (both accumulate in float32 over the same 64-key tiles)
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (5e-2, 3e-2)}
#: the float32 prefill's last-token logits, flash (tf32x3) against dense
#: (cuBLAS float32): each layer's attention agrees to about 1e-6, and 8
#: layers with their LayerNorms and MLPs may carry that to the logits
#: amplified; stated before the first run on the card
PREFILL_F32_TOL = (1e-4, 1e-4)
#: the route every flash launch of a prefill lane must take, by dtype
PREFILL_ROUTE = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}
#: the repo-LSTM composite loop (bench.py:280-298 without its query hop): the
#: bench's widths, 16 warm-up frames, then 192 timed
LSTM_SPEC = "zoo://lstm_cell?features=64&input_size=32"
LSTM_DIN, LSTM_F, LSTM_SLOT, LSTM_WARM, LSTM_FRAMES = 32, 64, 77, 16, 192
#: the loop's outputs on the card against the CPU's, after 208 recurrent
#: steps (rtol, atol): both sum each gate's products in float32 (TF32 off)
#: in their own orders, about 3e-7 apart a step, and the gates contract
#: the error; stated before the first run on the card
LSTM_TOL = (1e-5, 1e-5)
#: crop -> bucketed classifier: 1920x1080x3 frames with 1-9 boxes each
CROP_SPEC = "zoo://mobilenet_v2"
CROP_FRAMES, CROP_MAX_BOXES = 64, 9
#: the media path: 1920x1080 random frames scaled on the card into SSD-300
MEDIA_FRAMES = 64
#: the interop hops: 300x300 random frames serialised and parsed back in
#: each wire format before SSD-300, against the same frames without a hop
INTEROP_FRAMES = 64
INTEROP_FORMATS = ("flexbuf", "flatbuf", "protobuf")
#: python3 post-processing of MobileNet-v2's 1001 logits, a frame at a time
PY3_FRAMES = 32
#: the multi-tenant card (bench.py's _multiplex_lane at full width): 8
#: MobileNet-v2 224 pipelines, 2 fused SSD-300 pipelines and the float32 LM
#: engine on one DeviceEngine, against the same tenants without it
MT_SPEC = "zoo://mobilenet_v2?width=1.0&size=224"
MT_SIZE, MT_SSD_SIZE = 224, 300
MT_PIPES, MT_FRAMES, MT_SSD, MT_SSD_FRAMES, MT_COALESCE = 8, 64, 2, 64, 8
#: the obs phase: SSD-300 frames a CLI run (bench.py's ssd_mobilenet_300_fps
#: string), the paged w8a8 lane's requests, and each measurement's turns
#: (obs off, on, off, on)
OBS_SSD_FRAMES = 64
OBS_TURNS = (False, True, False, True)
OBS_STALL_S = 30.0
#: a scrape round's pause: a scraper a hundred times busier than a 1 s
#: Prometheus interval, still a small share of the pipeline's GIL
OBS_SCRAPE_PAUSE_S = 0.01
OBS_ROUTES = ("/metrics", "/healthz", "/readyz", "/debug/traces",
              "/debug/events", "/debug/profile")
#: the python3 script: the reference contract (nnstreamer_python shapes,
#: one list of flat arrays in and out), a float32 softmax in numpy
PY3_SCRIPT = """
import numpy as np
import nnstreamer_python as nns


def softmax(x):
    e = np.exp(x - x.max())
    return (e / e.sum()).astype(np.float32)


class CustomFilter:
    def getInputDim(self):
        return [nns.TensorShape([1001, 1, 1, 1], np.float32)]

    def getOutputDim(self):
        return [nns.TensorShape([1001, 1, 1, 1], np.float32)]

    def invoke(self, input_array):
        return [softmax(input_array[0])]
"""
#: framework=custom: card tensors of 4:1 float32 through the scaler
C_FRAMES, C_FACTOR = 16, 3.5
#: online fine-tuning at full width: MobileNet-v2 224, 1001 classes, bf16
#: compute with float32 masters; 24 frames of 16 images
TRAIN_SPEC = "zoo://mobilenet_v2?batch=16"
TRAIN_FRAMES, TRAIN_BATCH = 24, 16
#: the trainer on the card against the CPU: float32, TF32 off, 3 steps at
#: batch 4. Losses: both sum in float32 in their own orders (rtol, stated
#: before the first run on the card, which measured 4.819e-06). Masters:
#: each leaf's change from the initial masters, the card's against the
#: CPU's, as the norm of their difference over the norm of the CPU's
#: change; a skipped update or a leaf left out gives 1, a flipped sign 2,
#: and the bound lies halfway to the least of them. Sound runs on the card
#: (NVIDIA H100 80GB HBM3, 700.00 W) read 0.1543 with adam and 0.05898
#: with sgd, each at its worst leaf: a BatchNorm leaf whose gradient is a
#: sum that nearly cancels. sgd's masters also within lr times the
#: gradients' difference, 1% of lr
TRAIN_CHECK_SPEC = "zoo://mobilenet_v2?dtype=float32&batch=4"
TRAIN_CHECK_STEPS = 3
TRAIN_LOSS_RTOL = 1e-4
TRAIN_CHANGE_RTOL = 0.5
TRAIN_SGD_ATOL = 1e-5


def _bound_ms(nbytes: float, ops: float, dtype=torch.float32) -> tuple:
    """The least time for the work on this card: bytes over its memory
    rate, operations over its peak for ``dtype`` (float32 on the CUDA
    cores, bf16 and "tf32" on the tensor cores), the data sheet's numbers
    that ``utils/probes.py`` holds."""
    from nnstreamer_tpu_torch.utils import probes

    t_bytes = nbytes / probes.chip_peak_hbm_bw() * 1e3
    t_ops = ops / probes.chip_peak_flops(None, dtype) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _eager_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Per call, back to back from Python: for launches this small the
    host's launch path, not the device, sets this number."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, per_graph: int = 20, replays: int = 20) -> float:
    """Device time per call: ``per_graph`` calls captured into one CUDA
    graph and replayed, so no host launch gap sits between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def _rotating(make, nbytes: int) -> tuple:
    """An iterator cycling over distinct inputs from ``make()`` (``nbytes``
    each), enough that a CUDA graph of ``_device_ms``'s 20 calls reads
    100 MB, twice the card's 50 MB L2, where 20 inputs can hold that
    (1080p frames; a 224 frame's 20 stay in L2): each call then reads its
    input from device memory, as a stream's next frame does. Returns the
    iterator and the MB the graph's inputs span."""
    import itertools

    count = min(20, max(2, -(-100 * 2 ** 20 // nbytes)))
    return itertools.cycle([make() for _ in range(count)]), count * nbytes / 2 ** 20


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where the other has NaN."""
    return a.shape == b.shape and a.dtype == b.dtype \
        and torch.equal(a.isnan(), b.isnan()) \
        and torch.equal(a[~a.isnan()], b[~b.isnan()])


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def _random_boxes(rng, k: int, dev) -> list:
    c = rng.uniform(0.0, 1.0, (k, 2)).astype(np.float32)
    wh = rng.uniform(0.02, 0.4, (k, 2)).astype(np.float32)
    cols = [c[:, 0], c[:, 1], c[:, 0] + wh[:, 0], c[:, 1] + wh[:, 1],
            np.sort(rng.uniform(0, 1, k).astype(np.float32))[::-1].copy()]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in cols]


def _launch_floor_ms(dev) -> float:
    """A one-element ``fill_`` replayed as the kernels are: the least
    device time of any launch, the floor under a kernel whose bound is
    below it. Measured right after the kernel it is printed beside."""
    return _device_ms(torch.zeros(1, device=dev).zero_)


def _settle_timing(dev) -> list:
    """The first two ``_device_ms`` readings of a process come out short
    (at the same clock), so three untimed rounds of the launch floor go
    before the first kernel is timed. Returns their readings."""
    return [_launch_floor_ms(dev) for _ in range(3)]


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def check_class_reduce(ep, dev, rng) -> dict:
    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    cases = []
    x = normal(2916, 91)
    cases.append(("slice (2916, 91)[:, 1:]", x[:, 1:]))
    ties = torch.from_numpy(rng.integers(0, 4, (300, 45)).astype(np.float32)).to(dev)
    ties[0] = 2.0  # all-equal row
    cases.append(("ties, L=45", ties))
    cases.append(("L=1", normal(7, 1)))
    odd = normal(33, 97)
    odd[3, 5] = float("nan")
    odd[4] = float("-inf")
    cases.append(("L=97, NaN and -inf rows", odd))
    # +0.0 and -0.0 tie (the first stands, its own sign returned); the first
    # NaN wins with its own payload and sign
    z = torch.full((301, 90), -1.0, device=dev)
    z[0, [3, 7]] = torch.tensor([-0.0, 0.0], device=dev)
    z[1, [3, 7]] = torch.tensor([0.0, -0.0], device=dev)
    z[2, [5, 80]] = -0.0
    payloads = np.array([0x7FC00001, 0xFFC00002, 0xFFC00003, 0x7FC00004, 0x7F800001],
                        np.uint32).view(np.int32)
    for (r, c), w in zip([(3, 10), (3, 40), (4, 2), (4, 70), (6, 89)], payloads):
        z.view(torch.int32)[r, c] = int(w)
    z[5] = float("-inf")
    cases.append(("+0.0/-0.0 ties and NaN payloads (N 301, not a multiple of R)", z))
    for l in (1, 21, 150, 300, 4096):
        cases.append((f"L={l}, N 1001", normal(1001, l)))
    cases.append(("base offset by one float", normal(1001 * 90 + 1)[1:].view(1001, 90)))
    cases.append(("strided rows, offset base", normal(77, 301)[:, 3:300]))
    for name, t in cases:
        before = ep.class_reduce.launches
        got = ep.class_reduce(t)
        want = ep.class_reduce_plain(t)
        torch.cuda.synchronize()
        own = t[torch.arange(t.shape[0], device=dev), got[1].long()]
        if not (_same(got[0], want[0]) and torch.equal(got[1], want[1])
                and _bits_equal(got[0], own) and ep.class_reduce.launches == before + 1):
            raise AssertionError(f"class_reduce differs from plain: {name}")
    main = cases[0][1]
    n, l = main.shape
    err = _max_abs_err(ep.class_reduce(main)[0], ep.class_reduce_plain(main)[0])
    calls = {"kernel": lambda: ep.class_reduce(main),
             "plain": lambda: ep.class_reduce_plain(main),
             "library": lambda: torch.max(main, dim=-1)}
    dev_ms = {k: _device_ms(f) for k, f in calls.items()}
    floor_ms = _launch_floor_ms(dev)
    eager = {k: _eager_ms(f) for k, f in calls.items()}
    ms, plain_ms, library_ms = dev_ms["kernel"], dev_ms["plain"], dev_ms["library"]
    bound, by = _bound_ms(n * l * 4 + n * 8, n * l)
    print(f"class_reduce N={n} L={l} (a warp a row, {-(-n // 8)} blocks of 8) device "
          f"ms/call (CUDA graph): kernel={ms:.6f} plain={plain_ms:.6f} "
          f"library(torch.max)={library_ms:.6f}; "
          f"eager ms/call: kernel={eager['kernel']:.6f} plain={eager['plain']:.6f} "
          f"library={eager['library']:.6f}; bound_ms={bound:.8f} ({by}); launch floor "
          f"{floor_ms:.6f} (a one-element fill_ replayed the same way); bit-exact on "
          f"{len(cases)} cases (score bits = the winning element's)", flush=True)
    return {"name": "class_reduce", "route": "cuda",
            "source": "nnstreamer_tpu_torch/ops/kernels/csrc/class_reduce.cu",
            "replaces": "nnstreamer_tpu/ops/pallas/epilogue.py:173",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def _nms_edge_boxes(dev) -> list:
    """Five boxes whose IoUs are exactly 1/3 (boxes 0 and 1, 2 and 3) and
    1/2 (0 and 2's neighbours), so a threshold at or one float below them
    puts inter / union where only its rounding decides the test."""
    cols = ([0.0, 0.5, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0],
            [1.0, 1.5, 2.0, 2.0, 1.0], [1.0, 1.0, 1.0, 1.0, 1.0],
            [0.9, 0.8, 0.7, 0.6, 0.5])
    return [torch.tensor(c, dtype=torch.float32, device=dev) for c in cols]


def check_nms_sweep(ep, dev, rng) -> dict:
    def run_both(cols, iou, thr, name):
        got = ep.nms_sweep(*cols, iou_threshold=iou, threshold=thr)
        want = ep.nms_sweep_plain(*cols, iou_threshold=iou, threshold=thr)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"nms_sweep differs from plain: {name}")

    # K 1000 and 2048: past the earlier one-block kernel's limit (512) and
    # past the shared-memory relation (1024)
    for k in (1, 7, 33, 64, 256, 300, 512, 1000, 1024, 1025, 2048):
        run_both(_random_boxes(rng, k, dev), 0.5, 0.5, f"K={k}")
        run_both(_random_boxes(rng, k, dev), 0.1, 0.2, f"K={k} IoU 0.1")
    cols = _random_boxes(rng, 256, dev)
    run_both(cols, 0.5, 2.0, "all below threshold")
    zero = _random_boxes(rng, 64, dev)
    zero[2][::3] = zero[0][::3]  # zero-width boxes
    run_both(zero, 0.5, 0.1, "zero-area boxes")
    same = [c.clone() for c in _random_boxes(rng, 64, dev)]
    for c in same[:4]:
        c[10:20] = c[10]  # identical boxes: IoU exactly 1
    run_both(same, 0.5, 0.0, "duplicate boxes")
    run_both(cols, 0.3, 0.2, "thresholds 0.3/0.2")
    third = float(np.float32(1 / 3))
    for thr in (third, float(np.nextafter(np.float32(third), np.float32(0))), 0.5,
                float(np.nextafter(np.float32(0.5), np.float32(0))), 0.0, -0.5):
        run_both(_nms_edge_boxes(dev), thr, 0.0, f"IoU on the rounding edge, threshold {thr!r}")

    k = 256
    main = _random_boxes(rng, k, dev)
    call = lambda: ep.nms_sweep(*main, iou_threshold=0.5, threshold=0.5)  # noqa: E731
    err = _max_abs_err(call(), ep.nms_sweep_plain(
        *main, iou_threshold=0.5, threshold=0.5))
    plain = lambda: ep.nms_sweep_plain(  # noqa: E731
        *main, iou_threshold=0.5, threshold=0.5)
    ms = _device_ms(call)
    floor_ms = _launch_floor_ms(dev)
    plain_ms = _device_ms(plain, per_graph=2, replays=5)
    eager_ms = _eager_ms(call)
    eager_plain_ms = _eager_ms(plain, iters=10, warmup=2)
    bound, by = _bound_ms(6 * k * 4, NMS_OPS_PER_PAIR * k * (k - 1) / 2)
    big = _random_boxes(rng, 2048, dev)
    big_ms = _device_ms(lambda: ep.nms_sweep(*big, iou_threshold=0.5, threshold=0.5), 5, 5)
    print(f"nms_sweep K={k} device ms/call (CUDA graph): kernel={ms:.6f} "
          f"plain={plain_ms:.6f} library=none; eager ms/call: kernel={eager_ms:.6f} "
          f"plain={eager_plain_ms:.6f}; bound_ms={bound:.8f} ({by}), launch floor "
          f"{floor_ms:.6f} (a one-element fill_ replayed the same way); K=2048 "
          f"kernel={big_ms:.6f}", flush=True)
    split = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "nms_phase_split.py")],
                           capture_output=True, text=True, timeout=300)
    if split.returncode != 0:
        raise AssertionError(f"nms_phase_split failed:\n{split.stderr[-3000:]}")
    print(split.stdout.rstrip(), flush=True)
    return {"name": "nms_sweep", "route": "cuda",
            "source": "nnstreamer_tpu_torch/ops/kernels/csrc/nms_sweep.cu",
            "replaces": "nnstreamer_tpu/ops/pallas/epilogue.py:130",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def _route_delta(before: dict, after: dict) -> dict:
    return {r: n - before.get(r, 0) for r, n in after.items() if n != before.get(r, 0)}


def check_segment_colorize(ep, dev, rng) -> dict:
    pal = torch.from_numpy(rng.integers(0, 256, (256, 4), dtype=np.uint8)).to(dev)

    def logits(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    # (name, input, pre_argmaxed, the route its launch must take)
    cases = [("(257, 257, 21), ragged last tile", logits(257, 257, 21), False, "bulk")]
    ties = torch.from_numpy(rng.integers(0, 4, (500, 21)).astype(np.float32)).to(dev)
    ties[0] = 2.0  # all-equal pixel
    cases.append(("ties and all-equal rows", ties, False, "bulk"))
    odd = logits(300, 21)
    odd[3, 5] = float("nan")
    odd[4, [0, 7]] = float("nan")
    odd[5] = float("-inf")
    odd[6, 2] = float("-inf")
    odd[7] = -1.0
    odd[7, [2, 9]] = torch.tensor([-0.0, 0.0], device=dev)  # zeros tie: class 2
    cases.append(("NaN, -inf and +0.0/-0.0 pixels", odd, False, "bulk"))
    for c in (1, 21, 150, 300, 4096, 12000):
        x = logits(67, c) if c >= 4096 else logits(129, 33, c)
        if c == 300:
            x[:64, :, 270] = 40.0  # argmax >= 256: the uint8 fill
        # pixels wider than a block stages (C > 11772) go by the row route
        cases.append((f"C={c}", x, False, "row" if c > 11772 else "bulk"))
        cases.append((f"C={c}, strided rows", logits(67, c + 3)[:, 1:c + 1], False, "row"))
    strided = logits(257, 257, 30)[..., 4:25]
    cases.append(("strided rows (257, 257, 30)[..., 4:25]", strided, False, "row"))
    cases.append(("base offset by one float",
                  logits(257 * 257 * 21 + 1)[1:].view(257, 257, 21), False, "bulk"))
    batched = logits(SEG_BATCH, 257, 257, 21)
    cases.append((f"batched ({SEG_BATCH}, 257, 257, 21)", batched, False, "bulk"))
    for i in range(SEG_BATCH):  # tensor_unbatch's slices: 4, 8, 12 bytes off 16
        cases.append((f"batched slice {i}", batched[i:i + 1][0], False, "bulk"))
    ids = torch.from_numpy(rng.integers(-300, 300, (257, 257)).astype(np.int32)).to(dev)
    cases.append(("int32 ids, negative and out of range", ids, True, "ids"))
    cases.append(("int32 ids offset by one", torch.from_numpy(rng.integers(
        -300, 300, 257 * 257 + 1).astype(np.int32)).to(dev)[1:], True, "ids"))
    cases.append(("float ids (truncated)", ids.to(torch.float32) * 0.37, True, "ids"))
    cases.append(("uint8 ids", ids.to(torch.uint8), True, "ids"))
    cases.append(("7 ids", ids.reshape(-1)[:7], True, "ids"))
    for name, x, pre, route in cases:
        before = dict(ep.segment_colorize.launches_by_route)
        got = ep.segment_colorize(x, pal, pre_argmaxed=pre)
        want = ep.segment_colorize_plain(x, pal, pre_argmaxed=pre)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"segment_colorize differs from plain: {name}")
        routes = _route_delta(before, ep.segment_colorize.launches_by_route)
        if routes != {route: 1}:
            raise AssertionError(f"segment_colorize {name}: routes {routes}, not {route}")
    # a palette one byte into its storage: the wrapper copies it to a word boundary
    buf = torch.zeros(256 * 4 + 1, dtype=torch.uint8, device=dev)
    buf[1:] = pal.reshape(-1)
    for name, x, pre, _ in (cases[0], cases[-5]):
        if not torch.equal(ep.segment_colorize(x, buf[1:].view(256, 4), pre_argmaxed=pre),
                           ep.segment_colorize_plain(x, pal, pre_argmaxed=pre)):
            raise AssertionError(f"segment_colorize differs from plain: {name}, palette "
                                 "off 4-byte alignment")
    print(f"segment_colorize: bit-exact on {len(cases)} cases, routes taken "
          f"{json.dumps(ep.segment_colorize.launches_by_route)}", flush=True)

    main = cases[0][1]
    h, w, c = main.shape
    err = _max_abs_err(ep.segment_colorize(main, pal).to(torch.int16),
                       ep.segment_colorize_plain(main, pal).to(torch.int16))
    calls = {"kernel": lambda: ep.segment_colorize(main, pal),
             "plain": lambda: ep.segment_colorize_plain(main, pal),
             "library": lambda: pal[main.argmax(dim=-1)]}
    dev_ms = {k: _device_ms(f) for k, f in calls.items()}
    eager = {k: _eager_ms(f) for k, f in calls.items()}
    p = h * w
    bound, by = _bound_ms(p * c * 4 + p * 4 + 256 * 4, p * c)
    strided_ms = _device_ms(lambda: ep.segment_colorize(strided, pal))
    print(f"segment_colorize logits ({h}*{w}, {c}) route bulk device ms/call (CUDA graph): "
          f"kernel={dev_ms['kernel']:.6f} plain={dev_ms['plain']:.6f} "
          f"library(pal[x.argmax(-1)], two calls)={dev_ms['library']:.6f}; "
          f"eager ms/call: kernel={eager['kernel']:.6f} plain={eager['plain']:.6f} "
          f"library={eager['library']:.6f}; bound_ms={bound:.8f} ({by}); share of "
          f"bound {bound / dev_ms['kernel']:.3f}; strided (257, 257, 30)[..., 4:25], route "
          f"row: kernel={strided_ms:.6f}", flush=True)
    id_calls = {"kernel": lambda: ep.segment_colorize(ids, pal, pre_argmaxed=True),
                "plain": lambda: ep.segment_colorize_plain(ids, pal, pre_argmaxed=True)}
    id_dev = {k: _device_ms(f) for k, f in id_calls.items()}
    floor_ms = _launch_floor_ms(dev)
    id_eager = {k: _eager_ms(f) for k, f in id_calls.items()}
    id_bound, id_by = _bound_ms(p * 4 + p * 4 + 256 * 4, p)
    # ids in range (each id modulo 256): there pal[ids] is the same function
    in_range = ids.remainder(256)
    if not torch.equal(ep.segment_colorize(in_range, pal, pre_argmaxed=True), pal[in_range]):
        raise AssertionError("segment_colorize ids in range differs from pal[ids]")
    in_range_ms = {"kernel": _device_ms(
        lambda: ep.segment_colorize(in_range, pal, pre_argmaxed=True)),
        "library": _device_ms(lambda: pal[in_range])}
    print(f"segment_colorize ids ({h}*{w},) int32 device ms/call (CUDA graph): "
          f"kernel={id_dev['kernel']:.6f} plain={id_dev['plain']:.6f}; eager "
          f"ms/call: kernel={id_eager['kernel']:.6f} plain={id_eager['plain']:.6f}; "
          f"bound_ms={id_bound:.8f} ({id_by}); launch floor {floor_ms:.6f}; ids in range "
          f"(modulo 256): kernel={in_range_ms['kernel']:.6f} "
          f"library(pal[ids])={in_range_ms['library']:.6f}", flush=True)
    return {"name": "segment_colorize", "route": "cuda",
            "source": "nnstreamer_tpu_torch/ops/kernels/csrc/segment_colorize.cu",
            "replaces": "nnstreamer_tpu/ops/pallas/epilogue.py:262",
            "max_abs_err": err, "ms": dev_ms["kernel"], "plain_ms": dev_ms["plain"],
            "bound_ms": bound, "bound_by": by, "library_ms": dev_ms["library"]}


def _within(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> bool:
    g, w = got.double(), want.double()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


def _flash_case(fa, q, k, v, causal: bool, name: str) -> float:
    """Kernel against plain, normalised and residual; returns the
    normalised output's max abs error. The residual accumulator is held
    as acc / l (it scales with l); m and l within float32 summation order.
    Prints the route both launches took."""
    rtol, atol = FLASH_TOL[q.dtype]
    before = dict(fa.flash_attention.launches_by_route)
    got = fa.flash_attention(q, k, v, causal)
    want = fa.flash_attention_plain(q, k, v, causal)
    acc, m, l_sum = fa.flash_attention(q, k, v, causal, return_residuals=True)
    racc, rm, rl = fa.flash_attention_plain(q, k, v, causal, return_residuals=True)
    torch.cuda.synchronize()
    routes = {r: n - before[r] for r, n in fa.flash_attention.launches_by_route.items()}
    want_route = fa._route(q, k, v)
    if routes[want_route] != 2 or sum(routes.values()) != 2:
        raise AssertionError(f"flash_attention {name}: routes {routes}, expected 2 {want_route}")
    if got.dtype != q.dtype or not _within(got, want, rtol, atol):
        raise AssertionError(f"flash_attention differs from plain: {name}, max abs err "
                             f"{_max_abs_err(got, want)}")
    if not (_within(acc / l_sum[..., None], racc / rl[..., None], rtol, atol)
            and _within(m, rm, 1e-5, 1e-5) and _within(l_sum, rl, 1e-5, 1e-5)):
        raise AssertionError(f"flash_attention residual mode differs from plain: {name}, "
                             f"max abs err acc {_max_abs_err(acc, racc)} m "
                             f"{_max_abs_err(m, rm)} l {_max_abs_err(l_sum, rl)}")
    err = _max_abs_err(got, want)
    print(f"  flash_attention {name} [{want_route}]: max abs err {err:.3e} (residual acc "
          f"{_max_abs_err(acc, racc):.3e}, m {_max_abs_err(m, rm):.3e}, l "
          f"{_max_abs_err(l_sum, rl):.3e})", flush=True)
    return err


def check_flash_attention(fa, dev, rng) -> dict:
    def qkv(shape, dtype):
        return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                .to(dev, dtype) for _ in range(3)]

    main_shape = (FLASH_B, 16, FLASH_T, 64)
    cases = [(main_shape, torch.bfloat16, True), (main_shape, torch.float32, True),
             ((FLASH_B, 16, 1000, 64), torch.float32, False),
             ((2, 3, 200, 16), torch.float32, True),
             ((2, 3, 200, 128), torch.bfloat16, False),
             ((1, 2, 70, 40), torch.float32, True),
             ((2, 3, 200, 96), torch.bfloat16, True),
             ((1, 1, 1, 1), torch.float32, True), ((2, 3, 300, 8), torch.float32, False)]
    # wide heads (D > 128: the tf32x3 route's 128-column chunks), both dtypes
    cases += [((1, 2, length, d), dt, causal)
              for d, length, causal in ((136, 130, True), (192, 200, False), (256, 129, True),
                                        (512, 70, False))
              for dt in (torch.float32, torch.bfloat16)]
    # the wgmma route: bf16 at D 64 and 128, ragged L, causal and full
    cases += [((2, 3, length, d), torch.bfloat16, causal)
              for d in (64, 128) for length in (70, 200, 1000) for causal in (True, False)]
    errs, inputs = {}, {}
    for shape, dt, causal in cases:
        name = f"{shape} {str(dt)[6:]} {'causal' if causal else 'full'}"
        inputs[(shape, dt)] = t = qkv(shape, dt)
        errs[name] = _flash_case(fa, *t, causal, name)
    # the causal LM's split-head views of its (B, T, 3D) projection: float32
    # (tf32x3) and bf16 at d_model 1024 (wgmma, which must take them uncopied)
    proj = torch.from_numpy(rng.standard_normal((2, 300, 3 * 256), dtype=np.float32)).to(dev)
    views = [z.reshape(2, 300, 4, 64).transpose(1, 2) for z in proj.split(256, -1)]
    got = fa.flash_attention(*views, causal=True)
    if not torch.equal(got, fa.flash_attention(*(z.contiguous() for z in views))):
        raise AssertionError("flash_attention on strided views != on contiguous copies")
    proj = torch.from_numpy(rng.standard_normal((2, 300, 3 * 1024), dtype=np.float32)) \
        .to(dev, torch.bfloat16)
    copies = fa.flash_attention.tma_copies
    views = [z.reshape(2, 300, 16, 64).transpose(1, 2) for z in proj.split(1024, -1)]
    got = fa.flash_attention(*views, causal=True)
    if fa.flash_attention.tma_copies != copies or not torch.equal(
            got, fa.flash_attention(*(z.contiguous() for z in views))):
        raise AssertionError("wgmma flash_attention copied the LM's split-head views or "
                             "differs on contiguous copies")
    # a view 2 bytes off 16-byte alignment takes the wrapper's contiguous copy
    flat = torch.from_numpy(rng.standard_normal(2 * 3 * 200 * 64 + 1, dtype=np.float32)) \
        .to(dev, torch.bfloat16)
    odd = flat[1:].view(2, 3, 200, 64)
    k, v = qkv((2, 3, 200, 64), torch.bfloat16)[:2]
    errs["unaligned q"] = _flash_case(fa, odd, k, v, True, "unaligned q (2, 3, 200, 64) bf16")
    if fa.flash_attention.tma_copies != copies + 2:
        raise AssertionError(f"unaligned q: {fa.flash_attention.tma_copies - copies} copies")

    lines, main = {}, None
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = inputs[(main_shape, dt)]
        calls = {"kernel": lambda: fa.flash_attention(q, k, v, True),
                 "plain": lambda: fa.flash_attention_plain(q, k, v, True),
                 "library": lambda: torch.nn.functional.scaled_dot_product_attention(
                     q, k, v, is_causal=True)}
        reps = {"kernel": (5, 10), "plain": (2, 3), "library": (10, 10)}
        ms = {n: _device_ms(f, *reps[n]) for n, f in calls.items()}
        b, h, length, d = main_shape
        pairs = b * h * length * (length + 1) // 2  # causal (query, key) pairs
        nbytes, ops = 4 * q.numel() * q.element_size(), 4 * d * pairs
        if dt == torch.float32:
            # the tf32x3 route: three tf32 products for each float32 one
            bound, by = _bound_ms(nbytes, 3 * ops, "tf32")
            cuda_cores, _ = _bound_ms(nbytes, ops, torch.float32)
            extra = f" (one float32 product on the CUDA cores: {cuda_cores:.8f})"
        else:
            bound, by = _bound_ms(nbytes, ops, dt)
            extra = ""
        print(f"flash_attention {main_shape} {str(dt)[6:]} causal [{fa._route(q, k, v)}] "
              f"device ms/call (CUDA graph): kernel={ms['kernel']:.6f} plain={ms['plain']:.6f} "
              f"library(scaled_dot_product_attention)={ms['library']:.6f}; "
              f"bound_ms={bound:.8f} ({by}){extra}", flush=True)
        lines[dt] = (ms, bound, by)
    ms, bound, by = lines[torch.bfloat16]
    main = f"{main_shape} bfloat16 causal"
    return {"name": "flash_attention", "route": "cuda",
            "source": "nnstreamer_tpu_torch/ops/kernels/csrc/flash_attention.cu",
            "replaces": "nnstreamer_tpu/ops/pallas/flash_attention.py:285",
            "max_abs_err": errs[main], "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": by, "library_ms": ms["library"]}


def _dgr_inputs(rng, rows: int, f: int, dev) -> tuple:
    y = rng.integers(-40000, 40000, (rows, f)).astype(np.int32)
    y[min(1, rows - 1)] = 0  # an all-zero row: scale 1
    xs = rng.uniform(1e-4, 1e-3, (rows, 1)).astype(np.float32)
    ws = rng.uniform(1e-4, 1e-3, (f,)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (y, xs, ws))


def check_dequant_gelu_requant(ep, dev, rng) -> dict:
    f_serve = 4 * LM_DIMS[1]
    for rows in (1, 3, 8, 33, 132, 512):
        # F 70000 overflows a block's registers: its columns are recomputed
        for f in (f_serve, 1000, 11, 70000):
            for dt in (torch.float32, torch.bfloat16):
                y, xs, ws = _dgr_inputs(rng, rows, f, dev)
                q, s = ep.dequant_gelu_requant(y, xs, ws, dt)
                pq, ps = ep.dequant_gelu_requant_plain(y, xs, ws, dt)
                torch.cuda.synchronize()
                if not (torch.equal(q, pq) and torch.equal(s, ps)) \
                        or float(s[min(1, rows - 1)]) != 1.0:
                    raise AssertionError(
                        f"dequant_gelu_requant differs from plain: R={rows} F={f} {dt}, "
                        f"{int((q != pq).sum())} codes, {int((s != ps).sum())} scales")
        print(f"dequant_gelu_requant R={rows}: bit-exact at F {f_serve}, 1000, 11, 70000, "
              f"float32 and bf16 (cluster {ep.dgr_cluster_size(rows, f_serve)} blocks a row "
              f"at F {f_serve})", flush=True)
    timed = {}
    for rows in (8, 512):
        for dt in (torch.float32, torch.bfloat16):
            y, xs, ws = _dgr_inputs(rng, rows, f_serve, dev)
            calls = {"kernel": lambda: ep.dequant_gelu_requant(y, xs, ws, dt),
                     "plain": lambda: ep.dequant_gelu_requant_plain(y, xs, ws, dt)}
            ms = {n: _device_ms(fn) for n, fn in calls.items()}
            bound, by = _bound_ms(rows * f_serve * 5 + rows * 8 + f_serve * 4,
                                  DGR_OPS_PER_ELEMENT * rows * f_serve)
            print(f"dequant_gelu_requant R={rows} F={f_serve} {str(dt)[6:]}: device "
                  f"ms/call (CUDA graph): kernel={ms['kernel']:.6f} plain={ms['plain']:.6f} "
                  f"library=none; bound_ms={bound:.8f} ({by})", flush=True)
            timed[(rows, dt)] = (ms, bound, by)
    # the serving engine's params are float32, so its MLPs run out_dtype
    # float32; a decode step has one row per slot
    ms, bound, by = timed[(LM_SLOTS, torch.float32)]
    return {"name": "dequant_gelu_requant", "route": "cuda",
            "source": "nnstreamer_tpu_torch/ops/kernels/csrc/dequant_gelu_requant.cu",
            "replaces": "nnstreamer_tpu/ops/pallas/epilogue.py:337",
            "max_abs_err": 0.0, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def check_mlp(ep, dev, rng) -> None:
    """One w8a8 MLP at the serving widths on the card: ``mlp_matmul`` (int8
    GEMMs around the kernel) bit for bit against the same composition with
    the plain epilogue."""
    from nnstreamer_tpu_torch.ops import int8 as i8

    d, f = LM_DIMS[1], 4 * LM_DIMS[1]
    w1 = i8.quantize_weight(torch.from_numpy(
        rng.standard_normal((d, f), dtype=np.float32) / np.float32(d ** 0.5)).to(dev))
    w2 = i8.quantize_weight(torch.from_numpy(
        rng.standard_normal((f, d), dtype=np.float32) / np.float32(f ** 0.5)).to(dev))
    for rows in (LM_SLOTS, 512):
        x = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)).to(dev)
        before = ep.dequant_gelu_requant.launches
        fused = i8.mlp_matmul(x, w1, w2)
        xq, xs = i8.quant_act(x)
        hq, hs = ep.dequant_gelu_requant_plain(i8._int_mm(xq, w1[i8.W8A8_TAG]), xs,
                                               w1["s"], x.dtype)
        plain = ((i8._int_mm(hq, w2[i8.W8A8_TAG]).to(torch.float32) * hs)
                 * w2["s"]).to(x.dtype)
        torch.cuda.synchronize()
        if ep.dequant_gelu_requant.launches != before + 1 or not torch.equal(fused, plain):
            raise AssertionError(f"w8a8 MLP on the card differs from its composition with "
                                 f"the plain epilogue at R={rows}")
    print(f"w8a8 MLP ({d} -> {f} -> {d}) at R={LM_SLOTS} and 512 on the card == its "
          f"composition with dequant_gelu_requant_plain, bit for bit", flush=True)


#: the prologue kernels' test sizes: 1, odd, a 224 frame and a 1080p frame
PRE_SIZES = [(1,), (7, 13), (129,), (224, 224, 3), (1080, 1920, 3)]
#: past 2^31 elements: the 64-bit indexing of normalize_u8's tiles
PRE_BIG_N = 2 ** 31 + 17


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, but any NaN for a NaN (the card's bf16 conversion and
    torch's give NaNs other payloads)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.uint8:
        return torch.equal(a, b)
    an, bn = a.float().isnan(), b.float().isnan()
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(an, bn) and torch.equal(a.view(bits)[~an], b.view(bits)[~bn])


def _pre_input(dtype: torch.dtype, n: int, dev, gen: torch.Generator) -> torch.Tensor:
    """n elements: uint8 codes, or floats in (-300, 300) led by NaN, +-inf,
    +-1e9, -0.0 and halfway values."""
    if dtype == torch.uint8:
        return torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev, generator=gen)
    x = torch.rand(n, device=dev, generator=gen) * 600 - 300
    lead = torch.tensor([np.nan, np.inf, -np.inf, 1e9, -1e9, -0.0, 0.5, 2.5], device=dev)[:n]
    x[:lead.numel()] = lead
    return x.to(dtype)


def _pre_boundaries(pp, src: torch.dtype, out: torch.dtype, dev, gen) -> list:
    """(name, input, output view or None) at every boundary of the tiling
    from ``src`` to ``out``: n 1, 15, 16, 17, a tile +-1 and the persistent
    grid's tiles +-1; views 1-15 bytes off 16-byte alignment (whole
    elements; the output aligned); and views whose output shares the
    input's element offset (the head goes by plain loads; launched with
    that output directly)."""
    t = pp.tiling(src, out, dev)
    tile, full = t["tile"], t["blocks"] * t["tile"]
    tag = f"{str(src)[6:]} -> {str(out)[6:]}"
    cases = [(f"{tag} n={n}", _pre_input(src, n, dev, gen), None)
             for n in sorted({1, 15, 16, 17, tile - 1, tile, tile + 1, full - 1, full, full + 1})]
    size = src.itemsize
    buf = _pre_input(src, 100_003 + 16, dev, gen)
    cases += [(f"{tag} view {off * size} bytes off", buf[off:off + 100_003], None)
              for off in range(1, 16 // size)]
    n = 3 * tile + 5
    for off in range(1, t["vector"]):
        y = torch.empty(n + off, dtype=out, device=dev)[off:]
        cases.append((f"{tag} input and output {off} elements off", buf[off:off + n], y))
    return cases


def check_normalize_u8(pp, dev, rng) -> dict:
    """normalize_u8 bit-exact against its plain version: every uint8 value
    at 1/127.5 and 1/255, to float32 and bf16, at each test size, a strided
    view (the wrapper copies it contiguous), a view off 16-byte alignment
    and float inputs with NaN and inf; each input type to each output type
    at every boundary of the kernel's tiling and off alignment; uint8 to
    bf16 past 2^31 elements; each launch counted once. Then timed at 224
    and 1080p beside torch.add(bias, x, alpha=scale, out=y), whose
    differing values are counted."""
    u8 = torch.arange(256, dtype=torch.uint8, device=dev)
    frames = {(256,): u8}
    frames.update({shape: torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
                   .to(dev) for shape in PRE_SIZES})
    cases = [(f"{tuple(x.shape)} scale {sc:.6g} bias {b} to {str(od)[6:]}", x, sc, b, od, None)
             for x in frames.values() for sc, b in ((1 / 127.5, -1.0), (1 / 255.0, 0.0))
             for od in (torch.float32, torch.bfloat16)]
    hd = frames[(1080, 1920, 3)]
    cases.append(("strided view (1080, 1600, 3)", hd[:, 100:1700], 1 / 127.5, -1.0,
                  torch.bfloat16, None))
    cases.append(("view 1 byte off alignment", hd.reshape(-1)[1:100001], 1 / 127.5, -1.0,
                  torch.float32, None))
    floats = torch.from_numpy(np.concatenate([
        [np.nan, np.inf, -np.inf, 1e9, -1e9, -0.0],
        rng.uniform(-300, 300, 4099)]).astype(np.float32)).to(dev)
    for src in (torch.float32, torch.bfloat16):
        for od in (torch.float32, torch.bfloat16):
            cases.append((f"{str(src)[6:]} input with NaN/inf to {str(od)[6:]}",
                           floats.to(src), 1 / 127.5, -1.0, od, None))
    gen = torch.Generator(device=dev).manual_seed(8)
    for src in (torch.uint8, torch.float32, torch.bfloat16):
        for od in (torch.float32, torch.bfloat16):
            cases += [(name, x, 1 / 127.5, -1.0, od, y)
                      for name, x, y in _pre_boundaries(pp, src, od, dev, gen)]
    for name, x, sc, b, od, y in cases:
        before = pp.normalize_u8.launches
        if y is None:
            got = pp.normalize_u8(x, sc, b, od)
        else:
            pp._launch_normalize(x, y, sc, b)
            got = y
        want = pp.normalize_u8_plain(x, sc, b, od)
        torch.cuda.synchronize()
        if pp.normalize_u8.launches != before + 1:
            raise AssertionError(f"normalize_u8 did not launch once: {name}")
        if not _same_bits(got, want):
            raise AssertionError(f"normalize_u8 differs from plain: {name}")
    big = torch.randint(0, 256, (PRE_BIG_N,), dtype=torch.uint8, device=dev, generator=gen)
    before = pp.normalize_u8.launches
    got = pp.normalize_u8(big)
    step = 2 ** 28
    for i in range(0, PRE_BIG_N, step):
        if not torch.equal(got[i:i + step], pp.normalize_u8_plain(big[i:i + step])):
            raise AssertionError(f"normalize_u8 differs from plain at n={PRE_BIG_N}, "
                                 f"elements {i} to {i + step}")
    if pp.normalize_u8.launches != before + 1:
        raise AssertionError(f"normalize_u8 did not launch once at n={PRE_BIG_N}")
    del big, got
    torch.cuda.empty_cache()
    print(f"normalize_u8: bit-exact with plain in {len(cases)} cases (all 256 uint8 "
          f"values, sizes {PRE_SIZES}, strided and unaligned views, float inputs, each type "
          f"pair at its tiling's boundaries and 1-15 bytes off) and uint8 -> bf16 at "
          f"n={PRE_BIG_N}, one launch each", flush=True)

    bias = torch.full((), -1.0, device=dev)

    def library(x, od):
        return torch.add(bias, x, alpha=1 / 127.5, out=torch.empty(x.shape, dtype=od,
                                                                   device=dev))

    differ = {od: (int((library(u8, od) != pp.normalize_u8_plain(u8, out_dtype=od)).sum()),
                   int((library(hd, od) != pp.normalize_u8_plain(hd, out_dtype=od)).sum()))
              for od in (torch.float32, torch.bfloat16)}
    print("normalize_u8 library torch.add(bias, x, alpha=1/127.5, out=y) differs from plain "
          "on " + ", ".join(f"{a} of 256 uint8 values and {b} of {hd.numel()} 1080p elements "
                            f"to {str(od)[6:]}" for od, (a, b) in differ.items()), flush=True)
    rows = {}
    for shape in ((224, 224, 3), (1080, 1920, 3)):
        x = frames[shape]
        cold, span = _rotating(lambda: torch.randint_like(x, 0, 256), x.numel())
        for od in (torch.bfloat16, torch.float32):
            y = torch.empty(x.shape, dtype=od, device=dev)
            calls = {"kernel": lambda: pp.normalize_u8(next(cold), out_dtype=od),
                     "plain": lambda: pp.normalize_u8_plain(next(cold), out_dtype=od),
                     "library": lambda: torch.add(bias, next(cold), alpha=1 / 127.5, out=y),
                     "kernel, L2-warm": lambda: pp.normalize_u8(x, out_dtype=od)}
            ms = {k: _device_ms(f) for k, f in calls.items()}
            n = x.numel()
            bound, by = _bound_ms(n * (1 + od.itemsize), 2 * n)
            print(f"normalize_u8 {shape} uint8 -> {str(od)[6:]} device ms/call (CUDA graph, "
                  f"inputs cycled over {span:.1f} MB): kernel={ms['kernel']:.7f} "
                  f"plain={ms['plain']:.7f} library(torch.add)={ms['library']:.7f}; one "
                  f"input replayed from L2: kernel={ms['kernel, L2-warm']:.7f}; "
                  f"bound_ms={bound:.8f} ({by}); kernel/bound={ms['kernel'] / bound:.2f}",
                  flush=True)
            rows[(shape, od)] = (ms, bound, by)
    ms, bound, by = rows[((1080, 1920, 3), torch.bfloat16)]
    err = _max_abs_err(pp.normalize_u8(hd), pp.normalize_u8_plain(hd))
    return {"name": "normalize_u8", "route": "cuda",
            "source": "nnstreamer_tpu_torch/ops/kernels/csrc/preprocess.cu",
            "replaces": "nnstreamer_tpu/ops/pallas/preprocess.py:82",
            "max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": by, "library_ms": ms["library"]}


def check_quantize_affine(pp, dev, rng) -> dict:
    """quantize_affine bit-exact against its plain version: NaN, +-inf,
    +-1e9, round-half-even ties and the value whose code the TPU body's
    reciprocal moves, at zero points 0 and 128 and three scales, every test
    size, a strided view and bf16 input; float32 and bf16 inputs at every
    boundary of the kernel's tiling and off alignment; each launch counted
    once. Then timed at 224 and 1080p against torch.quantize_per_tensor
    (the yardstick; its codes are counted, not assumed equal)."""
    scales = (1 / 127.5, 1 / 255.0, 0.02)
    special = [np.nan, np.inf, -np.inf, 1e9, -1e9, 0.9686274528503418, 0.0, -0.0]
    ties = [(k + 0.5) * np.float32(sc) for sc in scales for k in range(-20, 20)]
    tensors = [torch.tensor(np.array(special + ties, np.float32), device=dev)]
    tensors += [torch.from_numpy(rng.uniform(-1.2, 1.2, shape).astype(np.float32)).to(dev)
                for shape in PRE_SIZES]
    hd = tensors[-1]
    tensors += [hd[:, 7:1800], hd.to(torch.bfloat16)]
    n_cases = 0
    for x in tensors:
        for sc in scales:
            for zp in (0, 128):
                before = pp.quantize_affine.launches
                got = pp.quantize_affine(x, sc, zp)
                want = pp.quantize_affine_plain(x, sc, zp)
                torch.cuda.synchronize()
                n_cases += 1
                if pp.quantize_affine.launches != before + 1:
                    raise AssertionError(f"quantize_affine did not launch once: "
                                         f"{tuple(x.shape)} {x.dtype}")
                if not torch.equal(got, want):
                    raise AssertionError(f"quantize_affine differs from plain: "
                                         f"{tuple(x.shape)} {x.dtype} scale {sc} zp {zp}, "
                                         f"{int((got != want).sum())} codes")
    gen = torch.Generator(device=dev).manual_seed(9)
    for src in (torch.float32, torch.bfloat16):
        for name, x, q in _pre_boundaries(pp, src, torch.uint8, dev, gen):
            before = pp.quantize_affine.launches
            if q is None:
                got = pp.quantize_affine(x, 1 / 127.5, 128)
            else:
                pp._launch_quantize(x, q, 1 / 127.5, 128)
                got = q
            want = pp.quantize_affine_plain(x, 1 / 127.5, 128)
            torch.cuda.synchronize()
            n_cases += 1
            if pp.quantize_affine.launches != before + 1:
                raise AssertionError(f"quantize_affine did not launch once: {name}")
            if not torch.equal(got, want):
                raise AssertionError(f"quantize_affine differs from plain: {name}")
    if int(pp.quantize_affine(tensors[0], 1 / 127.5, 128)[5]) != 251:
        raise AssertionError("quantize_affine(0.9686274528503418) != 251")
    library = lambda x: torch.quantize_per_tensor(x, 1 / 127.5, 128, torch.quint8)  # noqa: E731
    differ = int((library(hd).int_repr() != pp.quantize_affine(hd, 1 / 127.5, 128)).sum())
    print(f"quantize_affine: bit-exact with plain in {n_cases} cases (NaN/inf/1e9, "
          f"ties, zero points 0 and 128, sizes {PRE_SIZES}, strided, bf16, each input type "
          f"at its tiling's boundaries and 4-14 bytes off), one launch each; "
          f"torch.quantize_per_tensor differs on {differ} of {hd.numel()} codes at "
          f"1080p, scale 1/127.5, zero point 128", flush=True)
    rows = {}
    for shape in ((224, 224, 3), (1080, 1920, 3)):
        x = tensors[1 + PRE_SIZES.index(shape)]
        cold, span = _rotating(lambda: torch.rand_like(x) * 2.4 - 1.2, x.numel() * 4)
        calls = {"kernel": lambda: pp.quantize_affine(next(cold), 1 / 127.5, 128),
                 "plain": lambda: pp.quantize_affine_plain(next(cold), 1 / 127.5, 128),
                 "library": lambda: library(next(cold)),
                 "kernel, L2-warm": lambda: pp.quantize_affine(x, 1 / 127.5, 128)}
        ms = {k: _device_ms(f) for k, f in calls.items()}
        n = x.numel()
        bound, by = _bound_ms(n * 5, 5 * n)
        print(f"quantize_affine {shape} float32 -> uint8 device ms/call (CUDA graph, inputs "
              f"cycled over {span:.1f} MB): kernel={ms['kernel']:.7f} plain={ms['plain']:.7f} "
              f"library(torch.quantize_per_tensor)={ms['library']:.7f}; one input "
              f"replayed from L2: kernel={ms['kernel, L2-warm']:.7f}; bound_ms={bound:.8f} "
              f"({by}); kernel/bound={ms['kernel'] / bound:.2f}", flush=True)
        rows[shape] = (ms, bound, by)
    ms, bound, by = rows[(1080, 1920, 3)]
    return {"name": "quantize_affine", "route": "cuda",
            "source": "nnstreamer_tpu_torch/ops/kernels/csrc/preprocess.cu",
            "replaces": "nnstreamer_tpu/ops/pallas/preprocess.py:131",
            "max_abs_err": 0.0, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": by, "library_ms": ms["library"]}


def check_preprocess_repair() -> None:
    """The models' uint8 preprocess over all 256 values: on the card
    bit-equal to the CPU (it divides by a tensor), where the form it
    replaced (division by a Python scalar: a reciprocal multiply on CUDA)
    is not."""
    from nnstreamer_tpu_torch.models.mobilenet_v2 import preprocess_uint8

    u8 = torch.arange(256, dtype=torch.uint8)
    cpu = preprocess_uint8(u8)
    card = preprocess_uint8(u8.cuda()).cpu()
    if not torch.equal(card, cpu):
        raise AssertionError(f"preprocess_uint8 on the card differs from the CPU on "
                             f"{int((card != cpu).sum())} of 256 values")
    old = (u8.cuda().to(torch.float32) / 127.5 - 1.0).cpu()
    print(f"preprocess_uint8: card == CPU on all 256 uint8 values; the replaced "
          f"scalar-division form differs on {int((old != cpu).sum())} of them "
          f"({int((old.bfloat16() != cpu.bfloat16()).sum())} after bf16)", flush=True)


def _post_inputs(m: int, seed: int, count: bool = True) -> tuple:
    """tflite detection-postprocess tensors: boxes [ymin, xmin, ymax, xmax],
    class ids, scores with tied groups and duplicate boxes, and a
    valid-row count below m."""
    rng = np.random.default_rng(seed)
    y0, x0 = rng.uniform(0, 0.7, (2, m)).astype(np.float32)
    h, w = rng.uniform(0.05, 0.3, (2, m)).astype(np.float32)
    boxes = np.stack([y0, x0, y0 + h, x0 + w], axis=1)[None]
    classes = rng.integers(0, 9, (1, m)).astype(np.float32)
    scores = rng.uniform(0.2, 1.0, (1, m)).astype(np.float32)
    scores[0, 5:9] = scores[0, 5]
    boxes[0, 20:23] = boxes[0, 19]
    scores[0, 19:23] = 0.9
    out = (boxes, classes, scores, np.array([m - 7], np.float32))
    return out if count else out[:3]


def _ov_rows(m: int, seed: int) -> tuple:
    """OpenVINO rows [image_id, label, conf, x0, y0, x1, y1]; negative
    image ids end the list."""
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(0, 0.7, (2, m)).astype(np.float32)
    w, h = rng.uniform(0.05, 0.3, (2, m)).astype(np.float32)
    rows = np.stack([np.zeros(m, np.float32),
                     rng.integers(1, 4, m).astype(np.float32),
                     rng.uniform(0.2, 1.0, m).astype(np.float32),
                     x0, y0, x0 + w, y0 + h], axis=1)
    rows[m - 5:, 0] = -1.0
    rows[10:14, 2] = rows[10, 2]
    return (rows[None, None],)


def check_box_modes(ep) -> None:
    """bounding_box's device reduce for the postprocess and OpenVINO modes
    on CUDA tensors (stable top-256, then nms_sweep on the card): rows
    equal to the same reduce on the CPU, and kept rows equal to the host
    decode of the same tensors."""
    from nnstreamer_tpu_torch.core.buffer import Buffer
    from nnstreamer_tpu_torch.decoders.bounding_box import BoundingBox
    from nnstreamer_tpu_torch.decoders.util import nms

    cases = [("mobilenet-ssd-postprocess", _post_inputs(100, 1)),
             ("mobilenet-ssd-postprocess", _post_inputs(100, 2, count=False)),
             ("tf-ssd", _post_inputs(300, 3)),
             ("tflite-ssd-postprocess", _post_inputs(40, 4)),
             ("ov-person-detection", _ov_rows(200, 5)),
             ("ov-face-detection", _ov_rows(300, 6))]
    kept_counts = []
    for mode, inputs in cases:
        dec = BoundingBox()
        dec.init({1: mode, 3: "0.45:0.4", 4: "300:300", 5: "300:300"})
        reduce, _ = dec._make_reduce()
        before = ep.nms_sweep.launches
        with torch.inference_mode():
            rows = reduce(*(torch.from_numpy(a).cuda() for a in inputs))
            rows = rows.cpu().numpy()
            cpu_rows = reduce(*(torch.from_numpy(a) for a in inputs)).numpy()
        if ep.nms_sweep.launches != before + 1:
            raise AssertionError(f"{mode}: nms_sweep not launched on the card")
        if not np.array_equal(rows, cpu_rows):
            raise AssertionError(f"{mode}: card rows differ from the CPU reduce")
        host_buf = Buffer.of(*inputs)
        cands = dec._objects_ov(host_buf) if mode.startswith("ov-") \
            else dec._objects_postprocess(host_buf)
        if len(cands) > dec.PRE_NMS_TOPK:
            raise AssertionError(f"{mode}: {len(cands)} candidates past top-K")
        kept = rows[rows[:, 4] >= dec.threshold]
        host = nms(cands, dec.iou_threshold)
        if len(kept) < 5 or not np.array_equal(kept, host):
            raise AssertionError(f"{mode}: device kept {len(kept)} rows, host "
                                 f"decode {len(host)}, or they differ")
        kept_counts.append(len(kept))
    print(f"bounding_box postprocess/ov device reduce on the card == CPU reduce "
          f"and == host decode: {len(cases)} cases, kept rows {kept_counts}",
          flush=True)


@contextlib.contextmanager
def _epilogue_inputs(decoder_cls):
    """Record the first model output the filter's fused invoke hands to a
    ``decoder_cls`` epilogue, one per frame, for pipelines fused inside."""
    seen = []
    make = decoder_cls.epilogue_reduce

    def recording_epilogue_reduce(self):
        fn = make(self)
        if fn is None:
            return None

        def recorded(outs):
            seen.append(outs[0])
            return fn(outs)

        return recorded

    decoder_cls.epilogue_reduce = recording_epilogue_reduce
    try:
        yield seen
    finally:
        decoder_cls.epilogue_reduce = make


@contextlib.contextmanager
def _decoder_inputs(cls=None):
    """Record every buffer that reaches a tensor_decoder (or an element of
    class ``cls``) while inside."""
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder

    cls = cls or TensorDecoder
    seen = []
    chain = cls.chain

    def watching_chain(self, pad, buf):
        seen.append(buf)
        return chain(self, pad, buf)

    cls.chain = watching_chain
    try:
        yield seen
    finally:
        cls.chain = chain


def _devices(bufs) -> set:
    return {str(m.device().device) for b in bufs for m in b.memories}


def _steady_fps(arrivals) -> float:
    return (len(arrivals) - 1) / (arrivals[-1] - arrivals[0])


def _identical(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, dtype and bytes (NaN payloads included): a replayed
    graph runs the eager run's kernels on the same inputs."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8))


def _all_identical(xs, ys) -> bool:
    return len(xs) == len(ys) and all(_identical(x, y) for x, y in zip(xs, ys))


def _memories(bufs) -> list:
    """Every memory of every buffer, as device tensors, in order."""
    return [m.device() for b in bufs for m in b.memories]


@contextlib.contextmanager
def _mode(eager: bool):
    """The run's mode: CUDA graphs (the port's default), or every graph
    disabled (``graphs.disabled()``, the eager reference). Resets the graph
    counts just before."""
    from nnstreamer_tpu_torch.core import graphs

    graphs.reset_stats()
    with graphs.disabled() if eager else contextlib.nullcontext():
        yield


#: per path: graph captures, replays, eager warm-ups, the distinct
#: signatures the path feeds, both rates and the memory reserved after it
GRAPH_PATHS = {}
#: the stream paths' rates, round trips and host copies
LOOP_STATS = {}


def _record_graphs(path: str, distinct: int, unit: str, rate: float,
                   eager_rate: float, st: dict) -> None:
    """Check and print one path's graphs: it must have replayed, and
    captured at least one and at most ``distinct`` signatures (the distinct
    shapes its inputs have), each after one eager warm-up."""
    if st["replays"] < 1 or not 1 <= st["captures"] <= distinct \
            or st["warmups"] != st["captures"]:
        raise AssertionError(f"{path}: graphs {st} for {distinct} distinct "
                             "signatures")
    reserved = torch.cuda.memory_reserved() / 2 ** 20
    GRAPH_PATHS[path] = dict(st, distinct=distinct, unit=unit, graphs=rate,
                             eager=eager_rate, reserved_mib=reserved)
    print(f"graphs {path}: {st['captures']} captured (its inputs have at most "
          f"{distinct} signatures), {st['replays']} replays, {st['warmups']} eager "
          f"warm-ups; "
          f"{unit} graphs {rate:.2f}, eager {eager_rate:.2f}; memory reserved "
          f"{reserved:.1f} MiB", flush=True)


def _seg_pipeline(spec, frames, batch=1):
    from nnstreamer_tpu_torch.graph import Pipeline

    p = Pipeline("seg")
    chain = [p.add_new("videotestsrc", width=257, height=257, pattern="random",
                       num_buffers=frames),
             p.add_new("tensor_converter")]
    if batch > 1:
        chain.append(p.add_new("tensor_batch", max_batch=batch, budget_ms=1000.0))
    chain.append(p.add_new("tensor_filter", framework="xla-tpu", model=spec))
    if batch > 1:
        chain.append(p.add_new("tensor_unbatch"))
    chain.append(p.add_new("tensor_decoder", mode="image_segment",
                           option1="tflite-deeplab"))
    arrivals = []
    sink = p.add_new("tensor_sink", store=True,
                     new_data=lambda b: arrivals.append(time.perf_counter()))
    chain.append(sink)
    Pipeline.link(*chain)
    return p, chain, sink, arrivals


def run_segmentation(ep) -> int:
    """The fused DeepLab path with graphs, then eagerly on the same frames:
    the eager run records the logits its invoke hands the epilogue, each
    eager canvas must be the host decode of them, and each graph canvas
    the eager one, bit for bit."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.core.buffer import Buffer, TensorMemory
    from nnstreamer_tpu_torch.decoders.image_segment import ImageSegment

    t0 = time.perf_counter()
    _seg_pipeline(SEG_SPEC, 4)[0].run(timeout=600)
    torch.cuda.synchronize()
    print(f"deeplab warm-up (model build + 4 frames): {time.perf_counter() - t0:.3f} s",
          flush=True)
    runs = {}
    for eager in (False, True):
        p, _, sink, arrivals = _seg_pipeline(SEG_SPEC, SEG_FRAMES)
        # a replay runs no Python: only the eager run shows the epilogue
        # its inputs
        recording = _epilogue_inputs(ImageSegment) if eager \
            else contextlib.nullcontext([])
        with _decoder_inputs() as seen, recording as logits, _mode(eager):
            ep.segment_colorize.launches = 0
            before = dict(ep.segment_colorize.launches_by_route)
            t0 = time.perf_counter()
            p.run(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ep.segment_colorize.launches
            routes = _route_delta(before, ep.segment_colorize.launches_by_route)
            st = graphs.stats()
        mode = "eager" if eager else "graphs"
        if routes != {"bulk": SEG_FRAMES}:
            raise AssertionError(f"fused deeplab colorize routes {routes} ({mode}), "
                                 "not all bulk")
        if p._epilogue_count != 1:
            raise AssertionError(f"segmentation decoder not fused: {p._epilogue_count}")
        if sink.num_buffers != SEG_FRAMES or launches != SEG_FRAMES \
                or len(seen) != SEG_FRAMES:
            raise AssertionError(f"{mode}: {sink.num_buffers} canvases, {launches} "
                                 f"launches, {len(seen)} decoder inputs for "
                                 f"{SEG_FRAMES} frames")
        runs[eager] = dict(sink=sink, seen=seen, logits=logits, wall=wall,
                           fps=_steady_fps(arrivals), launches=launches,
                           routes=routes, st=st)
    eager = runs[True]
    if len(eager["logits"]) != SEG_FRAMES:
        raise AssertionError(f"{len(eager['logits'])} epilogue calls for {SEG_FRAMES} "
                             "eager frames")
    devices = _devices(runs[False]["seen"]) | {str(x.device) for x in eager["logits"]}
    if any(not d.startswith("cuda") for d in devices):
        raise AssertionError(f"filter output left the card: {devices}")
    # every eager frame: the canvas vs the host decode of the logits the
    # fused invoke handed its epilogue
    host_dec = ImageSegment()
    host_dec.init({1: "tflite-deeplab"})
    colours = []
    for i, (x, out) in enumerate(zip(eager["logits"], eager["sink"].buffers)):
        if x.shape != (1, 257, 257, 21) or x.dtype != torch.float32 \
                or not torch.isfinite(x).all():
            raise AssertionError(f"frame {i}: logits {tuple(x.shape)} {x.dtype} "
                                 "or not finite")
        canvas = out.memories[0].host()
        want = host_dec.decode(Buffer([TensorMemory(x.cpu().numpy())]), None)
        if canvas.shape != (257, 257, 4) or canvas.dtype != np.uint8 \
                or not np.array_equal(canvas, want.memories[0].host()):
            raise AssertionError(f"frame {i}: fused canvas differs from the host "
                                 "decode of its logits")
        colours.append(len(np.unique(canvas.reshape(-1, 4), axis=0)))
    if min(colours) < 2:
        raise AssertionError(f"a canvas holds one class only: {colours}")
    # every graph frame: the eager frame's device canvas and sink canvas
    graph = runs[False]
    if not _all_identical(_memories(graph["seen"]), _memories(eager["seen"])) \
            or not all(np.array_equal(a.memories[0].host(), b.memories[0].host())
                       for a, b in zip(graph["sink"].buffers, eager["sink"].buffers)):
        raise AssertionError("fused deeplab: a replayed canvas differs from the eager one")
    print(f"deeplab_v3 257x257 21 classes (fused colorize): {SEG_FRAMES} frames in "
          f"{graph['wall']:.3f} s, steady fps={graph['fps']:.2f} (eager "
          f"{eager['fps']:.2f}), launches={graph['launches']} (by route "
          f"{json.dumps(graph['routes'])}; eager the same), output devices="
          f"{sorted(devices)}; every canvas == host decode of the logits the eager "
          f"fused invoke produced, bit for bit (classes per canvas {min(colours)}.."
          f"{max(colours)}), every replayed canvas == the eager one", flush=True)
    _record_graphs("deeplab fused", 1, "fps", graph["fps"], eager["fps"], graph["st"])
    return graph["launches"]


def run_batched_segmentation(ep) -> int:
    """The batched DeepLab path with graphs, then eagerly: the filter's
    graph per group, the decoder colorizing each unbatched slice; every
    replayed slice and canvas equal to the eager one."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.core.buffer import Buffer, TensorMemory
    from nnstreamer_tpu_torch.decoders.image_segment import ImageSegment

    spec = f"{SEG_SPEC}&batch={SEG_BATCH}"
    t0 = time.perf_counter()
    _seg_pipeline(spec, SEG_BATCH, batch=SEG_BATCH)[0].run(timeout=600)
    torch.cuda.synchronize()
    print(f"batched deeplab warm-up (model build + 1 group): "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    runs = {}
    for eager in (False, True):
        # the decoder keeps its default async_depth=0
        p, chain, sink, arrivals = _seg_pipeline(spec, SEG_BATCH_FRAMES,
                                                 batch=SEG_BATCH)
        with _decoder_inputs() as seen, _mode(eager):
            ep.segment_colorize.launches = 0
            before = dict(ep.segment_colorize.launches_by_route)
            t0 = time.perf_counter()
            p.run(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ep.segment_colorize.launches
            routes = _route_delta(before, ep.segment_colorize.launches_by_route)
            st = graphs.stats()
        mode = "eager" if eager else "graphs"
        if routes != {"bulk": SEG_BATCH_FRAMES}:
            raise AssertionError(f"batched deeplab colorize routes {routes} ({mode}), "
                                 "not all bulk")
        batcher = chain[2]
        if p._epilogue_count != 0:
            raise AssertionError("fused across tensor_unbatch")
        if sink.num_buffers != SEG_BATCH_FRAMES or launches != SEG_BATCH_FRAMES:
            raise AssertionError(f"{mode}: {sink.num_buffers} canvases, {launches} "
                                 f"launches for {SEG_BATCH_FRAMES} frames")
        groups = batcher.groups_emitted
        if groups != -(-SEG_BATCH_FRAMES // SEG_BATCH) or len(seen) != SEG_BATCH_FRAMES:
            raise AssertionError(f"{mode}: {groups} groups, {len(seen)} slices")
        rate = sink.buffers[1].pts - sink.buffers[0].pts
        if [b.pts for b in sink.buffers] != [i * rate for i in range(SEG_BATCH_FRAMES)]:
            raise AssertionError(f"{mode}: canvases out of order or pts lost")
        runs[eager] = dict(sink=sink, seen=seen, wall=wall, fps=_steady_fps(arrivals),
                           launches=launches, routes=routes, st=st, groups=groups,
                           grouped=batcher.frames_grouped)
    graph, eager = runs[False], runs[True]
    devices = _devices(graph["seen"])
    if any(not d.startswith("cuda") for d in devices):
        raise AssertionError(f"unbatched slices left the card: {devices}")
    host_dec = ImageSegment()
    host_dec.init({1: "tflite-deeplab"})
    for i, (buf, out) in enumerate(zip(graph["seen"], graph["sink"].buffers)):
        want = host_dec.decode(Buffer([TensorMemory(buf.memories[0].host())]), None)
        if not np.array_equal(out.memories[0].host(), want.memories[0].host()):
            raise AssertionError(f"batched canvas {i} differs from its slice's "
                                 "host decode")
    if not _all_identical(_memories(graph["seen"]), _memories(eager["seen"])) \
            or not all(np.array_equal(a.memories[0].host(), b.memories[0].host())
                       for a, b in zip(graph["sink"].buffers, eager["sink"].buffers)):
        raise AssertionError("batched deeplab: a replayed slice or canvas differs "
                             "from the eager one")
    print(f"deeplab_v3 257x257 batched (tensor_batch max_batch={SEG_BATCH} ... "
          f"tensor_unbatch, colorize on the decoder): {SEG_BATCH_FRAMES} frames in "
          f"{graph['wall']:.3f} s, steady fps={graph['fps']:.2f} (eager "
          f"{eager['fps']:.2f}), groups emitted={graph['groups']} (frames grouped "
          f"{graph['grouped']}), launches={graph['launches']} (by route "
          f"{json.dumps(graph['routes'])}; eager the same); every canvas == host "
          f"decode of its slice, every replayed slice and canvas == the eager one",
          flush=True)
    _record_graphs("deeplab batched", 1, "fps", graph["fps"], eager["fps"], graph["st"])
    return graph["launches"]


def run_pose() -> None:
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.decoders.pose import PoseEstimation, keypoint_rows
    from nnstreamer_tpu_torch.graph import Pipeline

    opts = dict(option1="640:480", option2="257:257", option4="heatmap-offset")

    def build(frames):
        p = Pipeline("pose")
        src = p.add_new("videotestsrc", width=257, height=257, pattern="random",
                        num_buffers=frames)
        conv = p.add_new("tensor_converter")
        filt = p.add_new("tensor_filter", framework="xla-tpu", model=POSE_SPEC)
        dec = p.add_new("tensor_decoder", mode="pose_estimation", async_depth=2,
                        **opts)
        arrivals = []
        sink = p.add_new("tensor_sink", store=True,
                         new_data=lambda b: arrivals.append(time.perf_counter()))
        Pipeline.link(src, conv, filt, dec, sink)
        return p, sink, arrivals

    build(4)[0].run(timeout=600)
    runs = {}
    for eager in (False, True):
        p, sink, arrivals = build(POSE_FRAMES)
        with _decoder_inputs() as seen, _mode(eager):
            t0 = time.perf_counter()
            p.run(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = graphs.stats()
        if sink.num_buffers != POSE_FRAMES or len(seen) != POSE_FRAMES:
            raise AssertionError(f"{sink.num_buffers} pose frames of {POSE_FRAMES}")
        runs[eager] = (sink, seen, wall, _steady_fps(arrivals), st)
    sink, seen, wall, fps, st = runs[False]
    if not _all_identical(_memories(seen), _memories(runs[True][1])) \
            or [b.meta["keypoints"] for b in sink.buffers] \
            != [b.meta["keypoints"] for b in runs[True][0].buffers]:
        raise AssertionError("posenet: replayed heatmaps, offsets or keypoints differ "
                             "from the eager ones")
    devices = _devices(seen)
    if any(not d.startswith("cuda") for d in devices):
        raise AssertionError(f"pose outputs left the card: {devices}")
    host = PoseEstimation()
    host.init({1: opts["option1"], 2: opts["option2"], 4: opts["option4"]})
    for i, (buf, out) in enumerate(zip(seen, sink.buffers)):
        shapes = [tuple(m.shape) for m in buf.memories]
        if shapes != [(1, 17, 17, 17), (1, 17, 17, 34)]:
            raise AssertionError(f"posenet outputs {shapes}")
        kp = out.meta["keypoints"]
        if kp != host.keypoints(buf) or not np.isfinite(kp).all():
            raise AssertionError(f"frame {i}: device keypoints != host keypoints")
    # ties: torch.argmax on the card must return the first maximal cell,
    # as jnp.argmax and np.argmax do
    hm = torch.zeros((1, 17, 17, 17), device="cuda")
    hm[0, 3, [2, 9], 5] = 4.0
    off = torch.zeros((1, 17, 17, 34), device="cuda")
    rows = keypoint_rows(hm, off).cpu()
    if tuple(rows[0, :2].tolist()) != (0.0, 0.0) \
            or tuple(rows[5, :2].tolist()) != (2.0, 3.0):
        raise AssertionError(f"pose argmax tie-break on the card: {rows[:, :2]}")
    print(f"posenet 257 pose_estimation heatmap-offset: {POSE_FRAMES} frames in "
          f"{wall:.3f} s, steady fps={fps:.2f} (eager {runs[True][3]:.2f}); device "
          f"reduce keypoints == host keypoints() on every frame; ties take the first "
          f"cell; replayed heatmaps, offsets and keypoints == the eager ones",
          flush=True)
    _record_graphs("posenet", 1, "fps", fps, runs[True][3], st)


def run_detection(ep, tmp: str) -> dict:
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.decoders import bounding_box as bb
    from nnstreamer_tpu_torch.decoders.util import nms
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors

    priors = os.path.join(tmp, "box_priors.txt")
    n_anchors = write_box_priors(priors, size=300)
    labels = os.path.join(tmp, "coco.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"c{i}" for i in range(91)))
    opts = dict(option1="mobilenet-ssd", option2=labels, option3=priors,
                option4="300:300", option5="300:300")

    def build(frames):
        p = Pipeline("ssd")
        src = p.add_new("videotestsrc", width=300, height=300,
                        pattern="random", num_buffers=frames)
        conv = p.add_new("tensor_converter")
        filt = p.add_new("tensor_filter", framework="xla-tpu", model=SSD_SPEC)
        dec = p.add_new("tensor_decoder", mode="bounding_box", **opts)
        arrivals = []
        sink = p.add_new("tensor_sink", store=True,
                         new_data=lambda b: arrivals.append(time.perf_counter()))
        Pipeline.link(src, conv, filt, dec, sink)
        return p, filt, sink, arrivals

    t0 = time.perf_counter()
    warm, _, _, _ = build(4)
    warm.run(timeout=600)
    torch.cuda.synchronize()
    print(f"ssd warm-up (model build + 4 frames): {time.perf_counter() - t0:.3f} s",
          flush=True)

    # the decoder's input is the filter's output (the fused reduce's rows):
    # record where it lives; graphs, then eagerly on the same frames
    runs = {}
    for eager in (False, True):
        p, filt, sink, arrivals = build(SSD_FRAMES)
        with _decoder_inputs() as seen, _mode(eager):
            ep.class_reduce.launches = 0
            ep.nms_sweep.launches = 0
            t0 = time.perf_counter()
            p.run(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"class_reduce": ep.class_reduce.launches,
                        "nms_sweep": ep.nms_sweep.launches}
            st = graphs.stats()
        devices = _devices(seen)
        if p._epilogue_count != 1:
            raise AssertionError(f"decoder not fused: {p._epilogue_count}")
        if sink.num_buffers != SSD_FRAMES or len(seen) != SSD_FRAMES:
            raise AssertionError(f"{sink.num_buffers} of {SSD_FRAMES} frames out")
        for name, n in launches.items():
            if n != SSD_FRAMES:
                raise AssertionError(f"{name} launched {n} times for {SSD_FRAMES} "
                                     f"frames ({'eager' if eager else 'graphs'})")
        if not devices or any(not d.startswith("cuda") for d in devices):
            raise AssertionError(f"filter output left the card: {devices}")
        runs[eager] = (sink, seen, wall, _steady_fps(arrivals), launches, st, devices)
    sink, seen, wall, steady, launches, st, devices = runs[False]
    counts = [len(b.meta["detections"]) for b in sink.buffers]
    if sum(counts) == 0:
        raise AssertionError("no detections")
    if not _all_identical(_memories(seen), _memories(runs[True][1])) \
            or [b.meta["detections"] for b in sink.buffers] \
            != [b.meta["detections"] for b in runs[True][0].buffers]:
        raise AssertionError("ssd: replayed reduce rows or detections differ from "
                             "the eager ones")
    print(f"ssd_mobilenet_v2 300x300 91 classes: {SSD_FRAMES} frames in "
          f"{wall:.3f} s, steady fps={steady:.2f} (eager {runs[True][3]:.2f}), "
          f"detections/frame min={min(counts)} max={max(counts)}, anchors={n_anchors}, "
          f"launches={launches} (eager the same), output devices={sorted(devices)}; "
          f"every replayed (256, 6) reduce row block and detection == the eager one",
          flush=True)
    _record_graphs("ssd", 1, "fps", steady, runs[True][3], st)

    # one frame: fused device reduce (kernels) vs the host decode path,
    # through the filter's own (memoized) bundle
    from nnstreamer_tpu_torch.core.buffer import Buffer
    from nnstreamer_tpu_torch.models.zoo import get_model
    bundle = get_model(SSD_SPEC, device="cuda")
    frame = np.random.default_rng(7).integers(0, 256, (1, 300, 300, 3),
                                              dtype=np.uint8)
    with torch.inference_mode():
        locs, raw = bundle.fn()(torch.from_numpy(frame).cuda())
    dec = bb.BoundingBox()
    dec.init({1: opts["option1"], 2: labels, 3: priors, 4: "300:300",
              5: "300:300"})
    with torch.inference_mode():
        rows = dec.epilogue_reduce()((locs, raw)).cpu().numpy()
    dev_objs = rows[rows[:, 4] >= dec.threshold]
    host = Buffer.of(locs.cpu().numpy(), raw.cpu().numpy())
    host_objs = nms(dec._objects_mobilenet_ssd(host), dec.iou_threshold)
    if len(dev_objs) != len(host_objs) or len(dev_objs) == 0:
        raise AssertionError(f"device reduce kept {len(dev_objs)} boxes, host "
                             f"decode {len(host_objs)}")
    np.testing.assert_array_equal(dev_objs[:, 5], host_objs[:, 5])
    np.testing.assert_allclose(dev_objs[:, :5], host_objs[:, :5], rtol=1e-4,
                               atol=1e-5)
    print(f"ssd fused device reduce == host decode on one frame: "
          f"{len(dev_objs)} boxes", flush=True)
    return launches


def run_classification(tmp: str) -> None:
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.core.types import Caps
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.models.zoo import get_model

    labels = os.path.join(tmp, "imagenet.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"l{i}" for i in range(1001)))
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
              for _ in range(CLS_FRAMES)]
    caps = Caps("video/x-raw", {"format": "RGB", "width": 224, "height": 224,
                                "framerate": Fraction(30)})
    runs = {}
    for eager in (False, True):
        p = Pipeline("cls")
        src = p.add_new("appsrc", caps=caps, data=frames)
        conv = p.add_new("tensor_converter")
        filt = p.add_new("tensor_filter", framework="xla-tpu", model=CLS_SPEC)
        dec = p.add_new("tensor_decoder", mode="image_labeling", option1=labels)
        arrivals = []
        sink = p.add_new("tensor_sink", store=True,
                         new_data=lambda b, a=arrivals: a.append(time.perf_counter()))
        Pipeline.link(src, conv, filt, dec, sink)
        with _decoder_inputs() as seen, _mode(eager):
            t0 = time.perf_counter()
            p.run(timeout=600)
            wall = time.perf_counter() - t0
            st = graphs.stats()
        if sink.num_buffers != CLS_FRAMES:
            raise AssertionError(f"{sink.num_buffers} of {CLS_FRAMES} labels out")
        runs[eager] = (sink, seen, wall, _steady_fps(arrivals), st)
    sink, seen, wall, fps, st = runs[False]
    bundle = get_model(CLS_SPEC, device="cuda")
    for frame, buf in zip(frames, sink.buffers):
        with torch.inference_mode():
            logits = bundle.fn()(torch.from_numpy(frame[None]).cuda())
        want = int(logits.argmax(dim=-1)[0])
        if buf.meta["label_index"] != want:
            raise AssertionError(f"label {buf.meta['label_index']} != argmax {want}")
    if not _all_identical(_memories(seen), _memories(runs[True][1])) \
            or [b.meta["label_index"] for b in sink.buffers] \
            != [b.meta["label_index"] for b in runs[True][0].buffers]:
        raise AssertionError("classification: replayed logits or labels differ from "
                             "the eager ones")
    print(f"mobilenet_v2 224 image_labeling: {CLS_FRAMES} frames in {wall:.3f} s "
          f"(incl. model build), labels {[b.meta['label'] for b in sink.buffers]}; "
          f"replayed logits == the eager ones", flush=True)
    _record_graphs("classification", 1, "fps", fps, runs[True][3], st)


def run_headline(tmp: str, counters) -> dict:
    """The README's headline pipeline at full width: through the CLI as a
    user runs it, then parsed twice (transform fused into the filter's
    invoke, and not) with the frames' logits recorded at the decoder, each
    with graphs (in turns) and eagerly; then SingleShot on one frame.
    Returns each run's kernel launches."""
    from nnstreamer_tpu_torch.cli import main as cli
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.graph import Pipeline, parse_pipeline
    from nnstreamer_tpu_torch.single import SingleShot

    labels = os.path.join(tmp, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"l{i}" for i in range(1001)))
    source = (f"videotestsrc num-buffers={HEADLINE_FRAMES} pattern=random "
              f"width=224 height=224")
    launch = HEADLINE.replace("videotestsrc", source).replace("labels.txt", labels)
    counters.reset()
    t0 = time.perf_counter()
    rc = cli([launch])
    torch.cuda.synchronize()
    launches = {"headline cli": counters.read()}
    if rc != 0:
        raise AssertionError(f"nns-launch exited {rc}: {launch}")
    print(f"nns-launch (the README string, {HEADLINE_FRAMES} random 224x224 frames, "
          f"MobileNet-v2 224 width 1.0, 1001 classes, bf16): exit 0 in "
          f"{time.perf_counter() - t0:.3f} s incl. model build", flush=True)

    # the unfused filter refuses a float32 stream against the model's uint8
    # input, as the JAX package's does: declare the transformed stream
    parsed = launch.replace(
        "tensor_filter ", "tensor_filter name=filt input=3:224:224:1 inputtype=float32 "
    ).replace("! tensor_sink", "! tensor_sink name=labels store=true")

    def run(fused: bool, eager: bool) -> tuple:
        p = parse_pipeline(parsed, Pipeline())
        p.auto_fuse = fused
        arrivals = []
        sink = p.get_by_name("labels")
        sink.new_data = lambda b, a=arrivals: a.append(time.perf_counter())
        with _decoder_inputs() as seen, _decoder_inputs(TensorFilter) as into_filter, \
                _mode(eager):
            counters.reset()
            t0 = time.perf_counter()
            p.run(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            used, st = counters.read(), graphs.stats()
        invokes = p.get_by_name("filt").stats.total_invoke_num
        raw = {str(b.memories[0].dtype) for b in into_filter}
        if p._fused_count != int(fused) or invokes != HEADLINE_FRAMES \
                or raw != {"uint8" if fused else "float32"}:
            raise AssertionError(f"fused={fused}: {p._fused_count} transforms fused, "
                                 f"{invokes} filter invokes, filter inputs {raw}")
        if sink.num_buffers != HEADLINE_FRAMES or len(seen) != HEADLINE_FRAMES:
            raise AssertionError(f"{sink.num_buffers} labels, {len(seen)} logits")
        logits = [b.memories[0].device() for b in seen]
        devices = {str(x.device) for x in logits}
        if any(not d.startswith("cuda") for d in devices):
            raise AssertionError(f"filter output left the card: {devices}")
        for x, out in zip(logits, sink.buffers):
            if x.shape != (1, 1001) or x.dtype != torch.float32 \
                    or not torch.isfinite(x).all():
                raise AssertionError(f"logits {tuple(x.shape)} {x.dtype} or not finite")
            if out.meta["label_index"] != int(x.argmax(dim=-1)[0]):
                raise AssertionError("label != argmax of its logits")
        return logits, into_filter, wall, _steady_fps(arrivals), used, st

    runs, fps, stats = {}, {True: [], False: []}, {}
    for fused in (True, False, False, True):  # in turns: fps spreads run to run
        logits, into_filter, wall, rate, used, st = run(fused, eager=False)
        launches.setdefault(f"headline {'fused' if fused else 'unfused'}", used)
        stats.setdefault(fused, st)
        fps[fused].append(rate)
        if st["captures"] != 1 or st["replays"] != HEADLINE_FRAMES - 1:
            raise AssertionError(f"fused={fused}: graphs {st}")
        if fused in runs:  # the repeat run: the same logits again
            if not _all_identical(logits, runs[fused][0]):
                raise AssertionError(f"fused={fused}: logits differ between two runs")
            continue
        runs[fused] = (logits, into_filter, wall)
        for i, (a, b) in enumerate(zip(logits, runs.get(True, (logits,))[0])):
            if not torch.equal(a, b):
                raise AssertionError(f"frame {i}: fused and unfused logits differ by "
                                     f"{_max_abs_err(a, b)}")
    eager_fps = {}
    for fused in (True, False):
        logits, _, _, eager_fps[fused], _, _ = run(fused, eager=True)
        if not _all_identical(runs[fused][0], logits):
            raise AssertionError(f"fused={fused}: replayed logits differ from the "
                                 "eager ones")
    # SingleShot on the first frame as the unfused filter received it: a
    # capture, then two replays, and the eager call, all the pipeline's logits
    frame = runs[False][1][0].memories[0].device()
    graphs.reset_stats()
    with SingleShot(model="zoo://mobilenet_v2") as single:
        outs = [single.invoke(frame)[0] for _ in range(3)]
        st_single = graphs.stats()
        with graphs.disabled():
            outs.append(single.invoke(frame)[0])
    torch.cuda.synchronize()
    if st_single != {"captures": 1, "replays": 2, "warmups": 1} \
            or not _all_identical(outs, [runs[False][0][0]] * 4):
        raise AssertionError(f"SingleShot logits differ from the pipeline's, or "
                             f"graphs {st_single}")
    for fused in (True, False):
        print(f"headline pipeline parsed, transform {'fused into' if fused else 'before'} "
              f"the filter's invoke: {HEADLINE_FRAMES} frames, steady fps in two runs "
              f"(fused, unfused, unfused, fused order)="
              f"{', '.join(f'{v:.2f}' for v in fps[fused])}, eager "
              f"{eager_fps[fused]:.2f}", flush=True)
        _record_graphs(f"headline {'fused' if fused else 'unfused'}", 1, "fps",
                       fps[fused][0], eager_fps[fused], stats[fused])
    print(f"headline: fused and unfused logits bit-equal on all {HEADLINE_FRAMES} "
          f"frames, one filter invoke per frame, each label == argmax of its logits, "
          f"logits on {sorted({str(x.device) for x in runs[True][0]})}, replayed "
          f"logits == the eager ones; SingleShot(zoo://mobilenet_v2) on frame 0, "
          f"captured, replayed twice and eager, == its pipeline logits", flush=True)
    GRAPH_PATHS["singleshot"] = dict(st_single, distinct=1, unit="calls",
                                     reserved_mib=torch.cuda.memory_reserved() / 2 ** 20)
    print(f"graphs singleshot: {json.dumps(GRAPH_PATHS['singleshot'])}", flush=True)
    return launches


def run_gpu_smoke(counters) -> dict:
    """utils/probes.gpu_smoke on the card: every item passes and the CUDA
    prologue kernels launch."""
    from nnstreamer_tpu_torch.utils.probes import gpu_smoke

    counters.reset()
    res = gpu_smoke()
    launches = counters.read()
    failed = {k: v for k, v in res.items() if k != "device" and v != "pass"}
    if failed or launches["normalize_u8"] < 1 or launches["quantize_affine"] < 1:
        raise AssertionError(f"gpu_smoke: {res}, launches {launches}")
    print(f"gpu_smoke: {json.dumps(res)}", flush=True)
    return launches


def _lm_params(dtype=None):
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.models.convert import causal_lm_params

    v, d, h, n_layers = LM_DIMS
    return causal_lm_params(causal_lm.init_causal_lm(0, v, d, h, n_layers, LM_MAX_LEN),
                            "cuda", dtype=dtype)


def _serve(params, requests, n_slots: int, eng=None) -> tuple:
    """Serve ``requests`` on ``eng`` (a new engine when None): (tokens per
    request, the stats this run added, wall seconds, the engine)."""
    from nnstreamer_tpu_torch.serving import LMEngine

    if eng is None:
        eng = LMEngine(params, LM_DIMS[2], LM_MAX_LEN, n_slots=n_slots, chunk=LM_CHUNK)
    before = dict(eng.stats)
    rids = [eng.submit(p, max_new=g) for p, g in requests]
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([res[r] for r in rids], {k: v - before[k] for k, v in eng.stats.items()},
            wall, eng)


def check_step_invariance(params, quant: str) -> None:
    """One decode step over 8 slots holding prompts of the serving mix:
    each slot's K/V writes and logits equal the same slot stepped alone,
    bit for bit — what the engine's exactness contract rests on — and the
    step replayed as a CUDA graph equals it eager."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.models import causal_lm

    v, d, h, n_layers = LM_DIMS
    rng = np.random.default_rng(1)
    shape = (LM_SLOTS, n_layers * h, LM_MAX_LEN, d // h)
    kc, vc = torch.zeros(shape, device="cuda"), torch.zeros(shape, device="cuda")
    pos = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device="cuda")
    for s in range(LM_SLOTS):
        t = LM_PROMPTS[s % len(LM_PROMPTS)]
        tok = torch.from_numpy(rng.integers(0, v, (1, t)).astype(np.int32)).cuda()
        _, kc[s], vc[s], pos[s] = causal_lm.lm_prefill_masked(params, tok, t, h,
                                                              LM_MAX_LEN)
    tokens = torch.from_numpy(rng.integers(0, v, (LM_SLOTS, 1, 1)).astype(np.int32)).cuda()
    k8, v8 = kc.clone(), vc.clone()
    lg8, _, _, _ = causal_lm.lm_decode_step_slots(params, tokens, k8, v8, pos.clone(), h)
    for s in range(LM_SLOTS):
        k1, v1 = kc[s:s + 1].clone(), vc[s:s + 1].clone()
        lg1, _, _, _ = causal_lm.lm_decode_step_slots(params, tokens[s:s + 1], k1, v1,
                                                      pos[s:s + 1].clone(), h)
        if not (torch.equal(k1[0], k8[s]) and torch.equal(v1[0], v8[s])
                and torch.equal(lg1[0], lg8[s])):
            raise AssertionError(f"{quant}: slot {s}'s decode step differs batched "
                                 f"and alone, logits by {_max_abs_err(lg1[0], lg8[s])}")
    # the same step as a CUDA graph: a capture, then a replay on fresh
    # copies of the state, against the eager step above
    step = graphs.CapturedFn(
        lambda tok, kk, vv, pp: causal_lm.lm_decode_step_slots(params, tok, kk, vv, pp, h),
        f"lm {quant} decode step")
    for _ in range(2):
        lgr, kr, vr, pr = step(tokens, kc.clone(), vc.clone(), pos.clone())
    if len(step) != 1 or not (_identical(lgr, lg8) and _identical(kr, k8)
                              and _identical(vr, v8)):
        raise AssertionError(f"{quant}: a replayed decode step's K/V or logits differ "
                             f"from the eager step's, logits by {_max_abs_err(lgr, lg8)}")
    print(f"lm {quant} decode step: all {LM_SLOTS} slots' K/V writes and logits == "
          f"the slot stepped alone, bit for bit; the step replayed as a CUDA graph == "
          f"the eager step, bit for bit", flush=True)


def run_lm_serving(params, quant: str, counters) -> dict:
    """The bench's serving mix through the engine, with graphs and then
    eagerly (the same tokens); returns the launches of its graph run
    (counts set to 0 just before it)."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.serving import next_pow2_bucket

    v, _, _, n_layers = LM_DIMS
    rng = np.random.default_rng(5)
    requests = [(rng.integers(0, v, LM_PROMPTS[i % len(LM_PROMPTS)]).astype(np.int32),
                 LM_GENS[i % len(LM_GENS)]) for i in range(LM_REQUESTS)]
    check_step_invariance(params, quant)
    _serve(params, requests[:2], LM_SLOTS)  # warm-up: cuBLAS handles, allocator
    counters.reset()
    with _mode(eager=False):
        # a new engine: its first run captures each signature it meets
        outs, stats, wall, eng = _serve(params, requests, LM_SLOTS)
        launches, st = counters.read(), graphs.stats()
        # the same mix again on the same engine: replays only
        again, _, warm_wall, _ = _serve(params, requests, LM_SLOTS, eng)
        st_warm = graphs.stats()
    del eng
    tokens = sum(len(o) for o in outs)
    for (p, g), o in zip(requests, outs):
        if len(o) != g or not all(0 <= t < v for t in o):
            raise AssertionError(f"{quant}: a request of budget {g} gave {len(o)} tokens "
                                 "or tokens outside the vocabulary")
    want_dgr = n_layers * (stats["prefills"] + stats["decode_steps"]) \
        if quant == "w8a8" else 0
    if stats["prefills"] != LM_REQUESTS or launches["dequant_gelu_requant"] != want_dgr:
        raise AssertionError(f"{quant}: {stats['prefills']} prefills, "
                             f"{launches['dequant_gelu_requant']} dequant_gelu_requant "
                             f"launches (want {want_dgr})")
    if again != outs or st_warm["captures"] != st["captures"]:
        raise AssertionError(f"{quant}: the mix served again on the same engine gave "
                             f"other tokens, or captured again ({st_warm})")
    with _mode(eager=True):
        eager_outs, eager_stats, eager_wall, eng = _serve(params, requests, LM_SLOTS)
        eager_again, _, eager_warm_wall, _ = _serve(params, requests, LM_SLOTS, eng)
    del eng
    if eager_outs != outs or eager_again != outs \
            or {k: x for k, x in eager_stats.items() if k != "wall_s"} \
            != {k: x for k, x in stats.items() if k != "wall_s"}:
        first = next((i for i, (a, b) in enumerate(zip(outs, eager_outs)) if a != b), -1)
        raise AssertionError(f"{quant}: request {first}'s tokens (or the stats) differ "
                             "under graphs and eagerly")
    for i in LM_ISOLATED:
        alone, _, _, _ = _serve(params, [requests[i]], 1)
        if alone[0] != outs[i]:
            first = next(j for j, (a, b) in enumerate(zip(alone[0], outs[i])) if a != b)
            raise AssertionError(f"{quant}: request {i} in the {LM_SLOTS}-slot engine "
                                 f"differs from its 1-slot run at token {first}")
    waste = stats["wasted_slot_steps"] / max(1, LM_SLOTS * stats["decode_steps"])
    print(f"lm serving {quant} (V {v}, d {LM_DIMS[1]}, {LM_DIMS[2]} heads, {n_layers} "
          f"layers; max_len {LM_MAX_LEN}, {LM_SLOTS} slots, chunk {LM_CHUNK}; "
          f"{LM_REQUESTS} greedy requests): {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.2f} tokens/s on a new engine, its captures included "
          f"(eager {tokens / eager_wall:.2f}), served again on the same engine "
          f"{tokens / warm_wall:.2f} (eager {tokens / eager_warm_wall:.2f}), "
          f"prefills={stats['prefills']}, decode steps={stats['decode_steps']}, waste "
          f"fraction={waste:.4f}, launches={json.dumps(launches)}; the same tokens "
          f"eagerly and again; requests {list(LM_ISOLATED)} == their 1-slot runs",
          flush=True)
    # signatures the mix can feed: a prefill per bucket (all greedy), a
    # chunk per power of two up to the chunk
    buckets = {min(next_pow2_bucket(len(p)), LM_MAX_LEN) for p, _ in requests}
    _record_graphs(f"lm serving {quant}", len(buckets) + LM_CHUNK.bit_length(),
                   "tokens/s (served again)", tokens / warm_wall,
                   tokens / eager_warm_wall, st)
    return launches


def _paged_requests(seed: int) -> list:
    """bench.py's paged lane mix (its seed 7): a shared prefix, then two
    admission waves, the second sorted longest budget first."""
    v = LM_DIMS[0]
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, v, PAGED_PREFIX).astype(np.int32)
    wave = [PAGED_GENS[i % len(PAGED_GENS)] for i in range(PAGED_REQUESTS // 2)]
    requests = []
    for i, g in enumerate(wave + sorted(wave, reverse=True)):
        p = PAGED_PROMPTS[i % len(PAGED_PROMPTS)]
        suffix = rng.integers(0, v, p - PAGED_PREFIX).astype(np.int32)
        requests.append((np.concatenate([prefix, suffix]), g))
    return requests


def _paged_engine(params, n_slots: int, pages: int = PAGED_POOL, **kw):
    from nnstreamer_tpu_torch.serving import LMEngine

    return LMEngine(params, LM_DIMS[2], LM_MAX_LEN, n_slots=n_slots, chunk=LM_CHUNK,
                    kv_page_size=PAGE_SIZE, kv_pages=pages, **kw)


def _install_prefill(params, kpool, vpool, prompt, pages) -> None:
    """The admit prefill (``lm_prefill_window``) of ``prompt`` at the slot
    view's capacity, its first ``len(pages)`` pages scattered into the pools
    (what the engine's no-hit admission writes)."""
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.serving import next_pow2_bucket

    h, t = LM_DIMS[2], len(prompt)
    padded = torch.zeros((1, min(next_pow2_bucket(t), LM_MAX_LEN)), dtype=torch.int32,
                         device="cuda")
    padded[0, :t] = torch.from_numpy(prompt).cuda()
    _, kc, vc, _ = causal_lm.lm_prefill_window(params, padded, t, h, LM_MAX_LEN)
    lh, m, hd = kc.shape
    for pool, c in ((kpool, kc), (vpool, vc)):
        pool.index_copy_(0, pages, c.view(lh, m // PAGE_SIZE, PAGE_SIZE, hd)
                         .transpose(0, 1)[:len(pages)])


def check_prefix_routes(params, quant: str, requests) -> dict:
    """The two routes a prompt sharing the 128-token prefix can take: the
    contiguous engine's admit prefill (``lm_prefill_window``: the whole
    prompt as a window of its bucket at position 0) and the paged engine's
    prefix hit (``lm_prefill_paged``: the suffix alone as a window of its
    own bucket) over pages holding the prefix as the first request's no-hit
    prefill writes them. For one prompt of each length the suffix's K and V
    rows, layer by layer, and the first-token logits must be bit-equal;
    the largest difference of each from the dense ``lm_prefill_masked``
    (the JAX engine's admit form) is printed beside. Returns those."""
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.serving import next_pow2_bucket
    from nnstreamer_tpu_torch.serving.kv_cache import empty_page_pool

    v, d, h, n_layers = LM_DIMS
    hd, n_pages = d // h, LM_MAX_LEN // PAGE_SIZE
    table = torch.arange(1, n_pages + 1, device="cuda")
    dense = {"k": 0.0, "v": 0.0, "logits": 0.0, "argmax_differs": 0}

    def rows_by_layer(c, rows):
        return c.view(n_layers, h, LM_MAX_LEN, hd)[:, :, rows]

    for p, _ in requests[:len(PAGED_PROMPTS)]:
        t, ts = len(p), len(p) - PAGED_PREFIX
        padded = torch.zeros((1, min(next_pow2_bucket(t), LM_MAX_LEN)),
                             dtype=torch.int32, device="cuda")
        padded[0, :t] = torch.from_numpy(p).cuda()
        lg_a, kc, vc, _ = causal_lm.lm_prefill_window(params, padded, t, h, LM_MAX_LEN)
        lg_d, kd, vd, _ = causal_lm.lm_prefill_masked(params, padded, t, h, LM_MAX_LEN)
        kpool, vpool = empty_page_pool(n_pages, n_layers, h, PAGE_SIZE, hd, "cuda")
        _install_prefill(params, kpool, vpool, requests[0][0],
                         table[:PAGED_PREFIX // PAGE_SIZE])
        window = torch.zeros((1, min(next_pow2_bucket(ts), LM_MAX_LEN)),
                             dtype=torch.int32, device="cuda")
        window[0, :ts] = torch.from_numpy(p[PAGED_PREFIX:]).cuda()
        pos0, tl = torch.tensor(PAGED_PREFIX, device="cuda"), torch.tensor(ts, device="cuda")
        # the whole view's 1024 columns, then the columns the window can see
        # (the engine's), which must change no bit
        full = [pool.clone() for pool in (kpool, vpool)]
        lg_f, _, _, _ = causal_lm.lm_prefill_paged(params, window, *full, table, pos0, tl, h)
        lg_b, _, _, _ = causal_lm.lm_prefill_paged(
            params, window, kpool, vpool, table, pos0, tl, h,
            causal_lm.attend_cols(PAGED_PREFIX + window.shape[1], LM_MAX_LEN))
        rows = slice(PAGED_PREFIX, t)
        same = _identical(lg_a, lg_b) and _identical(lg_f, lg_b) \
            and _identical(full[0][1:], kpool[1:]) and _identical(full[1][1:], vpool[1:])
        dk, dv = [], []
        for pool, c, cd, out in ((kpool, kc, kd, dk), (vpool, vc, vd, dv)):
            b = rows_by_layer(causal_lm.paged_view_slots(pool, table[None])[0], rows)
            a = rows_by_layer(c, rows)
            same = same and _identical(a, b)
            dd = rows_by_layer(cd, rows)
            out.extend(_max_abs_err(dd[i], b[i]) for i in range(n_layers))
        dl = _max_abs_err(lg_d[0], lg_b[0])
        flips = int(lg_d[0].argmax()) != int(lg_b[0].argmax())
        dense["k"], dense["v"] = max(dense["k"], *dk), max(dense["v"], *dv)
        dense["logits"] = max(dense["logits"], dl)
        dense["argmax_differs"] += int(flips)
        if not same:
            raise AssertionError(
                f"{quant}: prompt {t}'s suffix K/V rows or first-token logits differ "
                f"between the window prefill and the prefix-hit route (or the hit "
                f"over its columns and over the whole view), logits by "
                f"{_max_abs_err(lg_a[0], lg_b[0])}")
        print(f"lm paged {quant} routes, prompt {t} (suffix {ts}, window "
              f"{window.shape[1]} against bucket {padded.shape[1]}): the prefix-hit "
              f"route's suffix K/V rows and first-token logits == the window "
              f"prefill's, bit for bit, and over its columns == over the whole view; "
              f"against the dense lm_prefill_masked: K rows by "
              f"layer {[f'{x:.3e}' for x in dk]}, V {[f'{x:.3e}' for x in dv]}, logits "
              f"{dl:.3e}, argmax {'differs' if flips else 'equal'}", flush=True)
    return dense


def check_paged_step_invariance(params, quant: str, requests) -> None:
    """One paged decode step over 32 slots (ops/int8.MIN_ROWS rows) holding
    the lane's prompts: each slot's logits and page writes equal the slot
    stepped alone, bit for bit, and the step replayed as a CUDA graph equals
    it eager. Pools are compared over pages 1..n: which write of the null
    page 0 lands is unordered."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.serving.kv_cache import empty_page_pool

    v, d, h, n_layers = LM_DIMS
    own = max(PAGED_PROMPTS) // PAGE_SIZE + 1  # the prompt's pages and one to decode into
    kpool, vpool = empty_page_pool(PAGED_SLOTS * own, n_layers, h, PAGE_SIZE, d // h,
                                   "cuda")
    tables = torch.zeros((PAGED_SLOTS, LM_MAX_LEN // PAGE_SIZE), dtype=torch.int64,
                         device="cuda")
    pos = torch.zeros((PAGED_SLOTS, 1), dtype=torch.int32, device="cuda")
    for s in range(PAGED_SLOTS):
        p = requests[s][0]
        tables[s, :own] = torch.arange(1 + s * own, 1 + (s + 1) * own)
        _install_prefill(params, kpool, vpool, p, tables[s, :own])
        pos[s] = len(p)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, v, (PAGED_SLOTS, 1, 1)).astype(np.int32)).cuda()
    k32, v32 = kpool.clone(), vpool.clone()
    lg32, _, _, _ = causal_lm.lm_decode_step_paged(params, tokens, k32, v32, tables,
                                                   pos.clone(), h)
    for s in range(PAGED_SLOTS):
        k1, v1 = kpool.clone(), vpool.clone()
        lg1, _, _, _ = causal_lm.lm_decode_step_paged(params, tokens[s:s + 1], k1, v1,
                                                      tables[s:s + 1], pos[s:s + 1].clone(), h)
        mine = tables[s, :own]
        if not (torch.equal(lg1[0], lg32[s]) and torch.equal(k1[mine], k32[mine])
                and torch.equal(v1[mine], v32[mine])):
            raise AssertionError(f"{quant}: slot {s}'s paged decode step differs batched "
                                 f"and alone, logits by {_max_abs_err(lg1[0], lg32[s])}")
    step = graphs.CapturedFn(
        lambda tok, kk, vv, tb, pp: causal_lm.lm_decode_step_paged(params, tok, kk, vv, tb,
                                                                   pp, h),
        f"lm {quant} paged decode step")
    for _ in range(2):
        lgr, kr, vr, _ = step(tokens, kpool.clone(), vpool.clone(), tables, pos.clone())
    if len(step) != 1 or not (_identical(lgr, lg32) and _identical(kr[1:], k32[1:])
                              and _identical(vr[1:], v32[1:])):
        raise AssertionError(f"{quant}: a replayed paged decode step's pages or logits "
                             f"differ from the eager step's, logits by "
                             f"{_max_abs_err(lgr, lg32)}")
    print(f"lm paged {quant} decode step: all {PAGED_SLOTS} slots' logits and page writes "
          f"== the slot stepped alone, bit for bit; the step replayed as a CUDA graph == "
          f"the eager step (pages 1..{kpool.shape[0] - 1}), bit for bit", flush=True)


def _signatures(eng) -> dict:
    """The engine's captured signatures by program: the admit prefill's
    (bucket, static values), the chunk's steps, the verify window's width."""
    out = {}
    for name, prog in (("prefill", eng._prefill_prog),
                       ("paged prefill", eng._paged_prefill_prog),
                       ("chunk", eng._chunk_prog), ("verify", eng._verify_prog)):
        keys = []
        for shapes, static in prog._graphs:
            first = [list(a[0]) for a in shapes[:1]]
            keys.append(f"{first}{dict(static)}" if first else str(dict(static)))
        if keys:
            out[name] = sorted(keys)
    return out


def _gather_scatter_ms(eng) -> tuple:
    """Device ms of one chunk's gather (both pools' views of every slot) and
    of its scatter (the touched pages of every slot back), timed with CUDA
    events over 10 calls each on the engine's pools, every slot's table
    full of pages (the pool's pages in turn)."""
    from nnstreamer_tpu_torch.models import causal_lm

    kv = eng._kv
    s_, b = eng._table.shape
    tables = (torch.arange(s_ * b, device="cuda") % kv.n_pages + 1).view(s_, b)
    nt = causal_lm.paged_touch_span(LM_CHUNK, PAGE_SIZE, tables.shape[1])
    p0s = torch.full((tables.shape[0],), 200, dtype=torch.int32, device="cuda")
    views = [causal_lm.paged_view_slots(pool, tables) for pool in (kv.kpool, kv.vpool)]

    def gather():
        for pool in (kv.kpool, kv.vpool):
            causal_lm.paged_view_slots(pool, tables)

    def scatter():
        for pool, view in zip((kv.kpool, kv.vpool), views):
            causal_lm.paged_update_slots(pool, view, tables, p0s, nt)

    out = []
    for fn in (gather, scatter):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / 10)
    return tuple(out)


def check_paged_cow_offload(params, quant: str) -> dict:
    """Copy-on-write and host offload at full width: one slot on a pool of
    COW_POOL pages with ``kv_host_offload``; two prompts of two and a half
    pages sharing a prefix that ends mid-page (the second is served by a COW
    copy), two unrelated ones that evict the first two's pages to the host,
    and the first prompt again (its pages re-uploaded), each generating half
    a page. Tokens equal the contiguous engine's."""
    v, gen = LM_DIMS[0], PAGE_SIZE // 2
    rng = np.random.default_rng(11)

    def tokens(n):
        return rng.integers(0, v, n).astype(np.int32)

    prefix = tokens(COW_PREFIX)
    first = np.concatenate([prefix, tokens(PAGE_SIZE)])
    requests = [(first, gen), (np.concatenate([prefix, tokens(PAGE_SIZE)]), gen),
                (tokens(len(first)), gen), (tokens(len(first)), gen), (first, gen)]
    want, _, _, _ = _serve(params, requests, 2)
    got, _, _, eng = _serve(params, requests, 1,
                            _paged_engine(params, 1, COW_POOL, kv_host_offload=True))
    kv = eng.kv_stats
    if got != want or min(kv["cow_copies"], kv["offloads"], kv["reuploads"]) < 1:
        first_bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), -1)
        raise AssertionError(f"{quant}: COW/offload case: request {first_bad} differs "
                             f"from the contiguous engine, or stats {kv}")
    print(f"lm paged {quant} copy-on-write and offload ({COW_POOL} pages, 1 slot, a "
          f"{COW_PREFIX}-token prefix): 5 requests == the contiguous engine's; "
          f"cow_copies={kv['cow_copies']}, offloads={kv['offloads']}, "
          f"reuploads={kv['reuploads']}, evictions={kv['evictions']}, "
          f"hit_tokens={kv['hit_tokens']}", flush=True)
    return kv


def run_lm_paged(params, quant: str, counters) -> dict:
    """bench.py's paged serving lane at full width: the 32-slot paged engine
    against the 8-slot contiguous engine on the same 64 requests, with
    graphs and then eagerly; returns the launches of the paged graph run
    (counts set to 0 just before it)."""
    from nnstreamer_tpu_torch.core import graphs

    v, _, _, n_layers = LM_DIMS
    requests, again = _paged_requests(7), _paged_requests(8)
    routes = check_prefix_routes(params, quant, requests)
    check_paged_step_invariance(params, quant, requests)
    cow = check_paged_cow_offload(params, quant)
    _serve(params, requests[:2], PAGED_SLOTS, _paged_engine(params, PAGED_SLOTS))

    def both_mixes(make, n_slots):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = make()
        counters.reset()
        outs, stats, wall, eng = _serve(params, requests, n_slots, eng)
        launches, st = counters.read(), graphs.stats()
        kv = eng.kv_stats
        outs2, stats2, wall2, eng = _serve(params, again, n_slots, eng)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        return dict(outs=outs, stats=stats, wall=wall, launches=launches, graphs=st,
                    kv=kv, outs2=outs2, stats2=stats2, wall2=wall2, peak_mib=peak,
                    signatures=_signatures(eng),
                    gather_scatter=_gather_scatter_ms(eng) if eng._kv is not None else None)

    make_paged = lambda: _paged_engine(params, PAGED_SLOTS)  # noqa: E731
    make_cont = lambda: None  # noqa: E731 (_serve builds the contiguous engine)
    with _mode(eager=False):
        paged = both_mixes(make_paged, PAGED_SLOTS)
    with _mode(eager=False):
        cont = both_mixes(make_cont, LM_SLOTS)
    with _mode(eager=True):
        paged_e, _, paged_e_wall, _ = _serve(params, requests, PAGED_SLOTS, make_paged())
        cont_e, _, cont_e_wall, _ = _serve(params, requests, LM_SLOTS)
    for name, got, want in (("paged", paged["outs"], cont["outs"]),
                            ("paged, second mix", paged["outs2"], cont["outs2"]),
                            ("paged eager", paged_e, paged["outs"]),
                            ("contiguous eager", cont_e, cont["outs"])):
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            tok = next(j for j, (a, b) in enumerate(zip(got[bad[0]], want[bad[0]]))
                       if a != b) if len(got[bad[0]]) == len(want[bad[0]]) else -1
            raise AssertionError(f"{quant}: {name}: {len(bad)} of {len(want)} requests "
                                 f"differ (the first, request {bad[0]}, at token {tok})")
    for i in PAGED_ISOLATED:
        alone, _, _, _ = _serve(params, [requests[i]], 1, _paged_engine(params, 1))
        if alone[0] != paged["outs"][i]:
            raise AssertionError(f"{quant}: request {i} in the {PAGED_SLOTS}-slot paged "
                                 "engine differs from its 1-slot paged run")
    kv, stats = paged["kv"], paged["stats"]
    want_dgr = n_layers * (stats["prefills"] + stats["decode_steps"]) \
        if quant == "w8a8" else 0
    if kv["hit_requests"] < PAGED_REQUESTS // 2 - 1 or kv["hit_tokens"] < 1 \
            or kv["pages_peak"] > PAGED_POOL \
            or paged["launches"]["dequant_gelu_requant"] != want_dgr \
            or stats["prefills"] != PAGED_REQUESTS:
        raise AssertionError(f"{quant}: paged kv_stats {kv}, {stats['prefills']} "
                             f"prefills, dequant_gelu_requant "
                             f"{paged['launches']['dequant_gelu_requant']} (want {want_dgr})")
    tokens = sum(len(o) for o in paged["outs"])
    tokens2 = sum(len(o) for o in paged["outs2"])

    def waste(st, slots):
        return st["wasted_slot_steps"] / max(1, slots * st["decode_steps"])

    rate = {k: tokens / r["wall"] for k, r in (("paged", paged), ("contiguous", cont))}
    rate2 = {k: tokens2 / r["wall2"] for k, r in (("paged", paged), ("contiguous", cont))}
    gms, sms = paged["gather_scatter"]
    print(f"lm paged {quant} (V {v}, d {LM_DIMS[1]}, {LM_DIMS[2]} heads, {n_layers} layers; "
          f"max_len {LM_MAX_LEN}, chunk {LM_CHUNK}; {PAGED_SLOTS} slots on {PAGED_POOL} "
          f"pages of {PAGE_SIZE} against {LM_SLOTS} contiguous slots; {PAGED_REQUESTS} "
          f"greedy requests, a {PAGED_PREFIX}-token shared prefix): every request's tokens "
          f"== the contiguous engine's, graphs == eager, requests {list(PAGED_ISOLATED)} == "
          f"their 1-slot paged runs; a new engine (its captures included) paged "
          f"{rate['paged']:.2f} tokens/s, contiguous {rate['contiguous']:.2f} (ratio "
          f"{rate['paged'] / rate['contiguous']:.4f}); the same engines on a second mix "
          f"(seed 8, replays only) {rate2['paged']:.2f} and {rate2['contiguous']:.2f} "
          f"(ratio {rate2['paged'] / rate2['contiguous']:.4f}); eager {tokens / paged_e_wall:.2f} "
          f"and {tokens / cont_e_wall:.2f}; waste fraction paged {waste(stats, PAGED_SLOTS):.4f}, "
          f"contiguous {waste(cont['stats'], LM_SLOTS):.4f}; decode steps "
          f"{stats['decode_steps']} and {cont['stats']['decode_steps']}; peak memory above "
          f"the params paged {paged['peak_mib']:.1f} MiB, contiguous {cont['peak_mib']:.1f} "
          f"MiB; prefix hit rate {kv['hit_tokens'] / max(1, kv['prompt_tokens']):.4f} "
          f"(hit_requests {kv['hit_requests']}, hit_tokens {kv['hit_tokens']}), pages_peak "
          f"{kv['pages_peak']}, evictions {kv['evictions']}, cow_copies {kv['cow_copies']}; "
          f"a chunk's gather {gms:.4f} ms and scatter {sms:.4f} ms on the device; "
          f"launches {json.dumps(paged['launches'])}; captures by signature "
          f"{json.dumps(paged['signatures'])}", flush=True)
    LOOP_STATS[f"lm_paged_{quant}"] = {
        "tokens_per_s": rate, "tokens_per_s_second_mix": rate2,
        "eager_tokens_per_s": {"paged": tokens / paged_e_wall,
                               "contiguous": tokens / cont_e_wall},
        "waste": {"paged": waste(stats, PAGED_SLOTS),
                  "contiguous": waste(cont["stats"], LM_SLOTS)},
        "peak_mib": {"paged": paged["peak_mib"], "contiguous": cont["peak_mib"]},
        "kv_stats": kv, "gather_ms": gms, "scatter_ms": sms, "routes": routes,
        "cow_offload": cow}
    sigs = sum(len(x) for x in paged["signatures"].values())
    _record_graphs(f"lm paged {quant}", sigs, "tokens/s (new engine)", rate["paged"],
                   tokens / paged_e_wall, paged["graphs"])
    return paged["launches"]


def run_flash_prefill(counters, dtype: torch.dtype) -> dict:
    """appsrc ! tensor_filter (prefill bundle over ``dtype`` params) !
    tensor_sink with flash and dense attention; returns the flash run's
    launches, every one of which must take flash_attention's route for
    ``dtype`` (PREFILL_ROUTE)."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.models.causal_lm import prefill_bundle, prefill_flops

    v, d, h, n_layers = LM_DIMS
    name = str(dtype)[6:]
    params = _lm_params(None if dtype == torch.float32 else dtype)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, v, (FLASH_B, FLASH_T)).astype(np.int32)
              for _ in range(FLASH_FRAMES)]
    caps = Caps.tensors(TensorsConfig(TensorsInfo.from_strings(
        f"{FLASH_T}:{FLASH_B}", "int32")))

    def run(flash: bool, data) -> tuple:
        p = Pipeline("lm-prefill")
        src = p.add_new("appsrc", caps=caps, data=data)
        filt = p.add_new("tensor_filter", framework="torch-cuda", model=prefill_bundle(
            params, h, FLASH_T, FLASH_B, flash=flash))
        arrivals = []
        sink = p.add_new("tensor_sink", store=True,
                         new_data=lambda b: arrivals.append(time.perf_counter()))
        Pipeline.link(src, filt, sink)
        t0 = time.perf_counter()
        p.run(timeout=600)
        torch.cuda.synchronize()
        return [b.memories[0].device() for b in sink.buffers], \
            time.perf_counter() - t0, arrivals

    results, routes, eager = {}, {}, {}
    for flash in (True, False):
        run(flash, frames[:2])  # warm-up
        counters.reset()
        before = dict(fa.flash_attention.launches_by_route)
        with _mode(eager=False):
            logits, wall, arrivals = run(flash, frames)
            st = graphs.stats()
        results[flash] = (logits, wall, counters.read(), arrivals, st)
        routes[flash] = {r: n - before[r] for r, n in fa.flash_attention.launches_by_route.items()}
        with _mode(eager=True):
            eager[flash] = run(flash, frames)
        if not _all_identical(logits, eager[flash][0]):
            raise AssertionError(f"{name} {'flash' if flash else 'dense'} prefill: "
                                 "replayed logits differ from the eager ones")
    launches = results[True][2]
    if launches["flash_attention"] != n_layers * FLASH_FRAMES \
            or results[False][2]["flash_attention"] != 0:
        raise AssertionError(f"{name}: flash_attention launches {launches['flash_attention']} "
                             f"(flash) and {results[False][2]['flash_attention']} (dense) "
                             f"for {FLASH_FRAMES} batches of {n_layers} layers")
    want = {r: 0 for r in routes[True]}
    want[PREFILL_ROUTE[dtype]] = n_layers * FLASH_FRAMES
    if routes[True] != want:
        raise AssertionError(f"{name} flash prefill launches by route {routes[True]}: all "
                             f"{n_layers * FLASH_FRAMES} must take the "
                             f"{PREFILL_ROUTE[dtype]} route")
    print(f"flash prefill ({name}) flash_attention launches by route: {routes[True]}",
          flush=True)
    rtol, atol = FLASH_TOL[dtype] if dtype == torch.bfloat16 else PREFILL_F32_TOL
    worst, agree = 0.0, 0
    for fl, dn in zip(results[True][0], results[False][0]):
        if fl.shape != (FLASH_B, v) or fl.dtype != torch.float32 \
                or not torch.isfinite(fl).all() or not _within(fl, dn, rtol, atol):
            raise AssertionError(f"{name} flash prefill logits differ from dense: "
                                 f"{tuple(fl.shape)} {fl.dtype}, max abs err "
                                 f"{_max_abs_err(fl, dn)}")
        worst = max(worst, _max_abs_err(fl, dn))
        agree += int((fl.argmax(-1) == dn.argmax(-1)).sum())
    flops = prefill_flops(FLASH_B, FLASH_T, d, n_layers, v)
    for flash in (True, False):
        _, wall, _, arrivals, st = results[flash]
        # the wall of a graph run holds its first batch's capture; the steady
        # rate (first arrival to last) holds replays only
        tps = FLASH_FRAMES * FLASH_B * FLASH_T / wall
        eager_tps = FLASH_FRAMES * FLASH_B * FLASH_T / eager[flash][1]
        steady, eager_steady = (_steady_fps(a) * FLASH_B * FLASH_T
                                for a in (arrivals, eager[flash][2]))
        print(f"lm prefill pipeline ({'flash' if flash else 'dense'} attention, {name}, "
              f"B {FLASH_B} x T {FLASH_T}): {FLASH_FRAMES} batches in {wall:.3f} s = "
              f"{tps:.1f} tokens/s incl. the capture (eager {eager_tps:.1f}), steady "
              f"{steady:.1f} tokens/s (eager {eager_steady:.1f}) = "
              f"{flops * _steady_fps(arrivals) / 1e12:.2f} TFLOP/s (analytic); replayed "
              f"logits == the eager ones", flush=True)
        _record_graphs(f"prefill {'flash' if flash else 'dense'} {name}", 1,
                       "steady prompt tokens/s", steady, eager_steady, st)
    print(f"{name} flash vs dense last-token logits: max abs err {worst:.4e} (bound rtol "
          f"{rtol} atol {atol}), argmax agree {agree}/{FLASH_FRAMES * FLASH_B}", flush=True)
    devices = {str(x.device) for x in results[True][0] + results[False][0]}
    if any(not d.startswith("cuda") for d in devices):
        raise AssertionError(f"prefill logits left the card: {devices}")
    return launches


def run_filter_options() -> None:
    """The filter's own options on the card: a ``bucket=4`` pipeline (a
    frame's regions stacked, padded and invoked once, a graph per padded
    size) and a ``bucket=4,resize=H:W`` one, each against the same
    pipeline on CPU tensors and eagerly on the card, bit for bit."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.core.types import Caps, TensorFormat, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.graph import Pipeline

    rng = np.random.default_rng(3)
    same = [tuple(rng.standard_normal((7, 5, 3)).astype(np.float32) for _ in range(n))
            for n in (3, 1, 6, 9)]
    ragged = [tuple(rng.integers(0, 256, (int(hh), int(ww), 3)).astype(np.uint8)
                    for hh, ww in rng.integers(1, 40, (n, 2))) for n in (2, 5, 4)]
    caps = Caps.tensors(TensorsConfig(TensorsInfo((), TensorFormat.FLEXIBLE), 30))
    for custom, frames in (("bucket=4", same), ("bucket=4,resize=12:9", ragged)):
        outs, st = {}, None
        for device, eager in (("cuda", False), ("cuda", True), ("cpu", True)):
            p = Pipeline(device=device)
            src = p.add_new("appsrc", caps=caps, data=list(frames))
            filt = p.add_new("tensor_filter", framework="torch-cuda",
                             model=lambda x: x.amax(dim=(1, 2)), custom=custom)
            sink = p.add_new("tensor_sink", store=True)
            Pipeline.link(src, filt, sink)
            with _mode(eager):
                p.run(timeout=120)
                if not eager:
                    st = graphs.stats()
            outs[device, eager] = [b.memories[0].device() for b in sink.buffers]
        got = outs["cuda", False]
        if [tuple(o.shape) for o in got] != [(len(f), 3) for f in frames] \
                or any(o.device.type != "cuda" for o in got) \
                or not all(torch.equal(a.cpu(), b) for a, b in zip(got, outs["cpu", True])) \
                or not _all_identical(got, outs["cuda", True]):
            raise AssertionError(f"filter custom={custom!r} on the card differs from the "
                                 "CPU run or from the eager run")
        # padded sizes: the next multiple of 4 (bucket_max 32 is never reached)
        distinct = len({-(-len(f) // 4) for f in frames})
        print(f"filter custom={custom!r}: {len(frames)} flexible frames of "
              f"{[len(f) for f in frames]} regions, on the card == on CPU tensors == "
              f"eagerly on the card, bit for bit", flush=True)
        _record_graphs(f"filter {custom}", distinct, "frames", len(frames),
                       len(frames), st)


# --------------------------------------------------------------------------- #
# the N-input stream elements: the repo-LSTM loop, crop → bucketed filter,
# and each element on tensors on the card
# --------------------------------------------------------------------------- #

@contextlib.contextmanager
def _host_copies():
    """Count the copies between the host and the card that go through a
    ``TensorMemory`` while inside: ``h2d`` (a host array or CPU tensor made
    resident on the card) and ``d2h`` (a card tensor read on the host)."""
    from nnstreamer_tpu_torch.core.buffer import TensorMemory

    counts = {"h2d": 0, "d2h": 0}
    lock = threading.Lock()
    to_device, to_host = TensorMemory.device, TensorMemory.host

    def counting_device(self, device=None):
        t = self._device
        if device is not None and torch.device(device).type == "cuda" \
                and (t is None or t.device.type != "cuda"):
            with lock:
                counts["h2d"] += 1
        return to_device(self, device)

    def counting_host(self):
        if self._host is None and self._device is not None \
                and self._device.device.type == "cuda":
            with lock:
                counts["d2h"] += 1
        return to_host(self)

    TensorMemory.device, TensorMemory.host = counting_device, counting_host
    try:
        yield counts
    finally:
        TensorMemory.device, TensorMemory.host = to_device, to_host


def _repo_loop(device, frames, model) -> tuple:
    """bench.py:280-298 without its query hop: ``appsrc → tensor_mux
    sync_mode=nosync ← tensor_reposrc slot_index=77 → tensor_filter →
    tensor_demux tensorpick=0,1:2 → [queue → tensor_sink], [queue →
    tensor_reposink slot_index=77]``. One frame in flight: appsrc pushes a
    frame once the previous one's output was read on the host at the sink
    (the user's read, which waits for the frame's work). Returns the
    outputs (host arrays), push and arrival times, and the host copies."""
    from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.elements.repo import reset_repo
    from nnstreamer_tpu_torch.graph import Pipeline

    reset_repo()
    done = threading.Semaphore(0)
    pushed, arrived, outs = [], [], []
    it = iter(frames)

    def next_frame():
        if pushed and not done.acquire(timeout=60):
            raise RuntimeError("repo loop: no result within 60 s")
        x = next(it, None)
        if x is not None:
            pushed.append(time.perf_counter())
        return x

    def on_result(b):
        outs.append(b.memories[0].host())
        arrived.append(time.perf_counter())
        done.release()

    p = Pipeline("repo-lstm", device=device)
    caps = Caps.tensors(TensorsConfig(
        TensorsInfo.from_strings(f"{LSTM_DIN}:1", "float32"), 30))
    src = p.add_new("appsrc", caps=caps, callback=next_frame, framerate=30)
    state = p.add_new("tensor_reposrc", slot_index=LSTM_SLOT,
                      dims=f"{LSTM_F}:1,{LSTM_F}:1", types="float32,float32")
    mux = p.add_new("tensor_mux", sync_mode="nosync")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=model)
    demux = p.add_new("tensor_demux", tensorpick="0,1:2")
    sink = p.add_new("tensor_sink", new_data=on_result)
    rsink = p.add_new("tensor_reposink", slot_index=LSTM_SLOT)
    Pipeline.link(src, mux)
    Pipeline.link(state, mux)
    Pipeline.link(mux, filt, demux)
    Pipeline.link(demux, p.add_new("queue"), sink)
    Pipeline.link(demux, p.add_new("queue"), rsink)
    with _host_copies() as copies:
        p.start()
        try:
            deadline = time.monotonic() + 300
            while len(outs) < len(frames) and time.monotonic() < deadline:
                time.sleep(0.005)
        finally:
            p.stop()
    if len(outs) != len(frames):
        raise AssertionError(f"repo loop on {device}: {len(outs)} of {len(frames)} "
                             "frames out (the loop stalled)")
    return outs, pushed, arrived, dict(copies)


def run_repo_lstm(counters) -> dict:
    """Path (a), the repo-LSTM composite loop at the bench's widths (d_in
    32, features 64, batch 1): 16 warm-up frames, then 192 timed, with CUDA
    graphs and eagerly, and on the CPU. Every replayed output byte-equal to
    the eager one, the card within LSTM_TOL of the CPU after 208 recurrent
    steps, and per frame exactly one host-to-card copy (the appsrc input; the
    bootstrap frame's two zero states once) and one card-to-host copy (the
    sink's read): the state stays on the card around the loop."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.models.zoo import get_model

    rng = np.random.default_rng(7)
    n = LSTM_WARM + LSTM_FRAMES
    frames = [rng.standard_normal((1, LSTM_DIN)).astype(np.float32) for _ in range(n)]
    runs = {}
    for eager in (False, True):
        counters.reset()
        with _mode(eager):
            outs, pushed, arrived, copies = _repo_loop("cuda", frames, LSTM_SPEC)
            st = graphs.stats()
        launches = counters.read()
        rtt = np.median([a - s for a, s in zip(arrived[LSTM_WARM:], pushed[LSTM_WARM:])])
        fps = (LSTM_FRAMES - 1) / (arrived[-1] - arrived[LSTM_WARM])
        runs[eager] = (outs, fps, float(rtt) * 1e3, copies, st)
        if copies != {"h2d": n + 2, "d2h": n}:
            raise AssertionError(f"repo loop ({'eager' if eager else 'graphs'}): host "
                                 f"copies {copies} for {n} frames, expected "
                                 f"{{'h2d': {n + 2}, 'd2h': {n}}}")
    outs, fps, rtt, copies, st = runs[False]
    if not all(a.tobytes() == b.tobytes() for a, b in zip(outs, runs[True][0])):
        raise AssertionError("repo loop: replayed outputs differ from the eager ones")
    cpu_bundle = get_model(LSTM_SPEC, device="cpu")
    cpu_outs = _repo_loop("cpu", frames, cpu_bundle)[0]
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs, cpu_outs))
    rtol, atol = LSTM_TOL
    if not all(np.allclose(a, b, rtol=rtol, atol=atol) and np.isfinite(a).all()
               for a, b in zip(outs, cpu_outs)):
        raise AssertionError(f"repo loop: the card's outputs leave the CPU's by {err} "
                             f"(rtol {rtol}, atol {atol})")
    print(f"repo-lstm loop (d_in {LSTM_DIN}, features {LSTM_F}): {LSTM_FRAMES} frames "
          f"after {LSTM_WARM}; graphs {fps:.2f} fps, round trip p50 {rtt:.4f} ms; "
          f"eager {runs[True][1]:.2f} fps, p50 {runs[True][2]:.4f} ms; host copies a "
          f"frame: h2d {copies['h2d'] / n:.4f}, d2h {copies['d2h'] / n:.4f} "
          f"({copies} over {n} frames, the bootstrap's two zero states included); "
          f"replayed == eager; card vs CPU max abs err {err:.3e} over {n} steps",
          flush=True)
    _record_graphs("repo_lstm", 1, "fps", fps, runs[True][1], st)
    LOOP_STATS["repo_lstm"] = {"fps": fps, "rtt_p50_ms": rtt, "eager_fps": runs[True][1],
                               "eager_rtt_p50_ms": runs[True][2], "max_abs_err": err,
                               "h2d_per_frame": copies["h2d"] / n,
                               "d2h_per_frame": copies["d2h"] / n}
    return launches


def _crop_inputs() -> tuple:
    """64 1920x1080x3 uint8 frames and 1-9 boxes a frame, each box's origin
    inside the frame and its sides 16-400 pixels (clipped at the edges)."""
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
              for _ in range(CROP_FRAMES)]
    boxes = []
    for _ in range(CROP_FRAMES):
        k = int(rng.integers(1, CROP_MAX_BOXES + 1))
        xy = rng.integers(0, (1920 - 16, 1080 - 16), (k, 2))
        wh = rng.integers(16, 401, (k, 2))
        boxes.append(np.concatenate([xy, wh], axis=1).astype(np.int32))
    return frames, boxes


def _crop_pipeline(frames, boxes, on_logits):
    """Path (b)'s pipeline on the card: ``appsrc (raw) → tensor_crop ←
    appsrc (info)``, ``tensor_crop → tensor_filter model=zoo://mobilenet_v2
    custom="bucket=4,resize=224:224" → tensor_sink new_data=on_logits``."""
    from nnstreamer_tpu_torch.core.types import Caps, TensorFormat, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.graph import Pipeline

    raw_caps = Caps.tensors(TensorsConfig(
        TensorsInfo.from_strings("3:1920:1080:1", "uint8"), 30))
    flex = Caps.tensors(TensorsConfig(TensorsInfo((), TensorFormat.FLEXIBLE), 30))
    p = Pipeline("crop-bucketed", device="cuda")
    raw = p.add_new("appsrc", caps=raw_caps, data=[f[None] for f in frames],
                    framerate=30)
    info = p.add_new("appsrc", caps=flex, data=boxes, framerate=30)
    crop = p.add_new("tensor_crop")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=CROP_SPEC,
                     custom="bucket=4,resize=224:224")
    sink = p.add_new("tensor_sink", new_data=on_logits)
    Pipeline.link(raw, crop)
    Pipeline.link(info, crop)
    Pipeline.link(crop, filt, sink)
    return p


def run_crop_bucketed(counters) -> dict:
    """Path (b): tensor_crop → tensor_filter model=zoo://mobilenet_v2
    custom="bucket=4,resize=224:224" → tensor_sink over 64 1080p frames of
    1-9 regions, with CUDA graphs (one a padded size) and eagerly: every
    frame's logits (n, 1001) on the card, finite, byte-equal between the
    two runs, and frame 0's equal to the bundle called directly on its
    resized, stacked and padded regions."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.filters.torch_cuda import resize_region
    from nnstreamer_tpu_torch.models.zoo import get_model

    frames, boxes = _crop_inputs()
    counts = [len(b) for b in boxes]
    # steady frames: each padded size's first frame warms up and captures
    # its graph (eagerly: lets cuDNN choose), so rates count the others
    sizes = [-(-k // 4) for k in counts]
    steady = [k for k in range(1, len(counts)) if sizes[k] in sizes[:k]]
    runs = {}
    for eager in (False, True):
        arrived, outs = [], []

        def on_logits(b, arrived=arrived, outs=outs):
            outs.append((b.memories[0].device(), b.memories[0].host()))
            arrived.append(time.perf_counter())

        p = _crop_pipeline(frames, boxes, on_logits)
        counters.reset()
        with _mode(eager):
            p.run(timeout=600)
            st = graphs.stats()
        launches = counters.read()
        if [h.shape for _, h in outs] != [(k, 1001) for k in counts]:
            raise AssertionError(f"crop_bucketed: logits {[h.shape for _, h in outs]} "
                                 f"for {counts} regions")
        gaps = [arrived[k] - arrived[k - 1] for k in steady]
        runs[eager] = (outs, len(steady) / sum(gaps),
                       sum(counts[k] for k in steady) / sum(gaps), st,
                       (len(outs) - 1) / (arrived[-1] - arrived[0]))
    outs, fps, rps, st, wall_fps = runs[False]
    if any(d.device.type != "cuda" for d, _ in outs) \
            or not all(np.isfinite(h).all() for _, h in outs):
        raise AssertionError("crop_bucketed: logits off the card or not finite")
    if not all(a.tobytes() == b.tobytes() for (_, a), (_, b) in zip(outs, runs[True][0])):
        raise AssertionError("crop_bucketed: replayed logits differ from the eager ones")
    # frame 0 by hand: the crop's regions, resized, stacked, padded, invoked
    img, regions = frames[0], []
    for x, y, w, h in boxes[0].astype(np.int64):
        regions.append(img[y:min(y + h, 1080), x:min(x + w, 1920)])
    dev = torch.device("cuda")
    batch = torch.stack([resize_region(r, (224, 224), dev) for r in regions])
    k, bucket = len(regions), -(-len(regions) // 4) * 4
    batch = torch.cat([batch, batch.new_zeros((bucket - k,) + tuple(batch.shape[1:]))])
    with graphs.disabled(), torch.inference_mode():
        want = get_model(CROP_SPEC, device=dev).fn()(batch)[:k].cpu().numpy()
    if want.tobytes() != outs[0][1].tobytes():
        raise AssertionError("crop_bucketed: frame 0's logits differ from the bundle "
                             "called on its regions")
    distinct = len(set(sizes))
    print(f"crop -> bucket=4,resize=224:224 mobilenet_v2: {CROP_FRAMES} frames of "
          f"1920x1080, {sum(counts)} regions ({min(counts)}-{max(counts)} a frame), "
          f"padded sizes {sorted({k * 4 for k in sizes})}; steady ({len(steady)} "
          f"frames): graphs {fps:.2f} frames/s, {rps:.2f} regions/s; eager "
          f"{runs[True][1]:.2f} frames/s, {runs[True][2]:.2f} regions/s; by wall "
          f"(captures included) {wall_fps:.2f} and eager {runs[True][4]:.2f} frames/s; "
          "replayed == eager; frame 0 == the bundle on its regions", flush=True)
    _record_graphs("crop_bucketed", distinct, "frames/s", fps, runs[True][1], st)
    LOOP_STATS["crop_bucketed"] = {"fps": fps, "regions_per_s": rps,
                                   "eager_fps": runs[True][1],
                                   "eager_regions_per_s": runs[True][2],
                                   "wall_fps": wall_fps, "eager_wall_fps": runs[True][4],
                                   "regions": sum(counts), "steady_frames": len(steady)}
    return launches


def _record_sinks(sinks) -> dict:
    """Each sink's buffers as (pts, duration, [(shape, dtype, bytes)])."""
    return {key: [(b.pts, b.duration,
                   [(tuple(m.shape), str(m.dtype), m.tobytes()) for m in b.memories])
                  for b in s.buffers] for key, s in sinks.items()}


def _stream_cases(dev) -> dict:
    """name → (build, sinks whose tensors must stay on the card): each
    builds a pipeline on ``dev`` fed tensors made on ``dev`` from seeded
    numpy, and returns its sinks."""
    from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.graph import Pipeline

    rng = np.random.default_rng(11)

    def caps(dims, types, rate=30):
        return Caps.tensors(TensorsConfig(TensorsInfo.from_strings(dims, types), rate))

    def on(arrs):
        return [torch.from_numpy(a).to(dev) for a in arrs]

    img = [rng.integers(0, 256, (1, 224, 224, 3)).astype(np.float32) for _ in range(8)]
    img2 = [rng.standard_normal((1, 224, 224, 3)).astype(np.float32) for _ in range(8)]
    logits = [rng.standard_normal((1, 1001)).astype(np.float32) for _ in range(8)]
    feats = [rng.standard_normal((1, 32)).astype(np.float32) for _ in range(12)]
    sparse = []
    for _ in range(6):
        a = np.zeros((1, 224, 224, 3), np.float32)
        a.reshape(-1)[rng.choice(a.size, 1500, replace=False)] = rng.standard_normal(1500)
        sparse.append(a)

    def mux_demux():
        p = Pipeline(device=dev)
        a = p.add_new("appsrc", caps=caps("3:224:224:1", "float32"), data=on(img))
        b = p.add_new("appsrc", caps=caps("1001:1", "float32"), data=on(logits))
        mux = p.add_new("tensor_mux", sync_mode="nosync")
        d = p.add_new("tensor_demux", tensorpick="1,0:1")
        s0, s1 = (p.add_new("tensor_sink", store=True) for _ in range(2))
        Pipeline.link(a, mux)
        Pipeline.link(b, mux)
        Pipeline.link(mux, d)
        Pipeline.link(d, s0)
        Pipeline.link(d, s1)
        p.run(timeout=120)
        return {"src_0": s0, "src_1": s1}

    def merge_split():
        p = Pipeline(device=dev)
        a = p.add_new("appsrc", caps=caps("3:224:224:1", "float32"), data=on(img))
        b = p.add_new("appsrc", caps=caps("3:224:224:1", "float32"), data=on(img2))
        m = p.add_new("tensor_merge", option="first", sync_mode="slowest")
        s = p.add_new("tensor_split", tensorseg="2,4", option="0")
        ref = p.add_new("tensor_split", tensorseg="4:224:100:1,4:224:124:1")
        s0, s1, s2 = (p.add_new("tensor_sink", store=True) for _ in range(3))
        Pipeline.link(a, m)
        Pipeline.link(b, m)
        Pipeline.link(m, s)
        Pipeline.link(s, s0)
        Pipeline.link(s, ref)  # a strided view, split into flat regions
        Pipeline.link(ref, s1)
        Pipeline.link(ref, s2)
        p.run(timeout=120)
        return {"split_0": s0, "flat_0": s1, "flat_1": s2}

    def aggregator():
        sinks = {}
        for key, props in (("window", dict(frames_out=4, frames_flush=2, frames_dim=1)),
                           ("frames_in", dict(frames_in=1, frames_out=3, frames_dim=0))):
            p = Pipeline(device=dev)
            src = p.add_new("appsrc", caps=caps("32:1", "float32"), data=on(feats),
                            framerate=30)
            agg = p.add_new("tensor_aggregator", **props)
            sinks[key] = p.add_new("tensor_sink", store=True)
            Pipeline.link(src, agg, sinks[key])
            p.run(timeout=120)
        return sinks

    def tensor_if():
        sinks = {}
        for key, props in (
                ("average", dict(compared_value="TENSOR_AVERAGE_VALUE",
                                 compared_value_option="0", operator="GT",
                                 supplied_value="127.5")),
                ("a_value", dict(compared_value="A_VALUE",
                                 compared_value_option="1:10:20:0:0", operator="LT",
                                 supplied_value="128"))):
            p = Pipeline(device=dev)
            src = p.add_new("appsrc", caps=caps("3:224:224:1", "float32"), data=on(img))
            tif = p.add_new("tensor_if", then="PASSTHROUGH", **props)
            tif.set_properties(**{"else": "PASSTHROUGH"})
            tif.add_src_pad("src_else")
            then, other = (p.add_new("tensor_sink", store=True) for _ in range(2))
            Pipeline.link(src, tif)
            tif.src_pads[0].link(then.sink_pad)
            tif.src_pads[1].link(other.sink_pad)
            p.run(timeout=120)
            sinks[f"{key} then"], sinks[f"{key} else"] = then, other
        return sinks

    def tensor_rate():
        sinks = {}
        for rate in ("10/1", "45/1"):
            p = Pipeline(device=dev)
            src = p.add_new("appsrc", caps=caps("32:1", "float32"), data=on(feats),
                            framerate=30)
            r = p.add_new("tensor_rate", framerate=rate, throttle=False)
            sinks[rate] = p.add_new("tensor_sink", store=True)
            Pipeline.link(src, r, sinks[rate])
            p.run(timeout=120)
        return sinks

    def sparse_codec():
        p = Pipeline(device=dev)
        src = p.add_new("appsrc", caps=caps("3:224:224:1", "float32"), data=on(sparse))
        enc = p.add_new("tensor_sparse_enc")
        tee = p.add_new("tee")
        dec = p.add_new("tensor_sparse_dec")
        wire, out = (p.add_new("tensor_sink", store=True) for _ in range(2))
        Pipeline.link(src, enc, tee)
        Pipeline.link(tee, p.add_new("queue"), wire)
        Pipeline.link(tee, p.add_new("queue"), dec, out)
        p.run(timeout=120)
        return {"wire": wire, "decoded": out}

    return {"mux/demux": (mux_demux, True), "merge/split": (merge_split, True),
            "aggregator": (aggregator, True), "tensor_if": (tensor_if, True),
            "tensor_rate": (tensor_rate, True), "sparse": (sparse_codec, False)}


def run_stream_elements(counters) -> dict:
    """Each stream element on tensors on the card, against the same
    pipeline on CPU tensors, byte for byte (data, PTS, durations, buffer
    counts); every output but the sparse codec's stays on the card."""
    counters.reset()
    cases = {dev: _stream_cases(dev) for dev in ("cuda", "cpu")}
    for name, (build, resident) in cases["cuda"].items():
        sinks = build()
        got = _record_sinks(sinks)
        want = _record_sinks(cases["cpu"][name][0]())
        if got != want:
            raise AssertionError(f"stream elements {name}: the card's outputs differ "
                                 "from the CPU's")
        where = {m.device().device.type if m.is_device else "host"
                 for s in sinks.values() for b in s.buffers for m in b.memories}
        if not all(s.buffers for s in sinks.values()) \
                or (where != {"cuda"} if resident else "cuda" in where):
            raise AssertionError(f"stream elements {name}: outputs on {where}")
        print(f"stream elements {name} on the card == on the CPU, byte for byte: "
              + ", ".join(f"{k} {len(v)} buffers" for k, v in got.items())
              + f"; outputs on {sorted(where)}", flush=True)
    return counters.read()


# --------------------------------------------------------------------------- #
# the media path (1080p video scaled on the card into SSD) and online
# fine-tuning of MobileNet-v2 hot-swapped into a serving filter
# --------------------------------------------------------------------------- #

@contextlib.contextmanager
def _scale_watch():
    """Record what ``videoscale`` pushes (its output memories, in order) and
    its host seconds a frame (``chain`` less the push downstream)."""
    from nnstreamer_tpu_torch.elements.media import VideoScale

    chain = VideoScale.chain
    out, host = [], []

    def watched(self, pad, buf):
        pushed = []
        push = self.push

        def recording_push(b, pad_index=0):
            t1 = time.perf_counter()
            out.append(b.memories[0])
            try:
                return push(b, pad_index)
            finally:
                pushed.append(time.perf_counter() - t1)

        t0 = time.perf_counter()
        self.push = recording_push
        try:
            return chain(self, pad, buf)
        finally:
            del self.push
            host.append(time.perf_counter() - t0 - sum(pushed))

    VideoScale.chain = watched
    try:
        yield out, host
    finally:
        VideoScale.chain = chain


def _media_ssd_string(frames: int, labels: str, priors: str) -> str:
    return (f"videotestsrc width=1920 height=1080 pattern=random num-buffers={frames} ! "
            "videoscale ! video/x-raw,width=300,height=300 ! videoconvert format=RGB ! "
            f'tensor_converter ! tensor_filter framework=xla-tpu model="{SSD_SPEC}" ! '
            f"tensor_decoder mode=bounding_box option1=mobilenet-ssd option2={labels} "
            f"option3={priors} option4=300:300 option5=300:300 ! tensor_sink store=true")


def check_media_elements() -> None:
    """The media conversions on tensors on the card against the same on the
    CPU, byte for byte: RGBA 1080p → 300x300 (premultiplied alpha), BGRx →
    RGB, RGB → GRAY8, and audioconvert S16LE ↔ F32LE and S16LE → U8."""
    from nnstreamer_tpu_torch.elements.media import _audio_convert, convert_pixels
    from nnstreamer_tpu_torch.ops import resample

    rng = np.random.default_rng(12)
    rgba = rng.integers(0, 256, (1080, 1920, 4), dtype=np.uint8)
    rgba[..., 3][rng.random((1080, 1920)) < 0.3] = 0
    bgrx = rng.integers(0, 256, (1080, 1920, 4), dtype=np.uint8)
    rgb = rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    cases = [("videoscale RGBA 1920x1080 -> 300x300",
              lambda x: resample.resize(x, 300, 300), rgba),
             ("videoconvert BGRx -> RGB", lambda x: convert_pixels(x, "BGRx", "RGB"), bgrx),
             ("videoconvert RGB -> GRAY8", lambda x: convert_pixels(x, "RGB", "GRAY8"), rgb)]
    s16 = rng.integers(-32768, 32768, 48000).astype(np.int16)
    s16[:2] = [-32768, 32767]
    f32 = rng.uniform(-1.2, 1.2, 48000).astype(np.float32)
    for src, dst, x in (("S16LE", "F32LE", s16), ("F32LE", "S16LE", f32),
                        ("S16LE", "U8", s16)):
        from nnstreamer_tpu_torch.core.types import AUDIO_FORMATS

        sd, dd = np.dtype(AUDIO_FORMATS[src]), np.dtype(AUDIO_FORMATS[dst])
        cases.append((f"audioconvert {src} -> {dst}",
                      lambda t, sd=sd, dd=dd: _audio_convert(t, sd, dd), x))
    for name, fn, x in cases:
        card = fn(torch.from_numpy(x).cuda())
        cpu = fn(torch.from_numpy(x))
        if card.device.type != "cuda" or card.shape != cpu.shape or card.dtype != cpu.dtype \
                or card.cpu().numpy().tobytes() != cpu.numpy().tobytes():
            raise AssertionError(f"{name}: the card's output differs from the CPU's")
        print(f"media {name} on the card == on the CPU, byte for byte: "
              f"{tuple(cpu.shape)} {str(cpu.dtype).removeprefix('torch.')}", flush=True)


def run_media_ssd(ep, tmp: str) -> dict:
    """The video path: 1920x1080 random frames through ``videoscale ! 
    video/x-raw,width=300,height=300 ! videoconvert format=RGB ! 
    tensor_converter ! tensor_filter model=SSD ! tensor_decoder
    mode=bounding_box ! tensor_sink``, parsed from its launch string on a
    card pipeline, 64 frames with CUDA graphs and 64 eagerly: every scaled
    frame on the card and byte-equal to the same element on the CPU, one
    1080p frame copied up a frame and nothing through the filter's inputs,
    ``class_reduce`` and ``nms_sweep`` once a frame, detections equal
    between the two runs."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.graph.parse import parse_pipeline
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors
    from nnstreamer_tpu_torch.ops import resample

    priors = os.path.join(tmp, "media_priors.txt")
    write_box_priors(priors, size=300)
    labels = os.path.join(tmp, "media_coco.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"c{i}" for i in range(91)))
    desc = _media_ssd_string(MEDIA_FRAMES, labels, priors)
    runs = {}
    for eager in (False, True):
        p = parse_pipeline(desc, Pipeline("media-ssd", device="cuda"))
        sink = next(e for e in p.elements.values() if e.ELEMENT_NAME == "tensor_sink")
        scale = next(e for e in p.elements.values() if e.ELEMENT_NAME == "videoscale")
        arrivals = []
        sink.new_data = lambda b, arrivals=arrivals: arrivals.append(time.perf_counter())
        with _scale_watch() as (scaled, host), _host_copies() as copies, _mode(eager):
            ep.class_reduce.launches = 0
            ep.nms_sweep.launches = 0
            p.run(timeout=600)
            torch.cuda.synchronize()
            launches = {"class_reduce": ep.class_reduce.launches,
                        "nms_sweep": ep.nms_sweep.launches}
            st = graphs.stats()
        if sink.num_buffers != MEDIA_FRAMES or len(scaled) != MEDIA_FRAMES:
            raise AssertionError(f"media ssd: {sink.num_buffers} of {MEDIA_FRAMES} out")
        if launches != {"class_reduce": MEDIA_FRAMES, "nms_sweep": MEDIA_FRAMES}:
            raise AssertionError(f"media ssd: launches {launches} for {MEDIA_FRAMES} frames")
        if any(m.device().device.type != "cuda" or tuple(m.shape) != (300, 300, 3)
               for m in scaled):
            raise AssertionError("media ssd: a scaled frame left the card")
        if scale.bytes_up != MEDIA_FRAMES * 1080 * 1920 * 3 or copies["h2d"] != 0:
            raise AssertionError(f"media ssd: {scale.bytes_up} bytes copied up by "
                                 f"videoscale and {copies} through memories for "
                                 f"{MEDIA_FRAMES} frames")
        runs[eager] = (sink, scaled, host, _steady_fps(arrivals), launches, st,
                       scale.bytes_up / MEDIA_FRAMES, dict(copies))
    sink, scaled, host, fps, launches, st, up, copies = runs[False]
    counts = [len(b.meta["detections"]) for b in sink.buffers]
    if sum(counts) == 0 or [b.meta["detections"] for b in sink.buffers] \
            != [b.meta["detections"] for b in runs[True][0].buffers]:
        raise AssertionError("media ssd: no detections, or replayed detections differ "
                             "from the eager ones")
    # the same frames scaled on the CPU
    cpu = parse_pipeline(
        f"videotestsrc width=1920 height=1080 pattern=random num-buffers={MEDIA_FRAMES} ! "
        "videoscale ! video/x-raw,width=300,height=300 ! tensor_converter ! "
        "tensor_sink store=true", Pipeline("media-cpu", device="cpu"))
    cpu.run(timeout=600)
    want = [b.memories[0].host()[0].tobytes() for b in
            next(e for e in cpu.elements.values() if e.ELEMENT_NAME == "tensor_sink").buffers]
    for frames in (scaled, runs[True][1]):
        if [m.device().cpu().numpy().tobytes() for m in frames] != want:
            raise AssertionError("media ssd: videoscale on the card differs from the CPU")
    frame = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (1080, 1920, 3), dtype=np.uint8)).cuda()
    scale_ms = _device_ms(lambda: resample.resize(frame, 300, 300))
    host_ms = float(np.median(host[1:])) * 1e3
    print(f"media -> ssd_mobilenet_v2 (1920x1080 random, videoscale to 300x300 on the "
          f"card): {MEDIA_FRAMES} frames, steady fps={fps:.2f} (eager "
          f"{runs[True][3]:.2f}); videoscale host {host_ms:.4f} ms a frame (eager run "
          f"{float(np.median(runs[True][2][1:])) * 1e3:.4f}), device {scale_ms:.6f} ms a "
          f"1080p frame; copied up {up:.0f} bytes a frame (one 1920x1080x3 frame), "
          f"memories copied up {copies['h2d']}; launches={launches}; every scaled frame "
          "on the card == the CPU's; replayed detections == eager", flush=True)
    _record_graphs("media_ssd", 1, "fps", fps, runs[True][3], st)
    LOOP_STATS["media_ssd"] = {"fps": fps, "eager_fps": runs[True][3],
                               "videoscale_host_ms": host_ms,
                               "videoscale_device_ms": scale_ms,
                               "bytes_up_per_frame": up, "memories_h2d": copies["h2d"]}
    return launches


def _ssd_hop_string(fmt, frames: int, labels: str, priors: str) -> str:
    hop = f"tensor_decoder mode={fmt} ! other/{fmt} ! tensor_converter ! " if fmt else ""
    return (f"videotestsrc width=300 height=300 pattern=random num-buffers={frames} ! "
            f"video/x-raw,format=RGB ! tensor_converter ! {hop}"
            f'tensor_filter framework=xla-tpu model="{SSD_SPEC}" ! '
            f"tensor_decoder mode=bounding_box option1=mobilenet-ssd option2={labels} "
            f"option3={priors} option4=300:300 option5=300:300 ! tensor_sink store=true")


@contextlib.contextmanager
def _codec_clock(fmt: str):
    """Host seconds of each frame's encode (the ``mode=fmt`` decoder's
    decode) and parse (the ``fmt`` converter subplugin), and each blob's
    bytes, while inside."""
    from nnstreamer_tpu_torch.converters import register_converter
    from nnstreamer_tpu_torch.core.registry import SubpluginType, get_subplugin
    from nnstreamer_tpu_torch.decoders.base import find_decoder

    cls = find_decoder(fmt)
    decode, parse = cls.decode, get_subplugin(SubpluginType.CONVERTER, fmt)
    rec = {"encode": [], "parse": [], "bytes": []}

    def timed_decode(self, buf, config):
        t0 = time.perf_counter()
        out = decode(self, buf, config)
        rec["encode"].append(time.perf_counter() - t0)
        rec["bytes"].append(out.memories[0].nbytes)
        return out

    def timed_parse(buf, props):
        t0 = time.perf_counter()
        out = parse(buf, props)
        rec["parse"].append(time.perf_counter() - t0)
        return out

    cls.decode = timed_decode
    register_converter(fmt, timed_parse)
    try:
        yield rec
    finally:
        cls.decode = decode
        register_converter(fmt, parse)


def _median_ms(xs) -> float:
    return float(np.median(xs)) * 1e3


def run_interop_hops(tmp: str, counters) -> dict:
    """A client serialising frames for a detector across a link: 300x300
    random frames ``! tensor_converter ! tensor_decoder mode=<fmt> !
    other/<fmt> ! tensor_converter ! tensor_filter model=SSD-300 !
    tensor_decoder mode=bounding_box ! tensor_sink``, 64 frames with CUDA
    graphs for each of FlexBuffers, FlatBuffers and protobuf, and the same
    frames without the hop: boxes, labels and canvases byte-equal,
    ``class_reduce`` and ``nms_sweep`` once a frame in every run. Then SSD's
    two raw outputs of one frame (the leg a server returns) through each
    format, parsed back byte-equal. Returns each hop's launches."""
    from nnstreamer_tpu_torch.converters import fb_io, protobuf_io
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.core.buffer import Buffer
    from nnstreamer_tpu_torch.core.types import TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.graph.parse import parse_pipeline
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors
    from nnstreamer_tpu_torch.models.zoo import get_model

    priors = os.path.join(tmp, "interop_priors.txt")
    write_box_priors(priors, size=300)
    labels = os.path.join(tmp, "interop_coco.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"c{i}" for i in range(91)))
    runs, by_phase = {}, {}
    for fmt in (None,) + INTEROP_FORMATS:
        p = parse_pipeline(_ssd_hop_string(fmt, INTEROP_FRAMES, labels, priors),
                           Pipeline("interop", device="cuda"))
        sink = next(e for e in p.elements.values() if e.ELEMENT_NAME == "tensor_sink")
        arrivals = []
        sink.new_data = lambda b, arrivals=arrivals: arrivals.append(time.perf_counter())
        clock = _codec_clock(fmt) if fmt else contextlib.nullcontext({})
        with clock as rec, _mode(False):
            counters.reset()
            p.run(timeout=600)
            torch.cuda.synchronize()
            launches = counters.read()
            st = graphs.stats()
        name = f"interop {fmt or 'none'}"
        if sink.num_buffers != INTEROP_FRAMES or st["replays"] < 1:
            raise AssertionError(f"{name}: {sink.num_buffers} of {INTEROP_FRAMES} frames "
                                 f"out, graphs {st}")
        if launches["class_reduce"] != INTEROP_FRAMES \
                or launches["nms_sweep"] != INTEROP_FRAMES:
            raise AssertionError(f"{name}: launches {launches} for {INTEROP_FRAMES} frames")
        if fmt and not (len(rec["encode"]) == len(rec["parse"]) == INTEROP_FRAMES):
            raise AssertionError(f"{name}: {len(rec['encode'])} encodes and "
                                 f"{len(rec['parse'])} parses for {INTEROP_FRAMES} frames")
        out = [(b.meta["detections"], b.memories[0].host().tobytes()) for b in sink.buffers]
        runs[fmt] = (out, _steady_fps(arrivals), rec)
        if fmt:
            by_phase[name] = launches
    base, base_fps, _ = runs[None]
    if sum(len(d) for d, _ in base) == 0:
        raise AssertionError("interop: no detections without the hop")
    print(f"interop none -> ssd_mobilenet_v2 300x300: {INTEROP_FRAMES} frames, steady "
          f"fps={base_fps:.2f}", flush=True)
    for fmt in INTEROP_FORMATS:
        out, fps, rec = runs[fmt]
        if out != base:
            raise AssertionError(f"interop {fmt}: boxes, labels or canvases differ from "
                                 "the path without the hop")
        stats = {"fps": fps, "fps_no_hop": base_fps,
                 "encode_host_ms": _median_ms(rec["encode"]),
                 "parse_host_ms": _median_ms(rec["parse"]),
                 "wire_bytes": int(np.median(rec["bytes"]))}
        LOOP_STATS[f"interop_{fmt}"] = stats
        print(f"interop {fmt} -> ssd_mobilenet_v2 300x300: {INTEROP_FRAMES} frames, "
              f"steady fps={fps:.2f} (no hop {base_fps:.2f}); host ms a frame: encode "
              f"{stats['encode_host_ms']:.4f}, parse {stats['parse_host_ms']:.4f}; wire "
              f"{stats['wire_bytes']} bytes a frame; launches={by_phase['interop ' + fmt]}; "
              "boxes, labels and canvases == the path without the hop", flush=True)

    # the leg a server returns: SSD's two raw outputs of one frame
    bundle = get_model(SSD_SPEC, device="cuda")
    frame = np.random.default_rng(11).integers(0, 256, (1, 300, 300, 3), dtype=np.uint8)
    with torch.inference_mode():
        outs = [t.cpu().numpy() for t in bundle.fn()(torch.from_numpy(frame).cuda())]
    buf = Buffer.of(*outs)
    cfg = TensorsConfig(TensorsInfo(tuple(m.info for m in buf.memories)), Fraction(30))
    legs = {"flexbuf": (lambda: fb_io.flexbuf_blob(buf, cfg),
                        lambda b: fb_io.flexbuf_to_frame(b)[0]),
            "flatbuf": (lambda: fb_io.flatbuf_blob(buf, cfg),
                        lambda b: fb_io.flatbuf_to_frame(b)[0]),
            "protobuf": (lambda: protobuf_io.proto_blob(buf), protobuf_io.proto_to_frame)}
    for fmt, (encode, parse) in legs.items():
        enc, par = [], []
        for _ in range(20):
            t0 = time.perf_counter()
            blob = encode()
            t1 = time.perf_counter()
            back = parse(blob)
            enc.append(t1 - t0)
            par.append(time.perf_counter() - t1)
        for a, m in zip(outs, back.memories):
            if m.host().dtype != a.dtype or m.host().tobytes() != a.tobytes():
                raise AssertionError(f"interop {fmt}: SSD's outputs came back changed")
        LOOP_STATS[f"interop_{fmt}"].update(
            outputs_wire_bytes=len(blob), outputs_encode_host_ms=_median_ms(enc),
            outputs_parse_host_ms=_median_ms(par))
        print(f"interop {fmt} SSD outputs {[a.shape for a in outs]} float32: {len(blob)} "
              f"bytes, host ms encode {_median_ms(enc):.4f}, parse {_median_ms(par):.4f}; "
              "parsed back byte-equal", flush=True)
    return by_phase


@contextlib.contextmanager
def _d2h_bytes(cls):
    """Bytes copied from the card for the inputs of ``cls.invoke`` while
    inside (a card tensor read on the host for the first time)."""
    invoke = cls.invoke
    total = [0]

    def counting_invoke(self, inputs):
        total[0] += sum(m.nbytes for m in inputs if m._host is None
                        and m.is_device and m.device().device.type == "cuda")
        return invoke(self, inputs)

    cls.invoke = counting_invoke
    try:
        yield total
    finally:
        cls.invoke = invoke


def run_python3_post(tmp: str) -> None:
    """python3 post-processing at full width: 224x224 random frames ``!
    tensor_converter ! tensor_filter model=zoo://mobilenet_v2 ! tee`` into
    ``tensor_filter framework=python3 model=<softmax script> ! tensor_sink``
    and a raw-logits sink, 32 frames: each frame's script output equals,
    byte for byte, the same numpy function on that frame's 1001 logits."""
    import importlib.util

    from nnstreamer_tpu_torch.filters.custom import Python3Filter
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.graph.parse import parse_pipeline

    script = os.path.join(tmp, "softmax_post.py")
    with open(script, "w") as f:
        f.write(PY3_SCRIPT)
    desc = (f"videotestsrc width=224 height=224 pattern=random num-buffers={PY3_FRAMES} ! "
            f'tensor_converter ! tensor_filter framework=xla-tpu model="{CLS_SPEC}" ! '
            "tee name=t ! queue ! tensor_filter name=post framework=python3 "
            f"model={script} ! tensor_sink name=probs store=true "
            "t. ! queue ! tensor_sink name=logits store=true")
    p = parse_pipeline(desc, Pipeline("python3-post", device="cuda"))
    t0 = time.perf_counter()
    with _d2h_bytes(Python3Filter) as d2h:
        p.run(timeout=600)
    wall = time.perf_counter() - t0
    post, probs, logits = (p.elements[n] for n in ("post", "probs", "logits"))
    if probs.num_buffers != PY3_FRAMES or logits.num_buffers != PY3_FRAMES:
        raise AssertionError(f"python3 post: {probs.num_buffers} and {logits.num_buffers} "
                             f"of {PY3_FRAMES} frames out")
    if post.resolved_framework != "python3" or any(
            m.device().device.type != "cuda" for b in logits.buffers for m in b.memories):
        raise AssertionError("python3 post: the logits did not come from the card")
    spec = importlib.util.spec_from_file_location("softmax_reference", script)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for i, (pb, lb) in enumerate(zip(probs.buffers, logits.buffers)):
        want = ref.softmax(np.ravel(lb.memories[0].host()))  # 1001:1:1:1 → (1001,)
        got = pb.memories[0].host()
        if got.shape != want.shape or got.dtype != want.dtype \
                or got.tobytes() != want.tobytes():
            raise AssertionError(f"python3 post: frame {i}'s output differs from numpy's")
    host_ms = post.stats.total_invoke_latency_ns / post.stats.total_invoke_num / 1e6
    LOOP_STATS["python3_post"] = {"host_ms": host_ms, "d2h_bytes": d2h[0] / PY3_FRAMES,
                                  "frames": PY3_FRAMES, "wall_s": wall}
    print(f"python3 softmax on mobilenet_v2 224's 1001 logits: {PY3_FRAMES} frames in "
          f"{wall:.3f} s, the python3 filter {host_ms:.4f} ms of host a frame, "
          f"{d2h[0] / PY3_FRAMES:.0f} bytes copied from the card a frame; every output "
          "== numpy's softmax of its frame's logits, byte for byte", flush=True)


def _serve_card_tensors(name: str, frames, **filter_props) -> list:
    """appsrc of card tensors (4:1 float32) → tensor_filter → tensor_sink on
    a card pipeline; the sink's memories."""
    from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.graph import Pipeline

    p = Pipeline(name, device="cuda")
    src = p.add_new("appsrc", data=list(frames), caps=Caps.tensors(TensorsConfig(
        TensorsInfo.from_strings("4:1", "float32"), Fraction(30))))
    filt = p.add_new("tensor_filter", **filter_props)
    sink = p.add_new("tensor_sink", store=True)
    Pipeline.link(src, filt, sink)
    p.run(timeout=120)
    if sink.num_buffers != len(frames):
        raise AssertionError(f"{name}: {sink.num_buffers} of {len(frames)} frames out")
    return [b.memories[0] for b in sink.buffers]


def run_c_filters(tmp: str) -> None:
    """framework=custom and custom-easy on card tensors: the repository's
    C scaler built with gcc here, a filter generated by
    ``nns-new-filter-torch --kind c`` and built with its Makefile, and a
    custom-easy callable returning a card tensor, which the next element
    receives on the card."""
    from nnstreamer_tpu_torch.codegen import main as new_filter
    from nnstreamer_tpu_torch.filters import register_custom_easy, unregister_custom_easy

    gen = torch.Generator(device="cuda").manual_seed(12)
    frames = [torch.randn((1, 4), generator=gen, device="cuda") for _ in range(C_FRAMES)]
    want = [f.cpu().numpy() for f in frames]
    so = os.path.join(tmp, "libscaler_filter.so")
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-I", "native",
                    "native/examples/scaler_filter.c", "-o", so],
                   check=True, capture_output=True, cwd=ROOT, timeout=120)
    out = _serve_card_tensors("c-scaler", frames, framework="custom", model=so,
                              custom=f"factor={C_FACTOR}")
    for m, w in zip(out, want):
        if m.host().tobytes() != (w * np.float32(C_FACTOR)).tobytes():
            raise AssertionError("c scaler: output is not the input times the factor")
    gen_dir = os.path.join(tmp, "generated")
    if new_filter(["smoke_scale", "--kind", "c", "--dir", gen_dir]) != 0:
        raise AssertionError("nns-new-filter-torch --kind c failed")
    subprocess.run(["make", "-C", gen_dir], check=True, capture_output=True, timeout=120)
    out = _serve_card_tensors("c-generated", frames, framework="custom",
                              model=os.path.join(gen_dir, "libsmoke_scale.so"))
    for m, w in zip(out, want):
        if m.host().tobytes() != (w * np.float32(2)).tobytes():
            raise AssertionError("generated C filter: output is not the input times 2")
    register_custom_easy("smoke_easy", lambda x: torch.from_numpy(x).cuda() * 2,
                         ("4:1", "float32"), ("4:1", "float32"))
    try:
        out = _serve_card_tensors("custom-easy", frames, framework="custom-easy",
                                  model="smoke_easy")
    finally:
        unregister_custom_easy("smoke_easy")
    if any(m.device().device.type != "cuda" or m._host is not None
           for m in out):
        raise AssertionError("custom-easy: the card tensor left the card before the sink")
    for m, w in zip(out, want):
        if m.host().tobytes() != (w * np.float32(2)).tobytes():
            raise AssertionError("custom-easy: output is not the input times 2")
    print(f"framework=custom on card tensors: native/examples/scaler_filter.c (gcc) "
          f"custom=factor={C_FACTOR} and a generated nns-new-filter-torch --kind c filter "
          f"(make) over {C_FRAMES} frames == input x factor; custom-easy's card tensor "
          "reached the sink on the card, == input x 2", flush=True)


def _train_frames(n: int, batch: int, seed: int = 5) -> list:
    """``n`` frames alternating two fixed seeded batches of ``batch`` uint8
    224x224 images with int32 labels of 1001 classes."""
    rng = np.random.default_rng(seed)
    pairs = [(rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8),
              rng.integers(0, 1001, (batch,)).astype(np.int32)) for _ in range(2)]
    return [pairs[k % 2] for k in range(n)]


def _train_pipeline(device, spec, ckpt, frames=None, serve=True, optimizer="adam"):
    """``appsrc ! tee name=t ! queue ! tensor_trainer model=spec optimizer=adam
    learning_rate=1e-3 checkpoint_path=ckpt resume=true`` and, with
    ``serve``, ``t. ! queue ! tensor_filter model=spec is-updatable=true
    input-combination=0 ! tensor_sink``. ``frames``: the appsrc's data, or
    None to push by hand; ``ckpt`` None writes no checkpoint."""
    from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.graph import Pipeline

    batch = int(spec.split("batch=")[1].split("&")[0])
    caps = Caps.tensors(TensorsConfig(TensorsInfo.from_strings(
        f"3:224:224:{batch},{batch}", "uint8,int32"), 30))
    p = Pipeline("train", device=device)
    src = p.add_new("appsrc", caps=caps, **({} if frames is None else {"data": frames}))
    tee = p.add_new("tee")
    tr = p.add_new("tensor_trainer", model=spec, optimizer=optimizer, learning_rate=1e-3,
                   **({"checkpoint_path": ckpt, "resume": True} if ckpt else {}))
    Pipeline.link(src, tee, p.add_new("queue"), tr, p.add_new("fakesink"))
    filt = sink = None
    if serve:
        filt = p.add_new("tensor_filter", framework="xla-tpu", model=spec,
                         is_updatable=True, input_combination="0")
        sink = p.add_new("tensor_sink", store=True)
        Pipeline.link(tee, p.add_new("queue"), filt, sink)
    return p, src, tr, filt, sink


def _wait_for(pred, what: str, timeout: float = 300) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"train: timed out waiting for {what}")
        time.sleep(0.005)


def run_train() -> None:
    """Online fine-tuning at full width: 24 frames of 16 images through
    ``tensor_trainer`` (MobileNet-v2 224, 1001 classes, bf16 compute, float32
    masters, adam lr 1e-3) beside a serving filter of the same zoo spec. The
    loss must fall, the zoo's shared module stay unchanged, the EOS
    checkpoint reload bit-equal to the masters with frames 24; a second
    pipeline resumes from it at 24, and its filter, hot-swapped to the first
    run's trained bundle while running, serves logits bit-equal to that
    bundle's eager forward and unlike the initial model's. Then the card
    against the CPU at float32 (TF32 off), 3 steps at batch 4."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.elements.trainer import TensorTrainer
    from nnstreamer_tpu_torch.models.zoo import get_model
    from nnstreamer_tpu_torch.utils import checkpoints

    dev = torch.device("cuda", 0)
    shared = get_model(TRAIN_SPEC, device=dev)
    before = {k: v.clone() for k, v in shared.module.state_dict().items()}
    frames = _train_frames(TRAIN_FRAMES, TRAIN_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "mobilenet_v2.msgpack")
        p, _, tr, _, sink = _train_pipeline("cuda", TRAIN_SPEC, ckpt, frames)
        steps, step = [], TensorTrainer.step

        def timed_step(self, x, y):
            t0 = time.perf_counter()
            out = step(self, x, y)
            float(out)  # the step's end, as the element reads it
            steps.append(time.perf_counter() - t0)
            return out

        torch.cuda.reset_peak_memory_stats()
        TensorTrainer.step = timed_step
        try:
            t0 = time.perf_counter()
            p.run(timeout=900)
            wall = time.perf_counter() - t0
        finally:
            TensorTrainer.step = step
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        losses = list(tr.losses)
        if tr._n != TRAIN_FRAMES or sink.num_buffers != TRAIN_FRAMES \
                or not all(np.isfinite(losses)):
            raise AssertionError(f"train: {tr._n} steps, {sink.num_buffers} served, "
                                 f"losses {losses}")
        if not np.mean(losses[-4:]) < np.mean(losses[:4]):
            raise AssertionError(f"train: the loss did not fall: {losses}")
        if not all(torch.equal(before[k], v) for k, v in shared.module.state_dict().items()):
            raise AssertionError("train: the zoo's shared module changed while training")
        blob = checkpoints.load_variables(ckpt)
        masters = [t.cpu().numpy() for t in _tree_leaves(tr.params)]
        saved = _tree_leaves(blob["params"])
        if blob["frames"] != TRAIN_FRAMES or int(blob["opt_state"]["0"]["count"]) \
                != TRAIN_FRAMES or len(saved) != len(masters) \
                or any(a.tobytes() != b.tobytes() for a, b in zip(saved, masters)):
            raise AssertionError("train: the EOS checkpoint differs from the masters")
        trained = tr.trained_bundle()
        n_masters = sum(a.size for a in masters)

        # resume, serve the initial model, hot-swap, replay
        p2, src2, tr2, filt2, sink2 = _train_pipeline("cuda", TRAIN_SPEC, ckpt)
        p2.start()
        try:
            if tr2._n != TRAIN_FRAMES:
                raise AssertionError(f"train: resumed at {tr2._n}, not {TRAIN_FRAMES}")
            src2.push_buffer(frames[0])
            _wait_for(lambda: sink2.num_buffers == 1, "the first served frame")
            filt2.update_model(trained)
            for f in frames[:2]:
                src2.push_buffer(f)
            _wait_for(lambda: sink2.num_buffers == 3, "the replayed frames")
            src2.end_of_stream()
            if not p2.wait_eos(300):
                raise AssertionError("train: the resumed pipeline did not end")
        finally:
            p2.stop()
    x = [torch.from_numpy(f[0]).to(dev) for f in frames[:2]]
    with graphs.disabled(), torch.inference_mode():
        initial = [shared.fn()(t) for t in x]
        want = [trained.fn()(t) for t in x]
    served = [b.memories[0].device() for b in sink2.buffers]
    if not _identical(served[0], initial[0]):
        raise AssertionError("train: the filter did not serve the initial model first")
    if not (_identical(served[1], want[0]) and _identical(served[2], want[1])):
        raise AssertionError("train: the swapped filter's logits differ from the trained "
                             "bundle's eager forward")
    if _identical(served[1], initial[0]):
        raise AssertionError("train: the swapped filter serves the initial weights")
    steady = steps[1:]
    step_ms = float(np.median(steady)) * 1e3
    fps = len(steady) / sum(steady)
    print(f"train mobilenet_v2 224 (1001 classes, bf16 compute, {n_masters} float32 "
          f"masters, adam lr 1e-3): {TRAIN_FRAMES} frames of {TRAIN_BATCH}, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (first 4 {np.mean(losses[:4]):.4f}, last 4 "
          f"{np.mean(losses[-4:]):.4f}); steady {fps:.2f} frames/s "
          f"({fps * TRAIN_BATCH:.1f} images/s), step {step_ms:.3f} ms (median), wall "
          f"{wall:.3f} s; peak memory {peak:.1f} MiB; zoo module unchanged; EOS "
          f"checkpoint == masters bit for bit; resumed at {TRAIN_FRAMES} (its next "
          f"losses {[round(v, 4) for v in tr2.losses]}); hot-swapped filter == trained "
          "bundle's eager forward, != the initial model", flush=True)
    LOOP_STATS["train"] = {"frames_per_s": fps, "images_per_s": fps * TRAIN_BATCH,
                           "step_ms": step_ms, "peak_mib": peak,
                           "loss_first": losses[0], "loss_last": losses[-1]}
    check_train_card_vs_cpu()


def _tree_items(tree, path: str = "") -> list:
    """A nested dict's (path, leaf) pairs, keys sorted at each level (jax's
    order)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _tree_items(tree[k], f"{path}/{k}" if path else k)]
    return [(path, tree)]


def _tree_leaves(tree) -> list:
    """A nested dict's leaves, keys sorted at each level (jax's order)."""
    return [leaf for _, leaf in _tree_items(tree)]


def _change_gaps(start: list, card: list, cpu: list) -> list:
    """Each leaf's change from ``start``, the card's against the CPU's:
    |card − cpu| / |cpu − start| in the 2-norm (0 where neither moved)."""
    out = []
    for s, a, b in zip(start, card, cpu):
        gap = float(np.linalg.norm((a - s) - (b - s)))
        moved = float(np.linalg.norm(b - s))
        out.append(0.0 if gap == 0 else gap / moved if moved else float("inf"))
    return out


def _started_trainer(dev: str, optimizer: str):
    """A ``tensor_trainer`` of TRAIN_CHECK_SPEC started on ``dev``."""
    from nnstreamer_tpu_torch.elements.trainer import TensorTrainer

    tr = TensorTrainer(model=TRAIN_CHECK_SPEC, optimizer=optimizer, learning_rate=1e-3)
    tr.set_default_device(dev)
    tr.start()
    return tr


def check_train_card_vs_cpu() -> None:
    """The same element on the card and on the CPU at float32 with TF32 off:
    3 steps at batch 4 of MobileNet-v2 224 from the same seeded weights,
    with adam and with sgd. Losses within TRAIN_LOSS_RTOL. Masters: every
    leaf's change within TRAIN_CHANGE_RTOL of the CPU's (``_change_gaps``),
    and the same check must reject three faults made of this run's card
    masters: the update skipped, its sign flipped, the leaf that moved most
    left at its start. sgd's masters also within TRAIN_SGD_ATOL, which the
    two devices' gradient sums set. adam moves an element by about lr a
    step whatever its gradient's size, so two devices whose gradients differ
    in sign move it 2·lr apart; ``_adam_steps_apart`` shows how far apart
    the two runs drift, step by step."""
    frames = _train_frames(TRAIN_CHECK_STEPS, 4, seed=9)
    for opt in ("adam", "sgd"):
        start = [t.cpu().numpy() for t in _tree_leaves(_started_trainer("cpu", opt).params)]
        got = {}
        for dev in ("cuda", "cpu"):
            p, _, tr, _, _ = _train_pipeline(dev, TRAIN_CHECK_SPEC, None, frames,
                                             serve=False, optimizer=opt)
            p.run(timeout=900)
            got[dev] = (np.array(tr.losses),
                        [t.cpu().numpy() for t in _tree_leaves(tr.params)])
        (cl, cm), (hl, hm) = got["cuda"], got["cpu"]
        paths = [path for path, _ in _tree_items(tr.params)]
        loss_err = float(np.max(np.abs(cl - hl) / np.abs(hl)))
        gaps = _change_gaps(start, cm, hm)
        top = int(np.argmax(gaps))
        moved = int(np.argmax([np.linalg.norm(b - s) for s, b in zip(start, hm)]))
        faults = {"update skipped": start, "sign flipped": [2 * s - a for s, a in zip(start, cm)],
                  f"{paths[moved]} left out": [s if k == moved else a for k, (s, a)
                                               in enumerate(zip(start, cm))]}
        fault_gaps = {name: max(_change_gaps(start, f, hm)) for name, f in faults.items()}
        diffs = [np.abs(a - b) for a, b in zip(cm, hm)]
        worst = max(float(d.max()) for d in diffs)
        far = sum(int((d > 1e-5).sum()) for d in diffs)
        total = sum(d.size for d in diffs)
        print(f"train card vs CPU ({opt}, float32, TF32 off, {TRAIN_CHECK_STEPS} steps "
              f"at batch 4): losses {cl.tolist()} vs {hl.tolist()}, max rel err "
              f"{loss_err:.3e} (bound {TRAIN_LOSS_RTOL}); change gap max {gaps[top]:.3e} "
              f"({paths[top]}; median {float(np.median(gaps)):.3e}, bound {TRAIN_CHANGE_RTOL}); the "
              "check on faults: " + ", ".join(f"{k} {v:.3f}" for k, v in fault_gaps.items())
              + f"; masters max abs err {worst:.3e}, {far} of {total} beyond 1e-5",
              flush=True)
        if loss_err > TRAIN_LOSS_RTOL or gaps[top] > TRAIN_CHANGE_RTOL \
                or (opt == "sgd" and worst > TRAIN_SGD_ATOL):
            raise AssertionError(f"train ({opt}): the card leaves the CPU beyond the "
                                 "stated bounds")
        if min(fault_gaps.values()) <= TRAIN_CHANGE_RTOL:
            raise AssertionError(f"train ({opt}): the masters' check passes a fault")
        stats = {"loss_rel_err": loss_err, "change_gap_max": gaps[top],
                 "change_gap_leaf": paths[top], "fault_gaps": fault_gaps,
                 "master_max_abs_err": worst, "beyond_1e-5": far, "elements": total}
        if opt == "adam":
            stats["steps"] = _adam_steps_apart(frames)
        LOOP_STATS[f"train_card_vs_cpu_{opt}"] = stats


def _adam_steps_apart(frames) -> list:
    """adam's 3 steps again on both devices, each trainer stepping from its
    own masters: for each step, the two devices' gradients before it (their
    relative difference, the elements whose two gradients differ in sign)
    and the masters beyond 1e-5 apart after it."""
    trainers = {dev: _started_trainer(dev, "adam") for dev in ("cuda", "cpu")}
    rows = []
    for k, frame in enumerate(frames):
        grads, masters = {}, {}
        for dev, tr in trainers.items():
            x, y = (torch.from_numpy(a).to(dev) for a in frame)
            grads[dev] = tr.gradient(x, y)[1].cpu().numpy()
            tr.step(x, y)
            masters[dev] = tr._masters.flat.cpu().numpy()
        gc, gh = grads["cuda"], grads["cpu"]
        split = np.sign(gc) * np.sign(gh) < 0
        far = np.abs(masters["cuda"] - masters["cpu"]) > 1e-5
        rows.append({"step": k + 1,
                     "grad_rel_err": float(np.linalg.norm(gc - gh) / np.linalg.norm(gh)),
                     "grad_sign_split": int(split.sum()),
                     "beyond_1e-5_after": int(far.sum()),
                     "split_and_beyond": int((split & far).sum())})
    print("train card vs CPU (adam), step by step: " + "; ".join(
        f"step {r['step']}: gradients rel err {r['grad_rel_err']:.3e}, "
        f"{r['grad_sign_split']} of other signs, then {r['beyond_1e-5_after']} masters "
        f"beyond 1e-5 ({r['split_and_beyond']} of them split)" for r in rows), flush=True)
    return rows


# --------------------------------------------------------------------------- #
# the multi-tenant card: N pipelines and an LM engine on one DeviceEngine
# --------------------------------------------------------------------------- #

@contextlib.contextmanager
def _card_busy():
    """The card's busy share while inside: nvidia-smi's utilization.gpu (the
    share of each sample period in which a kernel ran) sampled every 100 ms;
    yields a list that holds the samples (percent) after the block."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    samples: list = []
    try:
        yield samples
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        samples.extend(int(v) for v in out.split() if v.strip().isdigit())


def _mt_tenants(engine, opts: dict, mixed: bool) -> dict:
    """The tenants of the multi-tenant phase as pipelines on ``engine``
    (None: each dispatches directly): MT_PIPES MobileNet-v2 224 streams and,
    when ``mixed``, MT_SSD fused SSD-300 streams, each sink recording its
    arrivals."""
    from nnstreamer_tpu_torch.graph import Pipeline

    built = {"cls": [], "ssd": []}
    for kind, n, frames in (("cls", MT_PIPES, MT_FRAMES),
                            ("ssd", MT_SSD if mixed else 0, MT_SSD_FRAMES)):
        for i in range(n):
            p = Pipeline(f"{kind}{i}", scheduler=engine)
            size = MT_SIZE if kind == "cls" else MT_SSD_SIZE
            src = p.add_new("videotestsrc", width=size, height=size, pattern="random",
                            seed=(7 if kind == "cls" else 100) + i, num_buffers=frames)
            filt = p.add_new("tensor_filter", name=f"{kind}{i}", framework="torch-cuda",
                             model=MT_SPEC if kind == "cls" else SSD_SPEC)
            els = [src, p.add_new("tensor_converter"), filt]
            if kind == "ssd":
                els.append(p.add_new("tensor_decoder", mode="bounding_box", **opts))
            arrivals = []
            sink = p.add_new("tensor_sink", store=True,
                             new_data=lambda b, a=arrivals: a.append(time.perf_counter()))
            Pipeline.link(*els, sink)
            built[kind].append((p, filt, sink, arrivals))
    return built


def _mt_requests() -> list:
    """run_lm_serving's 24-request greedy mix."""
    rng = np.random.default_rng(5)
    return [(rng.integers(0, LM_DIMS[0], LM_PROMPTS[i % len(LM_PROMPTS)]).astype(np.int32),
             LM_GENS[i % len(LM_GENS)]) for i in range(LM_REQUESTS)]


def _mt_run(params, opts: dict, counters, engine, mixed: bool) -> dict:
    """One run of every tenant at once: the pipelines started together and,
    when ``mixed``, the LM engine (enrolled on ``engine`` when there is one)
    serving the mix from a thread of its own. Returns the outputs, rates and
    counts."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.serving import LMEngine

    built = _mt_tenants(engine, opts, mixed)
    lm = LMEngine(params, LM_DIMS[2], LM_MAX_LEN, n_slots=LM_SLOTS, chunk=LM_CHUNK) \
        if mixed else None
    if engine is not None and lm is not None:
        lm.enroll(engine)
    batches = []
    if engine is not None:
        dispatch = engine._dispatch

        def timed_dispatch(batch):
            c0, t0 = graphs.stats()["captures"], time.perf_counter()
            out = dispatch(batch)
            batches.append((batch[0].label, len(batch), t0, time.perf_counter(),
                            graphs.stats()["captures"] - c0))
            return out

        engine._dispatch = timed_dispatch
    served: dict = {"lm": None}

    def serve():
        try:
            if lm is not None:
                served["lm"] = _serve(params, _mt_requests(), LM_SLOTS, lm)
        except BaseException as e:  # noqa: BLE001 — reported by the caller
            served["error"] = e

    pipes = [b for kind in ("cls", "ssd") for b in built[kind]]
    counters.reset()
    graphs.reset_stats()
    with _card_busy() as busy:
        t_start = time.perf_counter()
        lm_thread = threading.Thread(target=serve, name="mt-lm", daemon=True)
        lm_thread.start()
        for p, _, _, _ in pipes:
            p.start()
        try:
            for p, _, _, _ in pipes:
                if not p.wait_eos(600) or p.bus.error is not None:
                    raise AssertionError(f"multi-tenant: {p.name} did not reach EOS "
                                         f"({p.bus.error})")
            lm_thread.join(900)
            if lm_thread.is_alive() or "error" in served:
                raise AssertionError(f"multi-tenant: the LM engine did not finish "
                                     f"({served.get('error')})")
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            run = {"launches": counters.read(), "graphs": graphs.stats(),
                   "lm": served["lm"], "t": (t_start, t_end)}
            if engine is not None:
                # read before stop() detaches the tenants
                run["waits"] = {t.name: list(t.waits) for t in engine.tenants()}
                run["occupancy"] = engine.occupancy()
                run["widths"] = engine.coalesce_stats()
                run["stats"] = dict(engine.stats)
                if lm is not None:
                    lm.unenroll()
        finally:
            for p, _, _, _ in pipes:
                p.stop()
    run["busy"] = busy
    run["batches"] = batches
    run["cls"] = [([b.memories[0].device().float() for b in sink.buffers], arrivals,
                   filt.stats.total_invoke_num) for _, filt, sink, arrivals in built["cls"]]
    run["ssd"] = [([(b.meta["detections"], b.memories[0].host().tobytes())
                    for b in sink.buffers], filt.stats.total_invoke_num)
                  for _, filt, sink, _ in built["ssd"]]
    return run


def _engine_steady_fps(run) -> float:
    """Merged MobileNet frames/s of an engine run, the batches that captured
    a graph (each width's first) left out with their time: the frames of the
    other MobileNet batches over the time from the start to the last
    MobileNet arrival, less the capturing batches' dispatch time."""
    t_start, _ = run["t"]
    t_end = max(a[-1] for _, a, _ in run["cls"])
    items = sum(w for label, w, _, _, c in run["batches"]
                if label.startswith("cls") and c == 0)
    capture_s = sum(t1 - t0 for _, _, t0, t1, c in run["batches"]
                    if c > 0 and t0 < t_end)
    return items / (t_end - t_start - capture_s)


def _dispatch_s(run) -> dict:
    """Seconds the dispatch loop spent in each tenant kind's batches."""
    out: dict = {}
    for label, _, t0, t1, _ in run["batches"]:
        kind = "lm" if label.endswith(".step") else label.rstrip("0123456789")
        out[kind] = out.get(kind, 0.0) + t1 - t0
    return out


def _direct_steady_fps(streams) -> float:
    """Merged frames/s of streams without an engine, each stream's first
    frame (its capture) left out: the frames that arrive after the last
    stream's first one, over the time from it to the last arrival."""
    start = max(a[0] for a in streams)
    after = sorted(t for a in streams for t in a if t > start)
    return len(after) / (after[-1] - start)


def run_multitenant(params, counters, tmp: str) -> dict:
    """bench.py's _multiplex_lane at full width, with an SSD pair and the LM
    engine beside it, on one DeviceEngine and then without it; then the CLI
    with --sched. Returns the engine run's kernel launches."""
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors
    from nnstreamer_tpu_torch.models.zoo import get_model
    from nnstreamer_tpu_torch.sched import DeviceEngine

    priors = os.path.join(tmp, "mt_priors.txt")
    write_box_priors(priors, size=MT_SSD_SIZE)
    labels = os.path.join(tmp, "mt_coco.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"c{i}" for i in range(91)))
    opts = dict(option1="mobilenet-ssd", option2=labels, option3=priors,
                option4=f"{MT_SSD_SIZE}:{MT_SSD_SIZE}",
                option5=f"{MT_SSD_SIZE}:{MT_SSD_SIZE}")
    get_model(MT_SPEC, device="cuda")  # model builds outside both runs
    get_model(SSD_SPEC, device="cuda")

    # the MobileNet streams alone (bench.py's lane), then every tenant at once
    runs = {}
    for mixed in (False, True):
        runs[mixed, "direct"] = _mt_run(params, opts, counters, None, mixed)
        engine = DeviceEngine("smoke", max_coalesce=MT_COALESCE)
        try:
            runs[mixed, "engine"] = _mt_run(params, opts, counters, engine, mixed)
        finally:
            engine.stop()
    direct, multi = runs[True, "direct"], runs[True, "engine"]

    # every tenant's results equal its run without the engine
    n_cls = MT_PIPES * MT_FRAMES
    worst, label_diff = 0.0, 0
    for other in (runs[False, "engine"], runs[False, "direct"], multi):
        for (got, _, _), (want, _, _) in zip(other["cls"], direct["cls"]):
            if len(got) != MT_FRAMES or len(want) != MT_FRAMES:
                raise AssertionError(f"multi-tenant: {len(got)} / {len(want)} of "
                                     f"{MT_FRAMES} MobileNet frames out")
            for x, y in zip(got, want):
                label_diff += int(x.argmax(-1).item() != y.argmax(-1).item())
                worst = max(worst, _max_abs_err(x, y))
    if label_diff:
        raise AssertionError(f"multi-tenant: {label_diff} MobileNet labels differ "
                             "from the run without the engine")
    ssd_frames = MT_SSD * MT_SSD_FRAMES
    for (got, _), (want, _) in zip(multi["ssd"], direct["ssd"]):
        if got != want or len(got) != MT_SSD_FRAMES:
            raise AssertionError("multi-tenant: SSD boxes or canvases differ from the "
                                 "run without the engine")
    for name, run in (("engine", multi), ("direct", direct)):
        for k in ("class_reduce", "nms_sweep"):
            if run["launches"][k] != ssd_frames:
                raise AssertionError(f"multi-tenant {name}: {k} launched "
                                     f"{run['launches'][k]} times for {ssd_frames} "
                                     "SSD frames")
    lm_tokens, lm_want = multi["lm"][0], direct["lm"][0]
    if lm_tokens != lm_want:
        first = next(i for i, (a, b) in enumerate(zip(lm_tokens, lm_want)) if a != b)
        raise AssertionError(f"multi-tenant: the enrolled LM engine's request {first} "
                             "differs from its run without the engine")

    # rates: the engine runs leave out the batches that captured a graph
    # (each width's first, and their time); the direct runs each stream's first
    multi_fps = _engine_steady_fps(multi)
    direct_fps = _direct_steady_fps([a for _, a, _ in direct["cls"]])
    alone_fps = _engine_steady_fps(runs[False, "engine"])
    alone_direct_fps = _direct_steady_fps([a for _, a, _ in runs[False, "direct"]["cls"]])
    alone_ws = runs[False, "engine"]["widths"]
    captures: dict = {}
    for label, width, _, _, c in multi["batches"]:
        if c:
            kind = "lm" if label.endswith(".step") else label.rstrip("0123456789")
            captures[f"{kind} x{width}"] = captures.get(f"{kind} x{width}", 0) + c
    waits = sorted(w for name, ws in multi["waits"].items() if name.startswith("cls")
                   for w in ws)
    lm_waits = sorted(multi["waits"].get("lm", [0.0]))
    ws = multi["widths"]
    busy = {k: (sum(r["busy"]) / len(r["busy"]) / 100 if r["busy"] else None)
            for k, r in (("engine", multi), ("direct", direct))}
    ssd_invokes = sum(n for _, n in multi["ssd"]) / ssd_frames
    tokens = sum(len(o) for o in lm_tokens)
    lm_tps = {k: tokens / r["lm"][2] for k, r in (("engine", multi), ("direct", direct))}

    def share(v):
        return "not measured" if v is None else f"{v:.4f}"

    def busy_of(run):
        return share(sum(run["busy"]) / len(run["busy"]) / 100 if run["busy"] else None)

    print(f"multi-tenant card, the {MT_PIPES} MobileNet-v2 224 streams alone "
          f"({MT_FRAMES} frames each): merged steady frames/s "
          f"{alone_fps:.2f} on the engine, {alone_direct_fps:.2f} without it; coalesce "
          f"width median {alone_ws['median']:.1f} mean {alone_ws['mean']:.3f} max "
          f"{alone_ws['max']} over {alone_ws['n']} batches; occupancy "
          f"{runs[False, 'engine']['occupancy']:.4f}; card busy share "
          f"{busy_of(runs[False, 'engine'])} (without the engine "
          f"{busy_of(runs[False, 'direct'])})", flush=True)

    print(f"multi-tenant card ({MT_PIPES} x MobileNet-v2 224 {MT_FRAMES} frames, "
          f"{MT_SSD} x SSD-300 fused {MT_SSD_FRAMES} frames, the float32 LM engine "
          f"serving {LM_REQUESTS} requests; DeviceEngine max_coalesce {MT_COALESCE}): "
          f"MobileNet merged steady frames/s {multi_fps:.2f} on the engine (batches "
          f"that captured left out), {direct_fps:.2f} without it (each stream's first "
          f"frame left out); coalesce width median {ws['median']:.1f} mean "
          f"{ws['mean']:.3f} max {ws['max']} over {ws['n']} batches; occupancy "
          f"{multi['occupancy']:.4f}; MobileNet tenant wait median "
          f"{waits[len(waits) // 2] * 1e3:.3f} ms max {waits[-1] * 1e3:.3f} ms, LM "
          f"wait median {lm_waits[len(lm_waits) // 2] * 1e3:.3f} ms max "
          f"{lm_waits[-1] * 1e3:.3f} ms; captures by width {json.dumps(captures)}; card "
          f"busy share {share(busy['engine'])} (without the engine "
          f"{share(busy['direct'])}; nvidia-smi utilization.gpu every 100 ms); dispatch "
          f"loop seconds by tenant {json.dumps(_dispatch_s(multi))} of a "
          f"{multi['t'][1] - multi['t'][0]:.3f} s run ({direct['t'][1] - direct['t'][0]:.3f} "
          f"s without the engine)", flush=True)
    print(f"multi-tenant results: all {n_cls} MobileNet labels of each run == the "
          f"mixed run without the engine, logits' largest difference {worst:.9g}; SSD boxes and canvases "
          f"byte-equal to it, {ssd_invokes:.3f} invokes a frame, class_reduce "
          f"{multi['launches']['class_reduce']} and nms_sweep "
          f"{multi['launches']['nms_sweep']} launches for {ssd_frames} frames, coalesce "
          f"fallbacks {multi['stats']['coalesce_fallbacks']}; the enrolled LM engine's "
          f"{tokens} tokens == its run without the engine, {lm_tps['engine']:.2f} "
          f"tokens/s (without the engine {lm_tps['direct']:.2f}); engine stats "
          f"{json.dumps(multi['stats'])}", flush=True)
    LOOP_STATS["multi_tenant"] = {
        "fps": multi_fps, "direct_fps": direct_fps, "alone_fps": alone_fps,
        "alone_direct_fps": alone_direct_fps, "alone_width": alone_ws, "width": ws,
        "occupancy": multi["occupancy"], "wait_median_ms": waits[len(waits) // 2] * 1e3,
        "wait_max_ms": waits[-1] * 1e3, "captures_by_width": captures,
        "busy_share": busy, "logits_max_diff": worst, "lm_tokens_per_s": lm_tps,
        "fallbacks": multi["stats"]["coalesce_fallbacks"]}

    # the CLI as a user runs it, on the card, in a process of its own
    hl_labels = os.path.join(tmp, "mt_labels.txt")
    with open(hl_labels, "w") as f:
        f.write("\n".join(f"l{i}" for i in range(1001)))
    launch = HEADLINE.replace(
        "videotestsrc", f"videotestsrc num-buffers={HEADLINE_FRAMES} pattern=random "
        "width=224 height=224").replace("labels.txt", hl_labels)
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "nnstreamer_tpu_torch.cli", "--sched",
                          str(MT_COALESCE), "--sched-tenants", "cam:2", launch],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    sched_lines = [ln for ln in cli.stderr.splitlines() if ln.startswith("sched: ")
                   and "batches /" in ln]
    if cli.returncode != 0 or not sched_lines:
        raise AssertionError(f"nns-launch --sched exited {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    print(f"nns-launch --sched {MT_COALESCE} --sched-tenants cam:2 (the README string, "
          f"{HEADLINE_FRAMES} frames): exit 0 in {time.perf_counter() - t0:.3f} s, "
          f"{sched_lines[-1]}", flush=True)
    return multi["launches"]


# --------------------------------------------------------------------------- #
# obs: metrics, tracing, health, events and the profiler on the card
# --------------------------------------------------------------------------- #

def _release() -> None:
    """Collect what the last run left in reference cycles (an engine and
    its programs hold each other) and hand the cached blocks back, so the
    graph pools of finished runs do not crowd the phases after them."""
    gc.collect()
    torch.cuda.empty_cache()


def _obs_all_off() -> None:
    """Every obs switch off and every ring, store and registry of
    components emptied: where an obs-off run starts (the CLI leaves the
    switches its flags turned on)."""
    from nnstreamer_tpu_torch import obs
    from nnstreamer_tpu_torch.obs import events, health, profile, tracing

    # the profiler's records stay (the kernel labels accumulate over the
    # phase); each run reads its own by time
    profile.disable()
    events.disable()
    events.ring().reset()
    tracing.disable()
    tracing.store().reset()
    health.disable()
    health.registry().reset()
    obs.disable()


def _hooks_off() -> None:
    """Fail unless every obs hook is None (obs off costs a None check)."""
    from nnstreamer_tpu_torch.graph import element as gel
    from nnstreamer_tpu_torch.obs import profile
    from nnstreamer_tpu_torch.ops import epilogue as epi

    hooks = {"DISPATCH_HOOK": profile.DISPATCH_HOOK,
             "ENGINE_HOOK": profile.ENGINE_HOOK,
             "KERNEL_HOOK": profile.KERNEL_HOOK, "SCHED_HOOK": profile.SCHED_HOOK,
             "PROFILE_CHAIN_HOOK": gel.PROFILE_CHAIN_HOOK,
             "EPILOGUE_SELECT_HOOK": epi.EPILOGUE_SELECT_HOOK}
    on = sorted(k for k, v in hooks.items() if v is not None)
    if on:
        raise AssertionError(f"obs off but hooks installed: {on}")


class _Scraper:
    """A thread GETting ``routes`` from an exporter in a loop until the
    ``with`` block ends: every answer's route, status and whether
    ``playing()`` held before and after it, and each route's last 200 body.
    ``port()`` is None until the exporter is up."""

    def __init__(self, port, routes, playing) -> None:
        self.port, self.routes, self.playing = port, routes, playing
        self.answers, self.last = [], {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="obs-scraper")

    def _loop(self) -> None:
        import urllib.error
        import urllib.request

        while not self._stop.is_set():
            port = self.port()
            if port is None:
                time.sleep(0.002)
                continue
            for route in self.routes:
                before = self.playing()
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                                timeout=30) as r:
                        code, body = r.status, r.read()
                except urllib.error.HTTPError as e:
                    code, body = e.code, e.read()
                except OSError:  # the exporter closed under the request
                    code, body = None, b""
                self.answers.append((route, code, before and self.playing()))
                if code == 200:
                    self.last[route] = body
            time.sleep(OBS_SCRAPE_PAUSE_S)

    def __enter__(self) -> "_Scraper":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(60)
        if self._thread.is_alive():
            raise AssertionError("obs scraper thread did not stop")

    def while_playing(self, route) -> list:
        return [code for r, code, playing in self.answers
                if r == route and playing]


@contextlib.contextmanager
def _cli_objects():
    """The pipeline and exporter a CLI run builds, recorded as it builds
    them (the CLI hands neither back)."""
    from nnstreamer_tpu_torch.graph import parse as parse_mod
    from nnstreamer_tpu_torch.obs import exporter as exp_mod

    box = {}
    parse, start = parse_mod.parse_pipeline, exp_mod.start_exporter

    def parsing(*a, **kw):
        box["pipeline"] = parse(*a, **kw)
        return box["pipeline"]

    def starting(*a, **kw):
        box["exporter"] = start(*a, **kw)
        return box["exporter"]

    parse_mod.parse_pipeline, exp_mod.start_exporter = parsing, starting
    try:
        yield box
    finally:
        parse_mod.parse_pipeline, exp_mod.start_exporter = parse, start


@contextlib.contextmanager
def _kept_programs():
    """The composed invoke (a ``CapturedFn`` and its graphs) of every
    filter closed while inside, kept past the close that drops it."""
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter

    kept = []
    close = TorchCudaFilter.close

    def keeping(self):
        kept.append(self._fn)
        close(self)

    TorchCudaFilter.close = keeping
    try:
        yield kept
    finally:
        TorchCudaFilter.close = close


@contextlib.contextmanager
def _arrivals(cls):
    """The time each buffer reaches an element of class ``cls``."""
    times = []
    chain = cls.chain

    def timed(self, pad, buf):
        times.append(time.perf_counter())
        return chain(self, pad, buf)

    cls.chain = timed
    try:
        yield times
    finally:
        cls.chain = chain


def _replay_ms(graph, n: int = 50) -> float:
    """Device ms of one replay of a captured graph, ``n`` back to back
    between two CUDA events."""
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _obs_ssd_turn(tmp: str, labels: str, priors: str, on: bool, scrape: bool,
                  tag: str, counters) -> dict:
    """bench.py's ssd_mobilenet_300_fps string through the CLI, obs on
    (``--metrics-port 0 --trace --watchdog --profile --events-dump``) or
    off; with ``scrape``, a second thread scrapes the exporter while frames
    flow. Returns what the run showed."""
    from nnstreamer_tpu_torch.cli import main as cli
    from nnstreamer_tpu_torch.elements.sinks import TensorSink

    _obs_all_off()
    _hooks_off()
    launch = (f"videotestsrc width=300 height=300 pattern=random "
              f"num-buffers={OBS_SSD_FRAMES} ! tensor_converter name=conv_{tag} ! "
              f'tensor_filter name=filt_{tag} framework=xla-tpu model="{SSD_SPEC}" ! '
              f"tensor_decoder name=dec_{tag} mode=bounding_box option1=mobilenet-ssd "
              f"option2={labels} option3={priors} option4=300:300 option5=300:300 "
              f"async-depth=64 ! tensor_sink name=sink_{tag} store=true")
    events_path = os.path.join(tmp, f"events_{tag}.jsonl")
    # the stall threshold sits above a first frame's warm-up and capture
    # (seconds: the profiler counts that warm-up's FLOPs op by op), which
    # the watchdog would rightly call a stall at its 5 s default
    flags = ["--metrics-port", "0", "--trace", "--watchdog", str(OBS_STALL_S),
             "--profile", "--events-dump", events_path] if on else []
    with _cli_objects() as box, _decoder_inputs() as rows, \
            _arrivals(TensorSink) as arrivals, _kept_programs() as programs:
        exporter = lambda: box["exporter"].port if "exporter" in box else None  # noqa
        playing = lambda: "pipeline" in box and box["pipeline"].running  # noqa
        scraper = _Scraper(exporter, OBS_ROUTES, playing)
        counters.reset()
        t_start, t_cli = time.monotonic_ns(), time.perf_counter()
        with scraper if scrape else contextlib.nullcontext():
            rc = cli(flags + [launch])
        torch.cuda.synchronize()
        launches = counters.read()
    if rc != 0:
        raise AssertionError(f"obs {tag}: nns-launch exited {rc}")
    p = box["pipeline"]
    sink = p.get_by_name(f"sink_{tag}")
    if sink.num_buffers != OBS_SSD_FRAMES or p._epilogue_count != 1 \
            or launches["class_reduce"] != OBS_SSD_FRAMES \
            or launches["nms_sweep"] != OBS_SSD_FRAMES:
        raise AssertionError(f"obs {tag}: {sink.num_buffers} frames out, "
                             f"{p._epilogue_count} epilogues fused, launches {launches}")
    return dict(p=p, tag=tag, t_start=t_start, programs=programs,
                dets=[b.meta["detections"] for b in sink.buffers],
                rows=_memories(rows), fps=_steady_fps(arrivals), launches=launches,
                first_s=arrivals[0] - t_cli,
                scraper=scraper if scrape else None, events_path=events_path)


def _check_obs_ssd(run: dict) -> dict:
    """The obs-on SSD run's telemetry: the filter's buffer counter, one
    pipeline.element span per element per frame, every route 200 while the
    pipeline played (a scraped run), the Perfetto JSON's device lanes (as
    scraped, and as the profiler renders it after the run), every sampled
    dispatch's event-timed device time; and the sampled invoke against the
    filter's own graph replayed. Returns the numbers."""
    from nnstreamer_tpu_torch import obs
    from nnstreamer_tpu_torch.obs import profile, tracing

    tag, frames = run["tag"], OBS_SSD_FRAMES
    els = [f"{k}_{tag}" for k in ("conv", "filt", "dec", "sink")]
    series = obs.registry().snapshot()["nnstpu_pipeline_buffers_total"]["series"]
    bufs = {s["labels"]["element"]: s["value"] for s in series
            if s["labels"]["element"] in els}
    if bufs != {el: frames for el in els}:
        raise AssertionError(f"obs {tag}: nnstpu_pipeline_buffers_total {bufs}")
    spans = {}
    for summ in tracing.store().summaries():
        for sp in tracing.store().spans_of(summ["trace_id"]):
            if sp.name == "pipeline.element":
                el = sp.attrs.get("element")
                spans[el] = spans.get(el, 0) + 1
    if {el: spans.get(el, 0) for el in els} != {el: frames for el in els}:
        raise AssertionError(f"obs {tag}: pipeline.element spans by element {spans}")
    sc = run["scraper"]
    traces = [json.loads(json.dumps(profile.perfetto_trace()))]
    if sc is not None:
        for route in OBS_ROUTES:
            codes = sc.while_playing(route)
            if not codes or any(c != 200 for c in codes):
                raise AssertionError(f"obs {tag}: {route} while playing answered "
                                     f"{codes}")
        traces.append(json.loads(sc.last["/debug/profile"]))
    for trace in traces:
        lanes = {e["args"]["name"] for e in trace["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "thread_name" and e["pid"] == 2}
        for k in ("class_reduce", "nms_sweep"):
            if not any(k in lane for lane in lanes):
                raise AssertionError(f"obs {tag}: no {k} device lane in "
                                     f"{sorted(lanes)}")
    recs = [r for r in profile.profiler().records("dispatch")
            if r["t0_ns"] >= run["t_start"]]
    sampled = [r for r in recs[1:] if r["device_ns"] is not None]  # [0]: capture
    if len(recs) != frames or not sampled:
        raise AssertionError(f"obs {tag}: {len(recs)} dispatch records, "
                             f"{len(sampled)} sampled")
    for r in sampled:
        if not 0 < r["device_ns"] <= r["dur_ns"] + r["args"]["wait_ns"]:
            raise AssertionError(f"obs {tag}: sampled device_ns {r['device_ns']} "
                                 f"outside (0, {r['dur_ns']} + {r['args']['wait_ns']}]")
    graphs_ = [g for fn in run["programs"] for g in fn._graphs.values()]
    if len(graphs_) != 1:
        raise AssertionError(f"obs {tag}: {len(graphs_)} invoke graphs")
    invoke_ms = float(np.median([r["device_ns"] for r in sampled])) / 1e6
    replay_ms = _replay_ms(graphs_[0].graph)
    return dict(invoke_ms=invoke_ms, replay_ms=replay_ms, sampled=len(sampled),
                scrapes=len(sc.answers) if sc is not None else 0,
                host_ms=float(np.median([r["dur_ns"] for r in sampled])) / 1e6,
                wait_ms=float(np.median([r["args"]["wait_ns"] for r in sampled])) / 1e6)


def _series_of(snap, prefix: str, label: str = "lm") -> dict:
    return {name: s["value"] for name, fam in snap.items()
            if name.startswith(prefix) and fam["type"] != "histogram"
            for s in fam["series"] if s["labels"].get("engine") == label}


def _obs_lm_turn(qparams, requests, again, on: bool, scrape: bool,
                 counters) -> dict:
    """bench.py's paged serving lane, w8a8, on a new 32-slot paged engine:
    the mix (its captures included) then a second mix (replays only). With
    obs on (metrics, tracing, health, events, the profiler at its default
    cadence and an exporter on port 0) a second thread scrapes /metrics in
    a loop through the engine's captures when ``scrape``."""
    from nnstreamer_tpu_torch import obs
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.obs import events, health, profile, tracing

    _obs_all_off()
    _hooks_off()
    exporter = None
    if on:
        obs.enable()
        tracing.enable()
        health.enable()
        events.enable()
        profile.enable()
        exporter = obs.start_exporter(port=0)
    state = {"serving": False}
    scraper = _Scraper(lambda: exporter.port, ("/metrics", "/healthz"),
                       lambda: state["serving"])
    before = _series_of(obs.registry().snapshot(), "nnstpu_serving_kv_")
    graphs.reset_stats()
    try:
        with scraper if scrape else contextlib.nullcontext():
            time.sleep(0.05 if scrape else 0.0)
            state["serving"] = True
            eng = _paged_engine(qparams, PAGED_SLOTS)
            counters.reset()
            outs, stats, wall, eng = _serve(qparams, requests, PAGED_SLOTS, eng)
            launches = counters.read()
            outs2, _, wall2, eng = _serve(qparams, again, PAGED_SLOTS, eng)
            state["serving"] = False
            captures = graphs.stats()["captures"]
    finally:
        if exporter is not None:
            exporter.close()
    tokens, tokens2 = sum(len(o) for o in outs), sum(len(o) for o in outs2)
    return dict(outs=outs, outs2=outs2, eng=eng, launches=launches, stats=stats,
                rate=tokens / wall, rate2=tokens2 / wall2, captures=captures,
                before=before, scraper=scraper if scrape else None)


def _check_obs_lm(run: dict) -> dict:
    """The obs-on paged run's telemetry: the nnstpu_serving_kv_* gauges and
    counters equal the engine's kv_stats, ENGINE_HOOK records for prefill
    and decode, a cuda.dequant_gelu_requant kernel record, /metrics
    answered 200 through the run's captures with the slot gauge read
    mid-run."""
    from nnstreamer_tpu_torch import obs
    from nnstreamer_tpu_torch.obs import profile

    eng, kv = run["eng"], run["eng"].kv_stats
    after = _series_of(obs.registry().snapshot(), "nnstpu_serving_kv_")
    d = {k: v - run["before"].get(k, 0) for k, v in after.items()}
    want = {"nnstpu_serving_kv_prefix_hit_total": kv["hit_tokens"],
            "nnstpu_serving_kv_evict_total": kv["evictions"],
            "nnstpu_serving_kv_offload_total": kv["offloads"],
            "nnstpu_serving_kv_reupload_total": kv["reuploads"]}
    gauges = {"nnstpu_serving_kv_total_pages": PAGED_POOL,
              "nnstpu_serving_kv_used_pages": eng._kv.used_pages(),
              "nnstpu_serving_kv_shared_pages": eng._kv.shared_pages()}
    got = {k: d.get(k) for k in want} | {k: after.get(k) for k in gauges}
    if got != want | gauges:
        raise AssertionError(f"obs lm: kv series {got} != kv_stats {want | gauges}")
    labels = {r["label"] for r in profile.profiler().records("engine")}
    kernels = {r["label"] for r in profile.profiler().records("kernel")}
    if not {"lm.prefill", "lm.decode"} <= labels \
            or "cuda.dequant_gelu_requant" not in kernels:
        raise AssertionError(f"obs lm: engine records {sorted(labels)}, kernel "
                             f"records {sorted(kernels)}")
    sc = run["scraper"]
    codes = sc.while_playing("/metrics") if sc is not None else [200]
    if not codes or any(c != 200 for c in codes) or run["captures"] < 1:
        raise AssertionError(f"obs lm: /metrics during the run {codes[:8]}..., "
                             f"captures {run['captures']}")
    return dict(scrapes=len(codes) if sc is not None else 0, kv=got,
                captures=run["captures"])


def run_obs(qparams, counters) -> dict:
    """The obs base and the profiler on the card, at full width: SSD-300
    through the CLI with every obs flag and bench.py's paged w8a8 serving
    lane with metrics, tracing and the profiler on, each against the same
    run with obs off, in turns (off, on, off, on; outputs bit-equal); the
    last kernel labels (gpu_smoke, two flash bf16 prefill batches, one
    fused DeepLab-v3 frame); what obs costs. Returns the launches of the
    obs-on runs."""
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors
    from nnstreamer_tpu_torch.obs import profile

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        priors = os.path.join(tmp, "box_priors.txt")
        write_box_priors(priors, size=300)
        labels = os.path.join(tmp, "coco.txt")
        with open(labels, "w") as f:
            f.write("\n".join(f"c{i}" for i in range(91)))
        ssd = {True: [], False: []}
        for i, on in enumerate(OBS_TURNS):
            run = _obs_ssd_turn(tmp, labels, priors, on, i == 1, f"t{i}", counters)
            if on:
                run["obs"] = _check_obs_ssd(run)
                launches[f"obs ssd {i}"] = run["launches"]
                with open(run["events_path"]) as fh:
                    types = [json.loads(ln)["type"] for ln in fh]
                if types.count("pipeline.state") != 2:
                    raise AssertionError(f"obs ssd: events {types[:20]}")
            del run["programs"], run["p"]
            _release()
            ssd[on].append(run)
        ref = ssd[False][0]
        for run in ssd[True] + ssd[False][1:]:
            if run["dets"] != ref["dets"] or not _all_identical(run["rows"], ref["rows"]):
                raise AssertionError(f"obs ssd {run['tag']}: boxes differ from the "
                                     "obs-off run")
        for run in ssd[True]:
            o = run["obs"]
            scraped = (f"{o['scrapes']} scrapes of {len(OBS_ROUTES)} routes while "
                       "frames flowed, every one 200 while playing" if o["scrapes"]
                       else "not scraped (a cost turn)")
            print(f"obs ssd {run['tag']} (bench.py's ssd_mobilenet_300_fps string, "
                  f"{OBS_SSD_FRAMES} frames, CLI --metrics-port 0 --trace --watchdog "
                  f"{OBS_STALL_S} --profile --events-dump): boxes and reduce rows == the obs-off run; "
                  f"nnstpu_pipeline_buffers_total == {OBS_SSD_FRAMES} for each element, "
                  f"one pipeline.element span per element per frame; {scraped}; device "
                  f"lanes class_reduce and nms_sweep in the Perfetto JSON; "
                  f"{o['sampled']} sampled invokes, "
                  f"event-timed device {o['invoke_ms']:.4f} ms (median; host "
                  f"{o['host_ms']:.4f}, wait {o['wait_ms']:.4f}) against the same "
                  f"CUDA graph replayed {o['replay_ms']:.4f} ms, ratio "
                  f"{o['invoke_ms'] / o['replay_ms']:.4f}", flush=True)
    profile.disable()

    requests, again = _paged_requests(7), _paged_requests(8)
    lm = {True: [], False: []}
    for i, on in enumerate(OBS_TURNS):
        run = _obs_lm_turn(qparams, requests, again, on, i == 1, counters)
        if on:
            run["obs"] = _check_obs_lm(run)
            launches[f"obs lm w8a8 {i}"] = run["launches"]
        lm[on].append(run)
        del run["eng"]
        _release()
    ref = lm[False][0]
    for run in lm[True] + lm[False][1:]:
        if run["outs"] != ref["outs"] or run["outs2"] != ref["outs2"]:
            raise AssertionError("obs lm: tokens differ from the obs-off run")
    for run in lm[True]:
        o = run["obs"]
        print(f"obs lm paged w8a8 ({PAGED_SLOTS} slots, {PAGED_POOL} pages of "
              f"{PAGE_SIZE}, {PAGED_REQUESTS} requests; metrics, tracing, health, "
              f"events, profile): tokens == the obs-off run on both mixes; "
              f"nnstpu_serving_kv_* == kv_stats {json.dumps(o['kv'])}; "
              + (f"{o['scrapes']} /metrics scrapes answered 200 while serving, "
                 f"through {o['captures']} graph captures" if o["scrapes"]
                 else f"not scraped (a cost turn), {o['captures']} captures")
              + "; prefill and decode engine records, a "
              f"cuda.dequant_gelu_requant kernel record", flush=True)
    _obs_all_off()

    # the last kernel labels: gpu_smoke, two flash bf16 prefill batches, one
    # fused DeepLab-v3 frame, under the profiler (its records kept from above)
    from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.models.causal_lm import prefill_bundle
    from nnstreamer_tpu_torch.utils.probes import gpu_smoke

    profile.enable()
    counters.reset()
    gpu_smoke()
    v, _, h, _ = LM_DIMS
    bf16 = _lm_params(torch.bfloat16)
    rng = np.random.default_rng(3)
    p = Pipeline("obs-prefill")
    src = p.add_new("appsrc", caps=Caps.tensors(TensorsConfig(TensorsInfo.from_strings(
        f"{FLASH_T}:{FLASH_B}", "int32"))), data=[
            rng.integers(0, v, (FLASH_B, FLASH_T)).astype(np.int32) for _ in range(2)])
    filt = p.add_new("tensor_filter", framework="torch-cuda", model=prefill_bundle(
        bf16, h, FLASH_T, FLASH_B, flash=True))
    Pipeline.link(src, filt, p.add_new("tensor_sink"))
    p.run(timeout=600)
    del bf16, p, filt
    _release()
    seg, _, seg_sink, _ = _seg_pipeline(SEG_SPEC, 1)
    seg.run(timeout=600)
    torch.cuda.synchronize()
    launches["obs labels"] = counters.read()
    kernels = {r["label"] for r in profile.profiler().records("kernel")}
    want = {f"cuda.{k}" for k in ("class_reduce", "nms_sweep", "segment_colorize",
                                  "flash_attention", "dequant_gelu_requant",
                                  "normalize_u8", "quantize_affine")}
    if not want <= kernels or seg_sink.num_buffers != 1:
        raise AssertionError(f"obs: kernel records {sorted(kernels)} lack "
                             f"{sorted(want - kernels)}")
    print(f"obs kernel labels: all seven recorded ({sorted(want)})", flush=True)
    _obs_all_off()
    _hooks_off()

    card = _card()
    cost = {"ssd_fps": {"off": [r["fps"] for r in ssd[False]],
                        "on": [r["fps"] for r in ssd[True]]},
            "lm_tokens_per_s": {"off": [r["rate"] for r in lm[False]],
                                "on": [r["rate"] for r in lm[True]]},
            "lm_tokens_per_s_second_mix": {"off": [r["rate2"] for r in lm[False]],
                                           "on": [r["rate2"] for r in lm[True]]},
            "ssd_first_frame_s": {"off": [r["first_s"] for r in ssd[False]],
                                  "on": [r["first_s"] for r in ssd[True]]},
            "invoke_vs_replay": [(r["obs"]["invoke_ms"], r["obs"]["replay_ms"])
                                 for r in ssd[True]],
            "card": card}
    print(f"obs cost ({card}), turns off/on (scraped)/off/on: SSD-300 steady "
          f"frames/s off "
          f"{cost['ssd_fps']['off']}, on {cost['ssd_fps']['on']} (seconds from the "
          f"CLI call to the first frame off {cost['ssd_first_frame_s']['off']}, on "
          f"{cost['ssd_first_frame_s']['on']}); w8a8 paged lane "
          f"tokens/s on new engines off {cost['lm_tokens_per_s']['off']}, on "
          f"{cost['lm_tokens_per_s']['on']}, second mix off "
          f"{cost['lm_tokens_per_s_second_mix']['off']}, on "
          f"{cost['lm_tokens_per_s_second_mix']['on']}; every output bit-equal",
          flush=True)
    LOOP_STATS["obs"] = cost
    return launches


def _card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


class _Counters:
    """The kernels' launch counts: set all to 0, read all."""

    def __init__(self, wrappers) -> None:
        self.wrappers = wrappers

    def reset(self) -> None:
        for w in self.wrappers.values():
            w.launches = 0

    def read(self) -> dict:
        return {name: w.launches for name, w in self.wrappers.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import nnstreamer_tpu_torch  # noqa: F401 — fails outside the repo
    from nnstreamer_tpu_torch.models.causal_lm import quantize_lm_params
    from nnstreamer_tpu_torch.ops.kernels import build
    from nnstreamer_tpu_torch.ops.kernels import epilogue as ep
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa
    from nnstreamer_tpu_torch.ops.kernels import preprocess as pp

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(sorted(logs)) or 'cached'})", flush=True)
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    print(_card(), flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    settle = _settle_timing(dev)
    print("timing warm-up, the launch floor's first three readings (ms): "
          + ", ".join(f"{t:.6f}" for t in settle), flush=True)
    kernels = [check_class_reduce(ep, dev, rng), check_nms_sweep(ep, dev, rng),
               check_segment_colorize(ep, dev, rng),
               check_flash_attention(fa, dev, rng),
               check_dequant_gelu_requant(ep, dev, rng), check_normalize_u8(pp, dev, rng),
               check_quantize_affine(pp, dev, rng)]
    check_box_modes(ep)
    check_mlp(ep, dev, rng)
    check_preprocess_repair()
    module = {"flash_attention": fa, "normalize_u8": pp, "quantize_affine": pp}
    counters = _Counters({k["name"]: getattr(module.get(k["name"], ep), k["name"])
                          for k in kernels})

    with tempfile.TemporaryDirectory() as tmp:
        launches = run_detection(ep, tmp)
        run_classification(tmp)
        by_phase = run_headline(tmp, counters)
    by_phase.update({"ssd": dict(launches),
                     "deeplab fused": {"segment_colorize": run_segmentation(ep)},
                     "deeplab batched": {"segment_colorize": run_batched_segmentation(ep)}})
    run_pose()
    by_phase["gpu_smoke"] = run_gpu_smoke(counters)
    params = _lm_params()
    by_phase["lm serving float32"] = run_lm_serving(params, "float32", counters)
    by_phase["lm serving w8a8"] = run_lm_serving(quantize_lm_params(params), "w8a8",
                                                 counters)
    by_phase["lm paged float32"] = run_lm_paged(params, "float32", counters)
    by_phase["lm paged w8a8"] = run_lm_paged(quantize_lm_params(params), "w8a8", counters)
    with tempfile.TemporaryDirectory() as tmp:
        by_phase["multi-tenant"] = run_multitenant(params, counters, tmp)
    by_phase.update(run_obs(quantize_lm_params(params), counters))
    _release()
    del params
    by_phase["lm flash prefill"] = run_flash_prefill(counters, torch.bfloat16)
    by_phase["lm flash prefill float32"] = run_flash_prefill(counters, torch.float32)
    run_filter_options()
    by_phase["repo_lstm"] = run_repo_lstm(counters)
    by_phase["crop_bucketed"] = run_crop_bucketed(counters)
    by_phase["stream_elements"] = run_stream_elements(counters)
    check_media_elements()
    with tempfile.TemporaryDirectory() as tmp:
        by_phase["media_ssd"] = run_media_ssd(ep, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        by_phase.update(run_interop_hops(tmp, counters))
        counters.reset()
        run_python3_post(tmp)
        by_phase["python3 post"] = counters.read()
        counters.reset()
        run_c_filters(tmp)
        by_phase["c filters"] = counters.read()
    counters.reset()
    run_train()
    by_phase["train"] = counters.read()
    print(f"card, beside the numbers below: {_card()}", flush=True)
    print(f"launches by path: {json.dumps(by_phase)}", flush=True)
    print(f"graphs by path: {json.dumps(GRAPH_PATHS)}", flush=True)
    print(f"stream paths: {json.dumps(LOOP_STATS)}", flush=True)
    for k in kernels:
        k["launches"] = sum(phase.get(k["name"], 0) for phase in by_phase.values())

    print(json.dumps({"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}
        for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
