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
     heads, d_ff 4096) and 4 of its 8 layers (LM_DIMS; seeded random
     weights): ``LMEngine`` with
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
 12b. the query and resilience layers, every server in-process on
     127.0.0.1 port 0: (a) SSD-300 behind ``tensor_query_serversrc !
     tensor_filter ! tensor_decoder mode=bounding_box !
     tensor_query_serversink`` with 300x300 RGB frames from an appsrc
     client, 8 warm-up frames then 64 sync and 64 pipelined (async_depth
     32), with graphs and eagerly: every RGBA byte-equal to the same frames
     without the hop, the reduce fused on the server and ``class_reduce``
     and ``nms_sweep`` once a frame, the host copies a frame those of the
     path without the hop; frames/s, round trip p50, wire bytes and host ms
     to encode and decode; (b) two such servers behind ``backends=A,B``
     with ``hedge_ms``: a seeded partition of A mid-stream (failover, A's
     breaker open, ``router.failover``), the healed net (A serves again
     after its half-open probe), a seeded delay on A (hedges onto B win;
     A's connection answers in protocol sync after), no frame lost and
     every RGBA equal; (c) a server running the filter alone and a client
     decoding on its side with ``fallback=`` a callable over the same zoo
     bundle: a partition of every backend sends a stretch of frames to the
     local filter on the card (each one reduce on the card, RGBA equal to
     the direct path's), the remote ones decode on the host (no launch;
     RGBA equal or, where the host's float math moves a pixel, boxes within
     run_detection's tolerance), health DEGRADED then OK with "remote path
     restored"; (d) BASELINE.json config 5, the repo-LSTM loop behind the
     hop (24 sync frames, 16 + 192 pipelined): every output byte-equal to
     the loop without the hop on the same frames, one host-to-card and one
     card-to-host copy a frame; (e) 8 frames each over MQTT (the built-in
     broker), discovery (``operation=`` into (a)'s server) and gRPC
     ``idl=flex`` and ``protobuf`` when grpcio is present (printed either
     way); (f) ``python -m nnstreamer_tpu_torch.cli --backends A,B
     --hedge-ms 5 --deadline-ms 2000 --fallback passthrough`` with a
     one-fault ``NNS_TPU_CHAOS`` plan against (b)'s servers: exit 0, the
     chaos line, its RGBA frames equal to the direct path's;
 12c. sessions and the fleet, every worker in-process on 127.0.0.1 port 0,
     the bench LM at max_len 512, chunk 16, pages of 32, 2 slots an engine:
     (a) bench.py's disaggregated serving lane at full width, float32 and
     w8a8: a ``role="prefill"`` DisaggWorker ships its KV pages over
     ``KV_PAGE_XFER`` to a ``role="decode"`` one for 32 requests sharing a
     128-token prefix (prompts 160-256, 32 tokens each), two passes (cold,
     with the captures; warm): every request token-equal to a unified
     engine run request at a time, pages sent == received, no re-prefill,
     ``dequant_gelu_requant`` launched on the w8a8 prefill, decode and
     unified engines and never on float32's; tokens/s both ways, hit
     rates, pages and bytes a request, the first request's time, peak
     memory; then the host ms of each transfer stage (gather, copy to the
     host, encode, wire round trip, decode, upload) for a 256-token
     prompt's 8 pages; (b) the w8a8 prefill worker killed: 8 fresh-prefix
     requests re-prefilled on the decode worker under their deadlines,
     token-equal, 8 ``disagg.reprefill`` events; a PageSpiller pass whose
     pages the neighbour's next shared-prefix request hits; (c) bench.py's
     fleet lane at full width in w8a8: 4 workers, 16 sessions x 4 turns,
     halved twice at the middle turn through SessionMigrator: goodput ratio
     1.0, every turn equal to the unhalved run's; (e) on the unhalved run's
     workers, an aggregator on an exporter fed over the query wire and
     HTTP: every worker's series under its instance label, the fleet
     rollups, a silent worker stalled and recovered, a page transfer's
     trace stitched, a shared-prefix request placed on its holder; (d)
     bench.py's restore lane at the same widths: neighbour checkpoints,
     the busiest worker killed, its sessions restored warm and their next
     turns equal to an uncrashed engine's, restore seconds, warm ratio and
     the checkpoint overhead ratio; (f) ``python -m nnstreamer_tpu_torch.cli
     --role decode --kv-page-size 32 --obs-push wire --obs-aggregate
     --metrics-port 0 --checkpoint-dir DIR --autoscale 1:2 --backends A,B``
     over two SSD-300 query servers: exit 0 and the JAX CLI's fleet lines;
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
     memory; a ``checkpoint_path=<dir> resume=true`` cycle over 4 of the
     frames: the EOS orbax directory equal to the masters, a second
     pipeline resuming at frame 4 with masters and adam's moments
     bit-equal to the directory's; then the element on the card against the CPU at float32 (TF32
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
 19b. the parallel layer (``run_parallel``), ranks started by
     nnstreamer_tpu_torch/parallel/launch.py on the card: B5 timed at the
     shapes the ring and a2a prefill launch (residual float32 at a shard
     pair, full and causal; normalised float32 at the a2a shape); (a) the
     LM serving mix of phase 9 (over gloo its first 10 requests,
     PAR_GLOO_REQUESTS) through ``TPLMEngine`` at model 2 and 4
     (gloo, the ranks sharing the card, eager) and model 1 (NCCL, CUDA
     graphs and eagerly), float32 and w8a8, against the single-card
     ``LMEngine`` on the card: w8a8 tokens and the first-token logits of
     the first 4 prompts equal bit for bit, float32 tokens equal or each
     flip printed with the single-card top-2 margin where it happened;
     tokens/s, lockstep checks, and a clocked decode step's collective ms
     by operation (gloo on one card, not NVLink); (b) ``lm_prefill(mesh=)``
     of one 1024-token prompt over sp 4 in the ring, ring-flash, a2a and
     a2a-flash modes against the single-card prefill (logits and K/V within
     SP_TOL of the mode, 16 greedy tokens equal), B5 launched 8·4·5/2 = 80 times across
     the ranks on ring-flash and 8·4 = 32 on a2a-flash; (c)
     ``make_tp_prefill`` → ``make_tp_generate`` for 10 steps at model 4,
     float32 and w8a8, against the single-card window prefill and steps;
     (d) at ``dryrun_multichip``'s sizes on 4 ranks, GPipe over 4 stages,
     MoE over data 2 × expert 2, the sharded train step of MobileNet-v2
     0.25/32/16 classes over data 2 × model 2 for 3 steps, a checkpoint
     saved at (2, 2) and restored at (4, 1) then stepped, each equal to its
     single-rank oracle, and the trainer with ``mesh=data:2`` on 2 ranks
     equal to the unsharded trainer;
 19c. LeNet-5 (``zoo://lenet``, the ``mnist`` alias's model) on 16 GRAY8
     28x28 frames and MobileNet-v1 224 on 8 frames through
     ``image_labeling``, each label the model's own argmax and the replayed
     logits and labels equal to the eager run's; the stream transformer at
     its zoo defaults (seq 256, dim 128, bf16) behind ``tensor_aggregator``
     over 4 windows, replayed == eager, within ST_PIPE_TOL of the float32
     model;
 19d. sharded serving (``run_sharded``, in run_parallel's 4-rank gloo group
     and its 1-rank NCCL group): B5 timed at the shapes below (with the
     ring rows of 19b); (a) full-width MobileNet-v2 (float32, batch 8)
     through ``parallel.sharded_bundle`` over data 2 x model 2 behind
     ``tensor_query`` (``parallel/composite.py``: rank 0 serves, the others
     follow) over 16 batches, each within rtol 2e-4 / atol 2e-5 of the
     unsharded bundle on the card with labels equal, batches/s and round
     trip p50 beside the direct unsharded filter's; uneven batches of 9, 5
     and 1 and a reload to seed 7 through the leader's filter, with the
     collectives' ms an invoke; the failover check (the session stopped
     before frame 2, a new one on the same port); and the composite once on
     the 1-rank NCCL group; (b) the stream transformer (layers 2, dim 128,
     heads 8, seq 4096, float32) over sp 4 in ring, ring-flash, a2a and
     a2a-flash within rtol 5e-3 / atol 5e-4 of the single-card forward, B5
     launched 2·4·4 = 32 times across the ranks on ring-flash and 2·4 = 8 on
     a2a-flash; (c) the MoE transformer (8 experts, capacity 1.25, float32):
     ``ep_bundle`` over data 2 x expert 2 through the filter at seq 256,
     batch 2, within rtol 2e-4 / atol 2e-5, and ``make_sp_ep_infer`` over
     sp 2 x expert 2 at seq 4096 in ring-flash (B5 2·2·4 = 16 launches) and
     a2a-flash (8), expert counts and dropped tokens equal to the
     single-card run's;
 19c. the model files (``run_model_files``, after the convnets): (a)
     SSD-300 at full width restored from a ``.msgpack`` the port wrote from
     a seed-1 tree, through the README's detection pipeline
     (``model=<ckpt> custom="arch=zoo://ssd_mobilenet_v2"``) over 32 frames
     with graphs and eagerly: ``class_reduce`` and ``nms_sweep`` launched
     once a frame, detections bit-equal to the same weights loaded
     in-process (``convert.load_flax``) in both modes and unequal to the
     seed-0 bundle's; (a') the same tree written by the port as an orbax
     directory (utils/orbax_dir.py), served through ``model=<dir>`` over
     the same 32 frames in both modes: B2 and B3 once a frame, detections
     bit-equal to (a)'s, the directory's leaves bit-equal to the
     ``.msgpack``'s, its bytes, save and load seconds and zstd's MB/s
     printed; (b) MobileNet-v1 1.0/224/1001 behind
     ``custom="quant=w8"`` through image_labeling over 16 frames, captured
     and eager: the codes and scales computed on the card bit-equal to the
     CPU's from the same tree, labels equal between the modes and to the
     quantized logits' argmax, frames/s and ``params_nbytes`` printed; (c)
     LeNet and MobileNet-v2 at full width, exported by ``export_model`` in a
     CPU process (started with the phase, beside (a) and (b)), served from
     ``model=<x>.jaxexport`` on the card through a CUDA graph, against the
     zoo bundle on the card (LeNet rtol 1e-5 / atol 1e-6, MobileNet-v2's
     bf16 logits within 1e-2 of their scale; bit-equality printed); (d)
     ``framework=torch`` and ``framework=pytorch`` through nns-launch on the
     reference's pytorch string, once on a TorchScript LeNet scripted in the
     phase (within rtol 1e-5 / atol 1e-6 of its eager module) and once on
     the hand-built legacy zip (``write_legacy_lenet``; bit-equal to its
     eager module), both on the card; (e) the orbax directory the JAX
     package wrote (``tests/data/orbax_lenet_seed1``, orbax 0.11.32) read
     here bit-equal to its ``.msgpack`` twin, and LeNet served from each
     over 16 GRAY8 frames with equal labels and logits; then the phase's
     seconds beside the card's name and power limit;
 19d. the TensorFlow side (``run_tflite``, after the model files), on
     ``.tflite`` files this script writes with the port's own FlatBuffers
     and FlexBuffers builders (``write_ssd_mobilenet_v2_tflite``,
     ``write_mobilenet_v2_quant_tflite``; seeded weights): (a)
     ssd_mobilenet_v2_coco 300x300 float32 (1917 anchors,
     ``TFLite_Detection_PostProcess`` fast path, 90 classes) through
     ``tensor_filter framework=tensorflow2-lite ! tensor_decoder
     mode=bounding_box option1=mobilenet-ssd-postprocess`` over 32 frames
     with graphs and eagerly: ``class_reduce`` once and ``nms_sweep`` twice
     a frame (the post-process's K 1917 sweep, the decoder's K 10), decoder
     inputs and detections bit-equal between the modes, 4 frames'
     post-process on the card equal to the same file on the CPU in count
     and classes (boxes and scores within rtol 1e-4 / atol 1e-5), the two
     kernels inside the op equal to their plain versions on the op's own
     inputs, ``nms_sweep`` at K 1917 timed beside its bound, its plain
     version and the phase split at K 1917; (b) MobileNet-v2 224 uint8 in the reference's quant layout
     through ``framework=tensorflow-lite`` and image_labeling over 32
     frames, graphs == eager, 4 frames' codes on the card against the CPU's
     (labels equal, at most one step on at most 2%); (c)
     ``framework=tensorflow``: with TensorFlow installed a GraphDef built
     here through nns-launch, its output on the card equal to
     ``Session.run`` and no card memory taken by TensorFlow, else the
     ``ImportError`` naming it from ``open()``; the load seconds, frames/s
     and the phase's seconds printed;
 19e. the examples (``run_examples``, after the parallel layer): each of
     ``examples/<name>_torch.py`` by its ``main`` on the card at its own
     defaults (classify_stream: 100 random 224x224 frames through
     MobileNet-v2 width 1.0; adaptive_batch_serving: 400 frames at batch
     16; deploy_serve, remote_offload, mqtt_fanout, online_finetune,
     serve_lm with its w8a8 engine, streaming_generate's 24 tokens through
     the repo loop), what each prints checked (counts, labels, tokens,
     ``served 8 frames``), and its seconds printed; serve_reference_models
     on the reference's file names built here (the quantized MobileNet-v2
     224 ``.tflite``, the legacy TorchScript LeNet): the label and digit
     equal to the CPU's, the ``.pb`` block skipped (no TensorFlow on this
     machine); the kernels' launches over the nine (``dequant_gelu_requant``
     must launch); then the repairs: the repo accumulator loop through
     ``tensor_mux`` rerun EXAMPLES_LOOP_RUNS times with no stall,
     ``tensor_batch``'s health probe read by the watchdog,
     ``SingleShot(accelerator="true:gpu")`` on the card, and
     ``core/data.py``'s casts (in range equal to the CPU's); the phase's
     seconds;
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
128-column chunks), ``nms_sweep`` bit for bit at K 1 to 4097 (past the
shared-memory relation at K 1025, 1917, 2048 and 4097) and on IoUs that sit
exactly on or one float above the threshold, with the launch floor (a
one-element fill replayed as the kernel is) beside its bound and the phase
split of ``scripts/nms_phase_split.py`` at K 256, 1917 and 2048, and
``dequant_gelu_requant`` (R 1,
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
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zipfile
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

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
#: the bench LM (bench.py _LM_DIMS): vocab, d_model, heads, layers; its
#: full width, and 4 of its 8 layers (a depth cut that keeps the script
#: within its time on the slower machines: the same script ran 982-1227 s
#: by machine at 8; every path of this LM here runs at this depth, the
#: fleet's, the obs phases' and the parallel phase's too)
LM_DIMS = (8192, 1024, 16, 4)
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
#: run_obs_layers: the obs layers on the base (slo, diag, quality, tune);
#: the routes scraped while SSD-300 plays; the CLI pipeline's name, which is
#: its tenant on the DeviceEngine; an objective it meets, and one (1 ms)
#: below the paged lane's latency; every 8th paged request (8 of 64) comes
#: with a deadline already expired at submit; one session per prefix group
LAYER_ROUTES = ("/metrics", "/healthz", "/debug/slo", "/debug/quality",
                "/debug/tune", "/debug/diag/critpath", "/debug/bundles")
LAYER_TENANT, LAYER_SSD_P99_MS, LAYER_LM_P99_MS = "pipeline", 10000.0, 1.0
LAYER_SHED_EVERY, LAYER_SESSION = 8, "prefix0"
#: the confidence triple against its plain float64 computation
CONF_TOL = (1e-5, 1e-6)
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
#: the orbax-directory resume cycle (check_train_dir_resume): frames of its
#: first run
TRAIN_DIR_FRAMES = 4
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


def _nms_split_text(k: int) -> str:
    """The phase split's numbers at K, as ``check_nms_sweep`` read them."""
    got = NMS_SPLIT[k]
    return (", ".join(f"{name} {us:.3f} us" for name, us in got["phases_us"].items())
            + f"; sweep {got['sweep_us_a_chunk']:.4f} us a chunk of {got['chunks']}"
            " (the phase split's random boxes)")


def check_nms_sweep(ep, dev, rng) -> dict:
    def run_both(cols, iou, thr, name):
        got = ep.nms_sweep(*cols, iou_threshold=iou, threshold=thr)
        want = ep.nms_sweep_plain(*cols, iou_threshold=iou, threshold=thr)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"nms_sweep differs from plain: {name}")

    # K 1000 and up: past the earlier one-block kernel's limit (512); past
    # the shared-memory relation (1024) the global route, at the TFLite
    # SSD's 1917 and at 4097, five tiles a row
    for k in (1, 7, 33, 64, 256, 300, 512, 1000, 1024, 1025, 1917, 2048, 4097):
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
    split = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "nms_phase_split.py"),
                            "--k", "256", "1917", "2048", "--json"],
                           capture_output=True, text=True, timeout=300)
    if split.returncode != 0:
        raise AssertionError(f"nms_phase_split failed:\n{split.stderr[-3000:]}")
    for line in split.stdout.splitlines():
        if line.startswith("nms_phase_split: "):
            got = json.loads(line.split(": ", 1)[1])
            NMS_SPLIT[got["k"]] = got
        else:
            print(line, flush=True)
    print(f"nms_sweep K={k} device ms/call (CUDA graph): kernel={ms:.6f} "
          f"plain={plain_ms:.6f} library=none; eager ms/call: kernel={eager_ms:.6f} "
          f"plain={eager_plain_ms:.6f}; bound_ms={bound:.8f} ({by}), launch floor "
          f"{floor_ms:.6f} (a one-element fill_ replayed the same way); K=2048 "
          f"kernel={big_ms:.6f} (== plain; {_nms_split_text(2048)}); {_card()}", flush=True)
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
#: seconds by phase of main, in order (``_PhaseClock``)
PHASE_SECONDS = {}
#: ``scripts/nms_phase_split.py``'s phases by K, from ``check_nms_sweep``
NMS_SPLIT = {}


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


#: the query hop (phase 12b): SSD-300 served behind tensor_query on the card
QUERY_DEVICE = "cuda"
QUERY_SRV_DIMS = "3:300:300:1"
#: (a): warm-up frames, then the timed frames, sync and pipelined
#: (bench.py's client and serversink async_depth 32)
QUERY_WARM, QUERY_FRAMES, QUERY_DEPTH = 8, 64, 32
#: (b): healthy frames, then a partition of backend A for as many, then the
#: healed net for as many; then up to QUERY_HEDGE_MAX frames under a
#: delay fault on A; the hedge floor is above a healthy round trip so only
#: the delay fault hedges
QUERY_ROUTED_STEP, QUERY_HEDGE_MAX = 12, 16
QUERY_HEDGE_MS, QUERY_DELAY_S, QUERY_RESET_S = 50.0, 0.4, 0.5
#: (c): remote frames, then a partition of every backend (the fallback's
#: stretch), then remote again
QUERY_FB_REMOTE, QUERY_FB_STRETCH = 4, 8
#: (d): the composite (bench.py:264-330): sync frames for the round trip,
#: then pipelined warm-up and timed frames
QUERY_LSTM_SYNC = 24
#: (e) and (f): frames a transport hop, and the CLI run's source seed
QUERY_HOP_FRAMES, QUERY_CLI_SEED = 8, 29


def _qcaps():
    from nnstreamer_tpu_torch.core.types import Caps

    return Caps("video/x-raw", {"format": "RGB", "width": 300, "height": 300,
                                "framerate": Fraction(30)})


def _query_frames(n: int, seed: int = 31) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (300, 300, 3), dtype=np.uint8) for _ in range(n)]


def _ssd_opts(tmp: str) -> dict:
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors

    priors = os.path.join(tmp, "query_priors.txt")
    write_box_priors(priors, size=300)
    labels = os.path.join(tmp, "query_coco.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"c{i}" for i in range(91)))
    return dict(option1="mobilenet-ssd", option2=labels, option3=priors,
                option4="300:300", option5="300:300")


def _ssd_server(sid: int, opts: dict, decode: bool = True, depth: int = 1):
    """``tensor_query_serversrc ! tensor_filter model=SSD-300 [!
    tensor_decoder mode=bounding_box] ! tensor_query_serversink`` on the
    card, listening on 127.0.0.1 port 0. Returns (pipeline, port)."""
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.query.server import wait_bound_port

    p = Pipeline(f"qsrv{sid}", device=QUERY_DEVICE)
    src = p.add_new("tensor_query_serversrc", host="127.0.0.1", port=0, id=sid,
                    dims=QUERY_SRV_DIMS, types="uint8")
    chain = [src, p.add_new("tensor_filter", framework="xla-tpu", model=SSD_SPEC)]
    if decode:
        chain.append(p.add_new("tensor_decoder", mode="bounding_box", **opts))
    chain.append(p.add_new("tensor_query_serversink", id=sid, async_depth=depth))
    Pipeline.link(*chain)
    p.start()
    return p, wait_bound_port(src, timeout_s=60)


def _ssd_client(frames, decode_opts=None, on_send=None, **client_props) -> tuple:
    """``appsrc (300x300 RGB) ! tensor_converter ! tensor_query_client
    [! tensor_decoder mode=bounding_box] ! tensor_sink`` over ``frames``.
    ``on_send(i, client)`` runs just before frame i is pushed (a sync client
    has finished frame i-1 by then), and with ``len(frames)`` after the run.
    Returns (pipeline, sink, send times, arrival times)."""
    from nnstreamer_tpu_torch.graph import Pipeline

    sent, arrived = [], []

    def gen():
        for i, f in enumerate(frames):
            if on_send is not None:
                on_send(i, qc)
            sent.append(time.perf_counter())
            yield f

    p = Pipeline("qcli", device=QUERY_DEVICE)
    qc = p.add_new("tensor_query_client", "qc", **client_props)
    chain = [p.add_new("appsrc", caps=_qcaps(), data=gen()),
             p.add_new("tensor_converter"), qc]
    if decode_opts is not None:
        chain.append(p.add_new("tensor_decoder", mode="bounding_box", **decode_opts))
    sink = p.add_new("tensor_sink", store=True,
                     new_data=lambda b: arrived.append(time.perf_counter()))
    Pipeline.link(*chain, sink)
    p.run(timeout=600)
    if on_send is not None:
        on_send(len(frames), qc)
    return p, sink, sent, arrived


def _direct_ssd(frames, opts) -> tuple:
    """The same frames without a hop (run_detection's pipeline on an
    appsrc): each frame's RGBA bytes and detections, steady fps, the
    reduce's launches and host copies."""
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.ops.kernels import epilogue as ep

    arrived = []
    p = Pipeline("qdirect", device=QUERY_DEVICE)
    src = p.add_new("appsrc", caps=_qcaps(), data=list(frames))
    conv = p.add_new("tensor_converter")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=SSD_SPEC)
    dec = p.add_new("tensor_decoder", mode="bounding_box", **opts)
    sink = p.add_new("tensor_sink", store=True,
                     new_data=lambda b: arrived.append(time.perf_counter()))
    Pipeline.link(src, conv, filt, dec, sink)
    ep.class_reduce.launches = ep.nms_sweep.launches = 0
    with _host_copies() as copies:
        p.run(timeout=600)
    if sink.num_buffers != len(frames) or p._epilogue_count != 1:
        raise AssertionError(f"query direct: {sink.num_buffers} of {len(frames)} frames, "
                             f"{p._epilogue_count} fused reduces")
    outs = [(b.memories[0].host().tobytes(), b.meta["detections"]) for b in sink.buffers]
    return outs, _steady_fps(arrived), (ep.class_reduce.launches,
                                        ep.nms_sweep.launches), dict(copies)


def _timed_attr(obj, name: str, rec: list):
    """Wrap ``obj.name`` to append each call's host seconds to ``rec``;
    returns the unwrapped callable."""
    fn = getattr(obj, name)

    def wrap(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        rec.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, wrap)
    return fn


@contextlib.contextmanager
def _wire_clock():
    """Host seconds of each ``buffer_to_payload`` (encode) and
    ``payload_to_buffer`` (decode) the client and the server make, and the
    payload bytes of each DATA and RESULT frame sent, while inside."""
    from nnstreamer_tpu_torch.query import client as qclient
    from nnstreamer_tpu_torch.query import router as qrouter
    from nnstreamer_tpu_torch.query import server as qserver

    rec = {k: [] for k in ("client_encode", "client_decode", "server_encode",
                           "server_decode", "DATA", "RESULT")}
    saved = []

    def timed(mod, name, key):
        saved.append((mod, name, _timed_attr(mod, name, rec[key])))

    def sized(mod):
        fn = mod.send_message
        saved.append((mod, "send_message", fn))

        def wrap(sock, cmd, meta, payload=b""):
            if cmd.name in rec:
                rec[cmd.name].append(len(payload))
            return fn(sock, cmd, meta, payload)

        mod.send_message = wrap

    timed(qclient, "buffer_to_payload", "client_encode")
    timed(qclient, "payload_to_buffer", "client_decode")
    timed(qserver, "buffer_to_payload", "server_encode")
    timed(qserver, "payload_to_buffer", "server_decode")
    for mod in (qclient, qserver, qrouter):
        sized(mod)
    try:
        yield rec
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def _rgba_check(name: str, sink, want: list) -> None:
    got = [b.memories[0].host().tobytes() for b in sink.buffers]
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} of {len(want)} frames out")
    bad = [i for i, (g, (w, _)) in enumerate(zip(got, want)) if g != w]
    if bad:
        raise AssertionError(f"{name}: RGBA of frames {bad} differ from the direct path")


def _det_rows(dets) -> np.ndarray:
    """A frame's detections as (x0, y0, x1, y1, score, class) rows."""
    return np.asarray([[*d["box"], d["score"], d["class"]] for d in dets],
                      np.float64).reshape(-1, 6)


def _events_of(etype: str) -> list:
    from nnstreamer_tpu_torch.obs import events

    return [e for e in events.ring().snapshot() if e["type"] == etype]


def run_query_ssd(opts, frames, direct, counters, card) -> tuple:
    """(a): SSD-300 behind the hop, reduce on the server. Returns the server
    (kept for the transports and the CLI), its port and the launches."""
    from nnstreamer_tpu_torch.core import graphs

    direct_outs, direct_fps, _, direct_copies = direct
    srv, port = _ssd_server(201, opts, depth=QUERY_DEPTH)
    if srv._epilogue_count != 1:
        raise AssertionError(f"query server: reduce not fused ({srv._epilogue_count})")
    warm, timed = frames[:QUERY_WARM], frames[QUERY_WARM:]
    want = direct_outs[QUERY_WARM:]
    runs, launches = {}, {}
    for eager in (False, True):
        mode = "eager" if eager else "graphs"
        with _mode(eager):
            if not eager:
                # the server's capture on the first frame: its round trip
                # is recorded, then the warm-up frames
                t0 = time.perf_counter()
                _, sink, sent, arrived = _ssd_client(warm, host="127.0.0.1", port=port)
                first_ms = (arrived[0] - sent[0]) * 1e3
                _rgba_check("query warm-up", sink, direct_outs[:QUERY_WARM])
                print(f"query ssd warm-up: {QUERY_WARM} frames in "
                      f"{time.perf_counter() - t0:.3f} s, the first (the server's "
                      f"capture) round trip {first_ms:.3f} ms [{card}]", flush=True)
            counters.reset()
            with _host_copies() as copies, _wire_clock() as wire:
                _, sink, sent, arrived = _ssd_client(timed, host="127.0.0.1", port=port)
            launches[mode] = counters.read()
            _rgba_check(f"query ssd sync ({mode})", sink, want)
            counters.reset()
            _, psink, _, parrived = _ssd_client(timed, host="127.0.0.1", port=port,
                                                async_depth=QUERY_DEPTH)
            plaunches = counters.read()
            _rgba_check(f"query ssd pipelined ({mode})", psink, want)
            st = graphs.stats()
        for name, got in (("sync", launches[mode]), ("pipelined", plaunches)):
            if got["class_reduce"] != len(timed) or got["nms_sweep"] != len(timed):
                raise AssertionError(f"query ssd {name} ({mode}): launches {got} for "
                                     f"{len(timed)} frames")
        rtt = float(np.median([a - s for a, s in zip(arrived, sent)])) * 1e3
        runs[mode] = dict(rtt_p50_ms=rtt, sync_fps=_steady_fps(arrived),
                          fps=_steady_fps(parrived), copies=dict(copies), graphs=st,
                          wire={k: list(v) for k, v in wire.items()})
    g = runs["graphs"]
    n = len(timed)
    per = {k: v / n for k, v in g["copies"].items()}
    dper = {k: v / len(frames) for k, v in direct_copies.items()}
    if per != dper:
        raise AssertionError(f"query ssd: host copies a frame {per} behind the hop, "
                             f"{dper} without it")
    wire = g["wire"]
    stats = {"fps": g["fps"], "eager_fps": runs["eager"]["fps"],
             "sync_fps": g["sync_fps"], "direct_fps": direct_fps,
             "rtt_p50_ms": g["rtt_p50_ms"], "eager_rtt_p50_ms": runs["eager"]["rtt_p50_ms"],
             "first_frame_ms": first_ms,
             "request_bytes": int(np.median(wire["DATA"])),
             "result_bytes": int(np.median(wire["RESULT"])),
             "client_encode_ms": _median_ms(wire["client_encode"]),
             "server_decode_ms": _median_ms(wire["server_decode"]),
             "server_encode_ms": _median_ms(wire["server_encode"]),
             "client_decode_ms": _median_ms(wire["client_decode"]),
             "h2d_per_frame": per.get("h2d", 0), "d2h_per_frame": per.get("d2h", 0)}
    LOOP_STATS["query_ssd"] = stats
    print(f"query ssd (a) SSD-300 behind tensor_query, reduce on the server: {n} frames "
          f"after {QUERY_WARM}; pipelined (async_depth {QUERY_DEPTH}) fps graphs "
          f"{stats['fps']:.2f}, eager {stats['eager_fps']:.2f}; direct (no hop) "
          f"{direct_fps:.2f} fps; sync fps {stats['sync_fps']:.2f}, round trip p50 "
          f"{stats['rtt_p50_ms']:.4f} ms (eager {stats['eager_rtt_p50_ms']:.4f}); wire "
          f"bytes a frame: request {stats['request_bytes']}, result "
          f"{stats['result_bytes']}; host ms a frame: client encode "
          f"{stats['client_encode_ms']:.4f}, server decode {stats['server_decode_ms']:.4f}, "
          f"server encode {stats['server_encode_ms']:.4f}, client decode "
          f"{stats['client_decode_ms']:.4f}; host copies a frame {per} == the direct "
          f"path's; launches sync {launches['graphs']} (eager {launches['eager']}), "
          f"one fused reduce; every RGBA == the direct path's [{card}]", flush=True)
    _record_graphs("query_ssd", 1, "fps", g["fps"], runs["eager"]["fps"], g["graphs"])
    return srv, port, launches["graphs"]


def run_query_routed(opts, frames, direct_outs, counters, card) -> tuple:
    """(b): two servers behind one routed client (backends=A,B, hedge_ms):
    a seeded partition of A mid-stream, then the healed net, then a seeded
    delay fault on A. Returns the servers and their ports (kept for the CLI)
    and the launches."""
    import random as _random

    from nnstreamer_tpu_torch.obs import events, metrics
    from nnstreamer_tpu_torch.query import router as qrouter
    from nnstreamer_tpu_torch.resilience import chaos, policy

    servers = [_ssd_server(211 + i, opts) for i in range(2)]
    ports = [port for _, port in servers]
    for port in ports:  # each server's capture before the routed run
        _ssd_client(frames[:2], host="127.0.0.1", port=port)
    a_ep, b_ep = (f"127.0.0.1:{port}" for port in ports)
    events.enable()
    metrics.registry().enable()
    step = QUERY_ROUTED_STEP
    n = 3 * step
    seen = {}
    plan = chaos.FaultPlan([chaos.Fault(kind="partition", target="send", cmd="DATA",
                                        endpoint=a_ep, nth=1)], seed=11)

    def on_send(i, qc):
        if i == 0:
            qc.router.backends._rng = _random.Random(7)
            seen["failovers0"] = qrouter._FAILOVER_TOTAL.labels("qc").value
            seen["a"] = qc.router.backends.get(a_ep)
        elif i == step:
            chaos.install(plan)  # A black-holes from its next DATA on
        elif i == 2 * step:
            seen.update(fired=list(plan.fired), breaker=seen["a"].breaker.state,
                        a_before=seen["a"].dispatched)
            plan.heal()
            chaos.uninstall()
            time.sleep(QUERY_RESET_S + 0.05)  # past the cooldown: a probe is due

    counters.reset()
    try:
        _, sink, sent, arrived = _ssd_client(
            frames[:n], on_send=on_send, backends=f"{a_ep},{b_ep}",
            max_request_retry=4, timeout_s=10.0, retry_base_s=0.01, retry_max_s=0.05,
            breaker_threshold=1, breaker_reset_s=QUERY_RESET_S, hedge_ms=QUERY_HEDGE_MS)
    finally:
        chaos.uninstall()
    _rgba_check("query routed", sink, direct_outs[:n])
    a_after = seen["a"].dispatched
    failovers = qrouter._FAILOVER_TOTAL.labels("qc").value - seen["failovers0"]
    fov_events = _events_of("router.failover")
    if not seen["fired"] or seen["breaker"] != policy.OPEN:
        raise AssertionError(f"query routed: partition fired {seen['fired']}, A's breaker "
                             f"{seen['breaker']} (want open)")
    if failovers < 1 or not fov_events \
            or any(e["attrs"]["backend"] == a_ep for e in fov_events):
        raise AssertionError(f"query routed: failovers {failovers}, events {fov_events}")
    if a_after <= seen["a_before"]:
        raise AssertionError(f"query routed: A took no traffic after the heal "
                             f"({seen['a_before']} -> {a_after})")
    healthy_fps = _steady_fps(arrived[:step])
    # the hedge: a seeded delay on A's DATA sends; A as primary is hedged
    # onto B. Before the last frame, once the delayed losers are done, A's
    # connection must answer a plain request correctly (protocol sync)
    from nnstreamer_tpu_torch.core.buffer import Buffer
    from nnstreamer_tpu_torch.query.protocol import buffer_to_payload, payload_to_buffer

    dplan = chaos.FaultPlan([chaos.Fault(kind="delay", target="send", cmd="DATA",
                                         endpoint=a_ep, p=1.0,
                                         delay_s=QUERY_DELAY_S)], seed=5)
    hedges0 = len(_events_of("resilience.hedge"))
    sync = {}

    def hedge_send(i, qc):
        if i == 0:
            qc.router.backends._rng = _random.Random(3)
            chaos.install(dplan)
        elif i == QUERY_HEDGE_MAX - 1:
            a = qc.router.backends.get(a_ep)
            deadline = time.monotonic() + 10
            while a.inflight and time.monotonic() < deadline:
                time.sleep(0.01)
            chaos.uninstall()
            meta, payload = buffer_to_payload(Buffer.of(frames[0][None]))
            rmeta, rpayload = a.request(meta, payload, qc.router._caps())
            sync["rgba"] = payload_to_buffer(rmeta, rpayload).memories[0].host().tobytes()
            sync["inflight"] = a.inflight

    try:
        _, hsink, hsent, harrived = _ssd_client(
            frames[:QUERY_HEDGE_MAX], on_send=hedge_send, backends=f"{a_ep},{b_ep}",
            timeout_s=10.0, hedge_ms=QUERY_HEDGE_MS)
    finally:
        chaos.uninstall()
    launches = counters.read()
    _rgba_check("query hedged", hsink, direct_outs[:QUERY_HEDGE_MAX])
    hedges = _events_of("resilience.hedge")[hedges0:]
    delayed = [f for f in dplan.fired if f["kind"] == "delay"]
    hedge_rtts = [a - s for a, s in zip(harrived, hsent)]
    if not hedges or any(e["attrs"]["backend"] != b_ep for e in hedges) or not delayed:
        raise AssertionError(f"query hedged: {len(hedges)} hedges ({hedges}), "
                             f"{len(delayed)} delayed sends")
    if max(hedge_rtts) >= QUERY_DELAY_S:
        raise AssertionError(f"query hedged: a frame waited for the delayed primary "
                             f"({max(hedge_rtts):.3f} s)")
    if sync.get("rgba") != direct_outs[0][0]:
        raise AssertionError("query hedged: A's connection answered wrongly after the "
                             "hedged round trips")
    stats = {"healthy_fps": healthy_fps, "failovers": failovers,
             "failover_events": len(fov_events), "hedges": len(hedges),
             "delayed_sends": len(delayed),
             "hedged_run_rtt_ms": [round(t * 1e3, 4) for t in hedge_rtts],
             "a_dispatched_before_heal": seen["a_before"],
             "a_dispatched_after_heal": a_after}
    LOOP_STATS["query_routed"] = stats
    print(f"query routed (b) backends A,B, hedge_ms {QUERY_HEDGE_MS}: {n} frames, a "
          f"seeded partition of A from frame {step} to {2 * step - 1} (fired "
          f"{seen['fired']}), A's breaker {seen['breaker']}, {failovers:.0f} failovers "
          f"({len(fov_events)} router.failover events, none onto A), A served "
          f"{seen['a_before']} -> {a_after} after the heal and its probe; healthy routed "
          f"sync fps {healthy_fps:.2f} (one card under both backends; no speed "
          f"claimed); then {len(hedges)} hedges onto B over {QUERY_HEDGE_MAX} frames "
          f"under a {QUERY_DELAY_S} s delay on A ({len(delayed)} delayed sends), round "
          f"trips ms min {min(hedge_rtts) * 1e3:.3f} max {max(hedge_rtts) * 1e3:.3f} "
          f"(the first response won); A's connection in protocol sync after; every "
          f"RGBA == the direct path's; launches {launches} [{card}]", flush=True)
    metrics.registry().disable()
    events.disable()
    events.ring().reset()
    return servers, launches


def run_query_fallback(opts, frames, direct_outs, counters, card) -> dict:
    """(c): the server runs the filter alone, raw boxes and scores go back
    and the client decodes them on the host; a partition of every backend
    sends a stretch of frames to the client's ``fallback=`` (a callable
    over the same zoo bundle, a local tensor_filter on the card), whose
    output the client's decoder reduces on the card (``async_depth=1``: the
    decoder's device reduce; at 0 every frame decodes on the host)."""
    from nnstreamer_tpu_torch.models.zoo import get_model
    from nnstreamer_tpu_torch.obs import events, health
    from nnstreamer_tpu_torch.resilience import chaos

    srv, port = _ssd_server(221, opts, decode=False)
    _ssd_client(frames[:2], host="127.0.0.1", port=port)  # the server's capture
    events.enable()
    health.enable()
    fn = get_model(SSD_SPEC, device=QUERY_DEVICE).fn()
    lo, hi = QUERY_FB_REMOTE, QUERY_FB_REMOTE + QUERY_FB_STRETCH
    n = hi + QUERY_FB_REMOTE
    per_frame, state = [], {}
    plan = chaos.FaultPlan([chaos.Fault(kind="partition", target="send", cmd="DATA",
                                        nth=1)], seed=17)

    def component():
        snap = health.snapshot()
        return next(c for c in snap["components"] if c["name"] == "query.client:qc")

    def on_send(i, qc):
        if i:
            per_frame.append(counters.read())
        counters.reset()
        if i == lo:
            chaos.install(plan)
        elif i == hi:
            state["during"] = component()
            plan.heal()
            chaos.uninstall()
            time.sleep(0.35)  # past breaker_reset_s: the next frame probes

    try:
        with _host_copies() as copies:
            _, sink, _, _ = _ssd_client(
                frames[:n], decode_opts=dict(opts, async_depth=1), on_send=on_send,
                host="127.0.0.1",
                port=port, fallback=fn, max_request_retry=1, timeout_s=10.0,
                retry_base_s=0.001, retry_max_s=0.002, breaker_threshold=1,
                breaker_reset_s=0.3)
        state["after"] = component()
    finally:
        chaos.uninstall()
        srv.stop()
    fallback_frames = set(range(lo, hi))
    for i, got in enumerate(per_frame):
        want = 1 if i in fallback_frames else 0
        if got["class_reduce"] != want or got["nms_sweep"] != want:
            raise AssertionError(f"query fallback: frame {i} launches {got}, want {want} "
                                 "(fallback frames reduce on the card, remote ones on "
                                 "the host)")
    outs = [(b.memories[0].host().tobytes(), b.meta["detections"]) for b in sink.buffers]
    if len(outs) != n:
        raise AssertionError(f"query fallback: {len(outs)} of {n} frames out")
    remote_equal, remote_close = 0, 0
    for i, ((got, det), (want, wdet)) in enumerate(zip(outs, direct_outs)):
        if got == want:
            remote_equal += i not in fallback_frames
            continue
        if i in fallback_frames:
            raise AssertionError(f"query fallback: fallback frame {i} RGBA differs from "
                                 "the direct path's")
        # a remote frame decoded on the host: its boxes within the host
        # decode's tolerance of the device reduce (run_detection's)
        rows, wrows = _det_rows(det), _det_rows(wdet)
        if rows.shape != wrows.shape or not np.allclose(rows, wrows, rtol=1e-4,
                                                        atol=1e-5):
            raise AssertionError(f"query fallback: remote frame {i} boxes differ from "
                                 "the direct path's")
        remote_close += 1
    during, after = state["during"], state["after"]
    if during["status"] != "degraded" or after["status"] != "ok" \
            or "remote path restored" not in after["detail"]:
        raise AssertionError(f"query fallback: health {during} then {after}")
    fallback_events = len(_events_of("resilience.fallback"))
    launches = {k: sum(f[k] for f in per_frame) for k in per_frame[0]}
    LOOP_STATS["query_fallback"] = {
        "frames": n, "fallback_frames": len(fallback_frames),
        "remote_rgba_equal": remote_equal, "remote_within_tolerance": remote_close,
        "fallback_events": fallback_events, "copies": dict(copies)}
    print(f"query fallback (c): {n} frames, frames {lo}-{hi - 1} under a partition of "
          f"every backend took fallback= (a local tensor_filter on the card over the "
          f"same bundle, {fallback_events} resilience.fallback events): each launched "
          f"class_reduce and nms_sweep once and its RGBA == the direct path's; "
          f"{n - len(fallback_frames)} remote frames decoded on the host launched none, "
          f"{remote_equal} RGBA-equal, {remote_close} within the host decode's "
          f"tolerance; health {during['status']} ({during['detail']}) then "
          f"{after['status']} ({after['detail']}); host copies {dict(copies)} [{card}]",
          flush=True)
    health.disable()
    health.registry().reset()
    events.disable()
    events.ring().reset()
    return launches


def run_query_composite(counters, card) -> dict:
    """(d): BASELINE.json config 5 (bench.py:264-330) on the card:
    ``tensor_query_serversrc`` + ``tensor_reposrc`` -> ``tensor_mux`` -> the
    LSTM cell -> ``tensor_demux`` -> ``tensor_query_serversink`` /
    ``tensor_reposink``; a sync client for the round trip, then a pipelined
    one. Every output byte-equal to the loop without the hop
    (``_repo_loop``) on the same frames."""
    from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.elements.repo import reset_repo
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.query.server import wait_bound_port

    rng = np.random.default_rng(41)
    n = QUERY_LSTM_SYNC + LSTM_WARM + LSTM_FRAMES
    frames = [rng.standard_normal((1, LSTM_DIN)).astype(np.float32) for _ in range(n)]
    caps = Caps.tensors(TensorsConfig(TensorsInfo.from_strings(f"{LSTM_DIN}:1",
                                                               "float32"), 30))
    reset_repo()
    sp = Pipeline("qlstm", device=QUERY_DEVICE)
    ssrc = sp.add_new("tensor_query_serversrc", host="127.0.0.1", port=0, id=231,
                      dims=f"{LSTM_DIN}:1", types="float32")
    state = sp.add_new("tensor_reposrc", slot_index=LSTM_SLOT,
                       dims=f"{LSTM_F}:1,{LSTM_F}:1", types="float32,float32")
    mux = sp.add_new("tensor_mux", sync_mode="nosync")
    filt = sp.add_new("tensor_filter", framework="xla-tpu", model=LSTM_SPEC)
    demux = sp.add_new("tensor_demux", tensorpick="0,1:2")
    ssink = sp.add_new("tensor_query_serversink", id=231, async_depth=QUERY_DEPTH)
    rsink = sp.add_new("tensor_reposink", slot_index=LSTM_SLOT)
    Pipeline.link(ssrc, mux)
    Pipeline.link(state, mux)
    Pipeline.link(mux, filt, demux)
    Pipeline.link(demux, sp.add_new("queue"), ssink)
    Pipeline.link(demux, sp.add_new("queue"), rsink)

    def client(batch, depth):
        sent, arrived, outs = [], [], []

        def gen():
            for f in batch:
                sent.append(time.perf_counter())
                yield f

        def on_result(b):
            arrived.append(time.perf_counter())
            outs.append(b.memories[0].host())

        cp = Pipeline("qlstm-client", device=QUERY_DEVICE)
        src = cp.add_new("appsrc", caps=caps, data=gen())
        qc = cp.add_new("tensor_query_client", host="127.0.0.1", port=port,
                        async_depth=depth)
        Pipeline.link(src, qc, cp.add_new("tensor_sink", new_data=on_result))
        cp.run(timeout=600)
        return outs, sent, arrived

    counters.reset()
    with _host_copies() as copies:
        sp.start()
        try:
            port = wait_bound_port(ssrc, timeout_s=60)
            outs, sent, arrived = client(frames[:QUERY_LSTM_SYNC], 1)
            pouts, _, parrived = client(frames[QUERY_LSTM_SYNC:], QUERY_DEPTH)
        finally:
            sp.stop()
    launches = counters.read()
    copies = dict(copies)
    hop = outs + pouts
    rtt = float(np.median([a - s for a, s in zip(arrived, sent)])) * 1e3
    fps = _steady_fps(parrived[LSTM_WARM:])
    if copies != {"h2d": n + 2, "d2h": n}:
        raise AssertionError(f"query composite: host copies {copies} for {n} frames, "
                             f"expected {{'h2d': {n + 2}, 'd2h': {n}}}")
    loop = _repo_loop(QUERY_DEVICE, frames, LSTM_SPEC)[0]
    if len(hop) != n or any(a.tobytes() != b.tobytes() for a, b in zip(hop, loop)):
        bad = sum(a.tobytes() != b.tobytes() for a, b in zip(hop, loop))
        raise AssertionError(f"query composite: {len(hop)} of {n} outputs, {bad} differ "
                             "from the loop without the hop")
    base = LOOP_STATS.get("repo_lstm", {})
    stats = {"fps": fps, "rtt_p50_ms": rtt, "loop_fps": base.get("fps"),
             "loop_rtt_p50_ms": base.get("rtt_p50_ms"),
             "h2d_per_frame": copies["h2d"] / n, "d2h_per_frame": copies["d2h"] / n}
    LOOP_STATS["query_composite"] = stats
    print(f"query composite (d) repo-LSTM behind tensor_query (BASELINE config 5, d_in "
          f"{LSTM_DIN}, features {LSTM_F}): sync round trip p50 {rtt:.4f} ms over "
          f"{QUERY_LSTM_SYNC} frames, pipelined (async_depth {QUERY_DEPTH}) {fps:.2f} fps "
          f"over {LSTM_FRAMES} after {LSTM_WARM}; the loop without the hop "
          f"{base.get('fps', float('nan')):.2f} fps, p50 "
          f"{base.get('rtt_p50_ms', float('nan')):.4f} ms; host copies a frame: h2d "
          f"{copies['h2d'] / n:.4f}, d2h {copies['d2h'] / n:.4f} ({copies} over {n}); "
          f"all {n} outputs == the loop without the hop on the same frames [{card}]",
          flush=True)
    return launches


def _sink_wait(sink, n: int, what: str, timeout: float = 300) -> None:
    deadline = time.monotonic() + timeout
    while sink.num_buffers < n and time.monotonic() < deadline:
        time.sleep(0.01)
    if sink.num_buffers < n:
        raise AssertionError(f"{what}: {sink.num_buffers} of {n} frames out")


def _ssd_tail(p, src, opts):
    """``src ! tensor_filter model=SSD-300 ! tensor_decoder ! tensor_sink``
    in ``p``; returns the sink."""
    from nnstreamer_tpu_torch.graph import Pipeline

    sink = p.add_new("tensor_sink", store=True)
    Pipeline.link(src, p.add_new("tensor_filter", framework="xla-tpu", model=SSD_SPEC),
                  p.add_new("tensor_decoder", mode="bounding_box", **opts), sink)
    return sink


def run_query_transports(opts, frames, direct_outs, port, counters, card) -> dict:
    """(e): SSD-300 frames over MQTT (the built-in broker), over the
    discovery broker into (a)'s server, and over gRPC (``idl=flex`` and
    ``protobuf``) when grpcio is present; every output == the direct
    path's, host ms a frame to encode and to decode."""
    import importlib.util

    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.query import hybrid, pubsub
    from nnstreamer_tpu_torch.query.mqtt import MqttBroker

    batch, want = frames[:QUERY_HOP_FRAMES], direct_outs[:QUERY_HOP_FRAMES]
    stats = {}
    counters.reset()
    # MQTT: appsrc ! tensor_converter ! mqttsink -> broker -> mqttsrc ! SSD
    broker = MqttBroker(port=0).start()
    enc, dec = [], []
    saved = (_timed_attr(pubsub, "_buffer_to_mqtt", enc),
             _timed_attr(pubsub, "_mqtt_to_buffer", dec))
    try:
        rp = Pipeline("qmqtt-rx", device=QUERY_DEVICE)
        sink = _ssd_tail(rp, rp.add_new("mqttsrc", port=broker.port,
                                        sub_topic="nns/ssd"), opts)
        rp.start()
        try:
            time.sleep(0.3)  # the subscription is in place
            tp = Pipeline("qmqtt-tx", device=QUERY_DEVICE)
            Pipeline.link(tp.add_new("appsrc", caps=_qcaps(), data=list(batch)),
                          tp.add_new("tensor_converter"),
                          tp.add_new("mqttsink", port=broker.port, pub_topic="nns/ssd"))
            tp.run(timeout=300)
            _sink_wait(sink, len(batch), "query mqtt")
        finally:
            rp.stop()
    finally:
        pubsub._buffer_to_mqtt, pubsub._mqtt_to_buffer = saved
        broker.stop()
    _rgba_check("query mqtt", sink, want)
    stats["mqtt"] = {"encode_ms": _median_ms(enc), "decode_ms": _median_ms(dec)}
    # discovery: the client resolves (a)'s server by operation= through
    # the DiscoveryBroker
    dbroker = hybrid.DiscoveryBroker(port=0).start()
    try:
        hybrid.register_node("ssd300", "127.0.0.1", port, broker_port=dbroker.port)
        with _wire_clock() as wire:
            _, sink, _, _ = _ssd_client(batch, operation="ssd300",
                                        broker_port=dbroker.port)
    finally:
        dbroker.stop()
    _rgba_check("query discovery", sink, want)
    stats["discovery"] = {"encode_ms": _median_ms(wire["client_encode"]),
                          "decode_ms": _median_ms(wire["client_decode"])}
    grpc_ran = importlib.util.find_spec("grpc") is not None
    print(f"query transports: grpcio {'present: the gRPC hops run' if grpc_ran else 'absent: the gRPC hops do not run'}",
          flush=True)
    for idl in ("flex", "protobuf") if grpc_ran else ():
        enc, dec = [], []
        rp = Pipeline(f"qgrpc-rx-{idl}", device=QUERY_DEVICE)
        gsrc = rp.add_new("tensor_grpc_src", port=0, idl=idl)
        _timed_attr(gsrc, "_decode", dec)
        sink = _ssd_tail(rp, gsrc, opts)
        rp.start()
        try:
            deadline = time.monotonic() + 30
            while not hasattr(gsrc, "bound_port") and time.monotonic() < deadline:
                time.sleep(0.02)
            tp = Pipeline(f"qgrpc-tx-{idl}", device=QUERY_DEVICE)
            gsink = tp.add_new("tensor_grpc_sink", port=gsrc.bound_port, idl=idl)
            _timed_attr(gsink, "_encode", enc)
            Pipeline.link(tp.add_new("appsrc", caps=_qcaps(), data=list(batch)),
                          tp.add_new("tensor_converter"), gsink)
            tp.run(timeout=300)
            _sink_wait(sink, len(batch), f"query grpc {idl}")
        finally:
            rp.stop()
        _rgba_check(f"query grpc {idl}", sink, want)
        stats[f"grpc_{idl}"] = {"encode_ms": _median_ms(enc), "decode_ms": _median_ms(dec)}
    launches = counters.read()
    hops = 2 + 2 * grpc_ran
    for k in ("class_reduce", "nms_sweep"):
        if launches[k] != hops * len(batch):
            raise AssertionError(f"query transports: launches {launches} for {hops} hops "
                                 f"of {len(batch)} frames")
    LOOP_STATS["query_transports"] = dict(stats, grpc_ran=grpc_ran)
    print("query transports (e), SSD-300 frames, every RGBA == the direct path's: "
          + "; ".join(f"{k} host ms a frame encode {v['encode_ms']:.4f}, decode "
                      f"{v['decode_ms']:.4f}" for k, v in stats.items())
          + f"; launches {launches} [{card}]", flush=True)
    return launches


def run_query_cli(opts, servers, tmp: str, card) -> None:
    """(f): ``nns-launch-torch --backends A,B --hedge-ms 5 --deadline-ms 2000
    --fallback passthrough`` with a one-fault ``NNS_TPU_CHAOS`` plan against
    (b)'s servers, in its own process: exit 0, the chaos line on stderr, and
    the RGBA frames it writes equal to the direct path's on the same source."""
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.graph.parse import parse_pipeline

    source = (f"videotestsrc width=300 height=300 pattern=random seed={QUERY_CLI_SEED} "
              f"num-buffers={QUERY_HOP_FRAMES} ! video/x-raw,format=RGB ! "
              "tensor_converter")
    ref = parse_pipeline(
        f"{source} ! tensor_filter framework=xla-tpu model=\"{SSD_SPEC}\" ! "
        f"tensor_decoder mode=bounding_box option1={opts['option1']} "
        f"option2={opts['option2']} option3={opts['option3']} option4=300:300 "
        "option5=300:300 ! tensor_sink store=true",
        Pipeline("qcli-ref", device=QUERY_DEVICE))
    ref.run(timeout=300)
    rsink = next(e for e in ref.elements.values() if e.ELEMENT_NAME == "tensor_sink")
    want = b"".join(b.memories[0].host().tobytes() for b in rsink.buffers)
    out = os.path.join(tmp, "query_cli.rgba")
    backends = ",".join(f"127.0.0.1:{port}" for _, port in servers)
    plan = {"seed": 19, "faults": [{"kind": "disconnect", "target": "send",
                                    "cmd": "DATA", "nth": 3}]}
    env = dict(os.environ, NNS_TPU_CHAOS=json.dumps(plan))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.cli", "--backends", backends,
         "--hedge-ms", "5", "--deadline-ms", "2000", "--fallback", "passthrough",
         f"{source} ! tensor_query_client ! filesink location={out}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if run.returncode != 0 or "chaos: fault plan installed (seed=19, 1 faults)" \
            not in run.stderr:
        raise AssertionError(f"query cli: exit {run.returncode}, stderr "
                             f"{run.stderr[-2000:]}")
    with open(out, "rb") as f:
        got = f.read()
    if got != want or len(want) != QUERY_HOP_FRAMES * 300 * 300 * 4:
        raise AssertionError(f"query cli: {len(got)} bytes written, the direct path's "
                             f"{len(want)}, equal {got == want}")
    print(f"query cli (f): nns-launch-torch --backends A,B --hedge-ms 5 --deadline-ms "
          f"2000 --fallback passthrough with NNS_TPU_CHAOS={json.dumps(plan)}: exit 0 in "
          f"{wall:.3f} s (its own process), the chaos line on stderr, "
          f"{QUERY_HOP_FRAMES} RGBA frames == the direct path's [{card}]", flush=True)


def run_query(counters) -> dict:
    """Phase 12b, the query and resilience layers on the card: (a) SSD-300
    behind tensor_query with the reduce on the server, (b) routed over two
    servers through a partition and a delay, (c) the client's fallback onto
    the card, (d) the repo-LSTM composite behind the hop, (e) MQTT,
    discovery and gRPC hops, (f) the CLI. Returns each part's launches."""
    from nnstreamer_tpu_torch.graph import element as gel
    from nnstreamer_tpu_torch.query import protocol

    card = _card()
    frames = _query_frames(QUERY_WARM + QUERY_FRAMES)
    by_phase = {}
    with tempfile.TemporaryDirectory() as tmp:
        opts = _ssd_opts(tmp)
        direct = _direct_ssd(frames, opts)
        direct_outs = direct[0]
        print(f"query direct (the same frames without a hop): {len(frames)} frames, "
              f"steady fps {direct[1]:.2f}, launches {direct[2]}, host copies "
              f"{direct[3]} [{card}]", flush=True)
        srv, port, by_phase["query ssd"] = run_query_ssd(opts, frames, direct, counters,
                                                         card)
        servers = []
        try:
            servers, by_phase["query routed"] = run_query_routed(
                opts, frames, direct_outs, counters, card)
            by_phase["query fallback"] = run_query_fallback(opts, frames, direct_outs,
                                                            counters, card)
            by_phase["query composite"] = run_query_composite(counters, card)
            by_phase["query transports"] = run_query_transports(
                opts, frames, direct_outs, port, counters, card)
            counters.reset()
            run_query_cli(opts, servers, tmp, card)
            by_phase["query cli"] = counters.read()
        finally:
            for p, _ in servers:
                p.stop()
            srv.stop()
    if protocol.CHAOS_HOOK is not None or gel.CHAOS_CHAIN_HOOK is not None:
        raise AssertionError("query: a chaos hook is still installed")
    _release()
    return by_phase


#: the fleet phase (12c): bench.py's disaggregated serving lane
#: (_disagg_serving_lane) at its full width, its fleet and restore lanes
#: (_fleet_lane, _fleet_restore_lane) at the same widths: the bench LM,
#: max_len 512, chunk 16, pages of 32 tokens, 2 slots an engine
FLEET_DEVICE = "cuda"
FLEET_DIMS = LM_DIMS
FLEET_MAX_LEN, FLEET_CHUNK, FLEET_PAGE = 512, 16, 32
#: (a): 32 greedy requests sharing a 128-token prefix, prompts 160-256
#: tokens, 32 generated each, a pool of 32 pages per engine
DISAGG_REQUESTS, DISAGG_PREFIX, DISAGG_GEN = 32, 128, 32
DISAGG_PROMPTS = (160, 192, 224, 256)
DISAGG_POOL = 2 * FLEET_MAX_LEN // FLEET_PAGE
#: (b): requests with a fresh prefix after the prefill worker is killed
DISAGG_LOST = 8
#: (c): 4 unified workers, 16 sessions x 4 turns, 16 tokens a turn
MIG_WORKERS, MIG_SESSIONS, MIG_TURNS, MIG_GEN = 4, 16, 4, 16
MIG_POOL = 4 * FLEET_MAX_LEN // FLEET_PAGE
#: (d): 3 workers, 6 sessions, 8 tokens a turn; the overhead sub-run's
#: interleaved repetitions (bench.py takes 5)
RESTORE_WORKERS, RESTORE_SESSIONS, RESTORE_GEN, RESTORE_REPS = 3, 6, 8, 3
#: repetitions of each page-transfer stage (the median is printed)
XFER_REPS = 5
#: (f): frames the CLI's routed client sends
FLEET_CLI_FRAMES = 8


def _fsync() -> None:
    if FLEET_DEVICE != "cpu":
        torch.cuda.synchronize()


def _peak_reset() -> None:
    if FLEET_DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()


def _peak_mib() -> float:
    if FLEET_DEVICE == "cpu":
        return 0.0
    return torch.cuda.max_memory_allocated() / 2 ** 20


def _fleet_params():
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.models.convert import causal_lm_params

    v, d, h, n_layers = FLEET_DIMS
    return causal_lm_params(
        causal_lm.init_causal_lm(0, v, d, h, n_layers, FLEET_MAX_LEN), FLEET_DEVICE)


def _fleet_engine(params, pages: int, role=None):
    from nnstreamer_tpu_torch.serving import LMEngine

    return LMEngine(params, FLEET_DIMS[2], FLEET_MAX_LEN, n_slots=2,
                    chunk=FLEET_CHUNK, kv_page_size=FLEET_PAGE, kv_pages=pages,
                    role=role, device=FLEET_DEVICE)


def _disagg_requests(seed: int = 7, n: int = 0) -> list:
    """bench.py's mix: ``n`` (default DISAGG_REQUESTS) prompts sharing a
    DISAGG_PREFIX-token prefix, their lengths cycling through
    DISAGG_PROMPTS."""
    v, n = FLEET_DIMS[0], n or DISAGG_REQUESTS
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, v, DISAGG_PREFIX).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(
        0, v, DISAGG_PROMPTS[i % len(DISAGG_PROMPTS)] - DISAGG_PREFIX).astype(np.int32)])
        for i in range(n)]


def _tally_runs(eng, wrapper, tally: dict, key: str) -> None:
    """Count ``wrapper``'s launches made inside ``eng.run()`` under ``key``
    (a worker's engine runs on its connection thread; the disagg requests
    run one at a time, so no other engine launches meanwhile)."""
    run = eng.run

    def counted():
        before = wrapper.launches
        try:
            return run()
        finally:
            tally[key] = tally.get(key, 0) + wrapper.launches - before

    eng.run = counted


def _unified(eng, reqs, gen: int) -> tuple:
    """Request at a time on a unified engine: (tokens, wall s, first s)."""
    outs, first = [], None
    t0 = time.perf_counter()
    for p in reqs:
        ts = time.perf_counter()
        rid = eng.submit(p, max_new=gen)
        eng.run()
        outs.append([int(t) for t in eng.results[rid]])
        if first is None:
            first = time.perf_counter() - ts
    _fsync()
    return outs, time.perf_counter() - t0, first


def _kv_distance(a_eng, b_eng, prompt) -> float:
    """Largest K/V difference over the pages both engines hold for
    ``prompt`` (inf when either holds none)."""
    a, b = a_eng._kv.export_pages(prompt), b_eng._kv.export_pages(prompt)
    if a is None or b is None:
        return float("inf")
    return max(float(np.max(np.abs(x[s] - y[s])))
               for x, y in zip(a["entries"], b["entries"]) for s in ("k", "v"))


def _first_difference(name: str, reqs, got, want, dec_eng, uni_eng) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            t = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y),
                     min(len(g), len(w)))
            raise AssertionError(
                f"{name}: request {i} ({reqs[i].size} tokens) differs from the "
                f"unified engine first at token {t} ({g[t:t + 4]} against "
                f"{w[t:t + 4]}); K/V distance over its pages "
                f"{_kv_distance(dec_eng, uni_eng, reqs[i]):.3e}")


def _xfer_stages(kv, prompt, peer, card: str, quant: str) -> None:
    """Host ms and bytes of each stage of one full-width page transfer (the
    256-token prompt's full pages): the gather on the card, the copy to
    the host, ``encode_pages``, the wire round trip to the decode worker
    (its decode and splice included), ``decode_pages`` and the upload into
    a pool (``_pool_set``, the import's copy). Medians of XFER_REPS."""
    from nnstreamer_tpu_torch.serving import disagg
    from nnstreamer_tpu_torch.serving.kv_cache import PagedKVCache

    ps = kv.page_size
    node, ids, keys = kv.root, [], []
    for k in range(int(prompt.size) // ps):
        key = tuple(int(x) for x in prompt[k * ps:(k + 1) * ps])
        child = node.children.get(key)
        if child is None or child.page is None:
            break
        ids.append(child.page)
        keys.append(list(key))
        node = child
    if len(ids) != int(prompt.size) // ps:
        raise AssertionError(f"transfer stages: {len(ids)} of "
                             f"{int(prompt.size) // ps} pages in the pool")
    dev = kv.kpool.device
    idx = torch.tensor(ids, dtype=torch.int64, device=dev)
    hdr = kv._header()
    lh, hd = hdr["lh"], hdr["hd"]
    times = {s: [] for s in ("gather", "d2h", "encode", "wire", "decode", "upload")}
    scratch = PagedKVCache(FLEET_DIMS[3], FLEET_DIMS[2], ps, len(ids), hd,
                           device=dev)
    payload_bytes = 0
    for _ in range(XFER_REPS):
        with kv.on_stream():
            _fsync()
            t = time.perf_counter()
            ks, vs = kv.kpool.index_select(0, idx), kv.vpool.index_select(0, idx)
            _fsync()
            times["gather"].append(time.perf_counter() - t)
            t = time.perf_counter()
            kh, vh = ks.cpu().numpy(), vs.cpu().numpy()
            times["d2h"].append(time.perf_counter() - t)
        doc = dict(hdr, entries=[{"key": keys[i], "k": kh[i], "v": vh[i]}
                                 for i in range(len(ids))])
        t = time.perf_counter()
        meta, payload = disagg.encode_pages(doc)
        times["encode"].append(time.perf_counter() - t)
        payload_bytes = len(payload)
        t = time.perf_counter()
        peer.send_frame(dict(meta), payload, pages=len(ids))
        times["wire"].append(time.perf_counter() - t)
        t = time.perf_counter()
        back = disagg.decode_pages(meta, payload)
        times["decode"].append(time.perf_counter() - t)
        t = time.perf_counter()
        for i, ent in enumerate(back["entries"]):
            scratch._pool_set(i + 1, ent["k"], ent["v"])
        _fsync()
        times["upload"].append(time.perf_counter() - t)
        for i, ent in enumerate(back["entries"]):
            if not (np.array_equal(ent["k"], kh[i]) and np.array_equal(ent["v"], vh[i])):
                raise AssertionError("transfer stages: decoded page differs")
        for i in range(len(ids)):
            if not (torch.equal(scratch.kpool[i + 1], ks[i])
                    and torch.equal(scratch.vpool[i + 1], vs[i])):
                raise AssertionError("transfer stages: uploaded page differs")
    med = {s: float(np.median(v)) * 1e3 for s, v in times.items()}
    page = lh * ps * hd * 4
    print(f"fleet disagg {quant} transfer stages, {len(ids)} pages (K and V "
          f"{page / 2 ** 20:.3f} MiB each, {payload_bytes} payload bytes), host ms "
          "(median of " f"{XFER_REPS}): " + ", ".join(
              f"{s} {med[s]:.6f}" for s in times)
          + " (the wire round trip includes the peer's decode and splice) "
          f"[{card}]", flush=True)


def run_fleet_disagg(params, quant: str, counters, card: str, lost: bool) -> dict:
    """(a), and with ``lost`` (b): bench.py's disaggregated serving lane at
    full width against a unified engine, two passes (cold, with the
    programs' captures; warm), every request token-equal; then the prefill
    worker killed and DISAGG_LOST fresh-prefix requests re-prefilled on the
    decode worker under their deadlines, and one PageSpiller pass whose
    pages the neighbour's next shared-prefix request hits."""
    from nnstreamer_tpu_torch.obs import events
    from nnstreamer_tpu_torch.query.router import BackendSet, QueryRouter
    from nnstreamer_tpu_torch.resilience.policy import Deadline
    from nnstreamer_tpu_torch.serving import disagg

    reqs = _disagg_requests()
    dgr = counters.wrappers["dequant_gelu_requant"]
    tally: dict = {}
    pre_eng = _fleet_engine(params, DISAGG_POOL, "prefill")
    dec_eng = _fleet_engine(params, DISAGG_POOL, "decode")
    uni = _fleet_engine(params, DISAGG_POOL)
    for key, eng in (("prefill", pre_eng), ("decode", dec_eng), ("unified", uni)):
        _tally_runs(eng, dgr, tally, key)
    pre_w, dec_w = disagg.DisaggWorker(pre_eng), disagg.DisaggWorker(dec_eng)
    client = disagg.DisaggClient([(pre_w.host, pre_w.port)],
                                 [(dec_w.host, dec_w.port)],
                                 page_size=FLEET_PAGE, name=f"disagg-{quant}")
    nb = peer = None
    by_phase = {}
    counters.reset()
    try:
        for pas in ("cold", "warm"):
            _peak_reset()
            tally.clear()
            sent0 = disagg._PAGES_SENT.labels().value
            recv0 = disagg._PAGES_RECV.labels().value
            bytes0 = disagg._XFER_BYTES.labels().value
            rep0, cs0 = disagg._REPREFILL.labels().value, dict(client.stats)
            kv0 = {k: dict(e.kv_stats) for k, e in (("prefill", pre_eng),
                                                     ("decode", dec_eng))}
            outs, first = [], None
            t0 = time.perf_counter()
            for p in reqs:
                ts = time.perf_counter()
                outs.append(client.generate(p, DISAGG_GEN))
                if first is None:
                    first = time.perf_counter() - ts
            _fsync()
            dwall = time.perf_counter() - t0
            uouts, uwall, ufirst = _unified(uni, reqs, DISAGG_GEN)
            _first_difference(f"fleet disagg {quant} {pas}", reqs, outs, uouts,
                              dec_eng, uni)
            sent = disagg._PAGES_SENT.labels().value - sent0
            recv = disagg._PAGES_RECV.labels().value - recv0
            nbytes = disagg._XFER_BYTES.labels().value - bytes0
            reps = disagg._REPREFILL.labels().value - rep0
            if sent != recv or sent != client.stats["pages_sent"] - cs0["pages_sent"] \
                    or sent == 0 or reps or client.stats["reprefills"] != cs0["reprefills"]:
                raise AssertionError(f"fleet disagg {quant} {pas}: pages sent {sent}, "
                                     f"received {recv}, re-prefills {reps}")
            if quant == "w8a8" and not (tally.get("prefill") and tally.get("decode")
                                        and tally.get("unified")):
                raise AssertionError(f"fleet disagg {quant}: dequant_gelu_requant "
                                     f"launches by engine {tally}")
            if quant == "float32" and any(tally.values()):
                raise AssertionError(f"fleet disagg float32 launched "
                                     f"dequant_gelu_requant: {tally}")
            hit = {}
            for k, e in (("prefill", pre_eng), ("decode", dec_eng)):
                s = e.kv_stats
                hit[k] = (s["hit_tokens"] - kv0[k]["hit_tokens"]) / max(
                    1, s["prompt_tokens"] - kv0[k]["prompt_tokens"])
            ntok = sum(len(o) for o in outs)
            print(f"fleet disagg {quant} {pas} (a): {len(reqs)} requests x "
                  f"{DISAGG_GEN} tokens, every one == the unified engine's; disagg "
                  f"{ntok / dwall:.2f} tokens/s against unified "
                  f"{sum(len(o) for o in uouts) / uwall:.2f} (relative "
                  f"{(ntok / dwall) / (sum(len(o) for o in uouts) / uwall):.4f}); "
                  f"prefix hit rate decode {hit['decode']:.4f}, prefill "
                  f"{hit['prefill']:.4f}; pages sent {sent} == received {recv}, "
                  f"{sent / len(reqs):.3f} pages and {nbytes / len(reqs):.1f} bytes a "
                  f"request, 0 re-prefills; first request {first:.6f} s disagg, "
                  f"{ufirst:.6f} s unified; dequant_gelu_requant launches {tally}; "
                  f"peak memory {_peak_mib():.1f} MiB [{card}]", flush=True)
        by_phase[f"fleet disagg {quant}"] = counters.read()
        peer = disagg.PageTransferClient(dec_w.host, dec_w.port)
        with pre_w._elock:
            _xfer_stages(pre_eng._kv, reqs[-1], peer, card, quant)
        if not lost:
            return by_phase
        # (b) the prefill worker dies before the next transfer
        counters.reset()
        fresh = _disagg_requests(seed=17, n=DISAGG_LOST)
        want, _, _ = _unified(uni, fresh, DISAGG_GEN)
        events.enable()
        events.ring().reset()
        cs0 = dict(client.stats)
        rep0 = disagg._REPREFILL.labels().value
        pre_w.kill()
        got, waits = [], []
        for p in fresh:
            dl = Deadline.after_s(120.0)
            t = time.perf_counter()
            got.append(client.generate(p, DISAGG_GEN, deadline=dl))
            waits.append(time.perf_counter() - t)
            if dl.expired():
                raise AssertionError("fleet disagg (b): a request outlived its deadline")
        _first_difference("fleet disagg (b)", fresh, got, want, dec_eng, uni)
        fired = [e for e in events.ring().snapshot() if e["type"] == "disagg.reprefill"]
        reps = client.stats["reprefills"] - cs0["reprefills"]
        if reps != DISAGG_LOST or len(fired) != DISAGG_LOST \
                or disagg._REPREFILL.labels().value - rep0 != DISAGG_LOST:
            raise AssertionError(f"fleet disagg (b): {reps} re-prefills, "
                                 f"{len(fired)} disagg.reprefill events")
        print(f"fleet disagg {quant} (b): prefill worker killed; {DISAGG_LOST} "
              f"fresh-prefix requests re-prefilled on the decode worker under "
              f"their deadlines, every one == the unified engine's, "
              f"{len(fired)} disagg.reprefill events; request s median "
              f"{float(np.median(waits)):.6f} [{card}]", flush=True)
        # PageSpiller: the unified engine sheds its coldest paths to a
        # neighbour, whose next request over the same prefix hits them
        nb_eng = _fleet_engine(params, DISAGG_POOL, "decode")
        nb = disagg.DisaggWorker(nb_eng)
        kv = uni._kv
        cold = kv.coldest(1)
        if not cold:
            raise AssertionError("fleet disagg spill: no cold path to spill")
        path, nd = [], cold[0]
        while nd is not None and nd.key is not None:
            path.append(nd.key)
            nd = nd.parent
        path.reverse()
        shared = DISAGG_PREFIX // FLEET_PAGE
        if len(path) <= shared:
            raise AssertionError(f"fleet disagg spill: cold path of {len(path)} pages")
        spiller = disagg.PageSpiller(kv, disagg.PageTransferClient(nb.host, nb.port),
                                     watermark=0.5, max_nodes=2)
        used = kv.used_pages()
        freed = spiller.maybe_spill()
        if freed <= 0 or kv.used_pages() != used - freed \
                or nb_eng.kv_stats["imported_pages"] <= 0:
            raise AssertionError(f"fleet disagg spill: freed {freed} of {used} used, "
                                 f"neighbour imported {nb_eng.kv_stats['imported_pages']}")
        rng = np.random.default_rng(23)
        probe = np.concatenate([np.asarray(k, np.int32) for k in path[:shared]]
                               + [rng.integers(0, FLEET_DIMS[0],
                                               2 * FLEET_PAGE).astype(np.int32)])
        router = QueryRouter(BackendSet([(nb.host, nb.port)], "spill"), "spill")
        router.set_caps_provider(lambda: disagg.LM_CAPS)
        hit0 = nb_eng.kv_stats["hit_tokens"]
        try:
            rmeta, _ = router.dispatch(
                {"lm": {"prompt": [int(x) for x in probe], "max_new": DISAGG_GEN}}, b"")
        finally:
            router.close()
        hits = nb_eng.kv_stats["hit_tokens"] - hit0
        want, _, _ = _unified(uni, [probe], DISAGG_GEN)
        if hits < DISAGG_PREFIX or rmeta.get("tokens") != want[0]:
            raise AssertionError(f"fleet disagg spill: the neighbour hit {hits} "
                                 f"tokens; tokens equal {rmeta.get('tokens') == want[0]}")
        print(f"fleet disagg {quant} spill: {freed} cold pages shed to a neighbour "
              f"({used} used of {DISAGG_POOL}); its next shared-prefix request hit "
              f"{hits} tokens of the spilled pages, tokens == the unified engine's "
              f"[{card}]", flush=True)
        by_phase[f"fleet disagg {quant} lost prefill"] = counters.read()
        return by_phase
    finally:
        client.close()
        if peer is not None:
            peer.close()
        for w in (pre_w, dec_w, nb):
            if w is not None:
                w.stop()
        events.disable()
        events.ring().reset()


def _mig_prompts() -> list:
    rng = np.random.default_rng(11)
    return [rng.integers(0, FLEET_DIMS[0], 3 * FLEET_PAGE).astype(np.int32)
            for _ in range(MIG_SESSIONS)]


def _warm_prompt() -> np.ndarray:
    return np.random.default_rng(99).integers(
        0, FLEET_DIMS[0], 3 * FLEET_PAGE).astype(np.int32)


def _warm(eng, gen: int) -> None:
    """Capture an engine's programs before its timed run: a no-hit and a
    prefix-hit admission and their decode chunks."""
    p = _warm_prompt()
    for _ in range(2):
        eng.submit(p, max_new=gen)
        eng.run()


def _lm_fleet(params, n: int, name: str, gen: int) -> tuple:
    from nnstreamer_tpu_torch.fleet.migrate import LM_CAPS
    from nnstreamer_tpu_torch.query.router import BackendSet, QueryRouter
    from nnstreamer_tpu_torch.serving import disagg

    engines = [_fleet_engine(params, MIG_POOL) for _ in range(n)]
    for e in engines:
        _warm(e, gen)
    workers = [disagg.DisaggWorker(e) for e in engines]
    router = QueryRouter(BackendSet([(w.host, w.port) for w in workers], name), name)
    router.set_caps_provider(lambda: LM_CAPS)
    return engines, workers, router


def _lm_turn(router, prompt, sid: str, gen: int) -> list:
    rmeta, _ = router.dispatch(
        {"lm": {"prompt": [int(x) for x in prompt], "max_new": gen, "session": sid}},
        b"", session=sid)
    return [int(t) for t in rmeta.get("tokens") or []]


def _mig_run(params, halve: bool) -> dict:
    """bench.py's _fleet_lane run: MIG_SESSIONS sessions x MIG_TURNS turns
    on MIG_WORKERS unified workers; with ``halve``, the controller's
    scale-in by hand twice at the middle turn (deterministic victim,
    migrate its census, drain). The workers stay up for the caller."""
    from nnstreamer_tpu_torch.fleet.migrate import SessionMigrator

    _peak_reset()
    engines, workers, router = _lm_fleet(params, MIG_WORKERS, "fleet-mig", MIG_GEN)
    mig = SessionMigrator(router)
    ok = total = 0
    toks, mig_secs = {}, []
    t0 = time.perf_counter()
    for turn in range(MIG_TURNS):
        if halve and turn == MIG_TURNS // 2:
            for _ in range(2):
                active = [be for be in router.backends.backends() if be.state == "active"]
                owned = router.backends.sessions_owned
                victim = min(active, key=lambda be: (len(owned(be.endpoint)), be.endpoint))
                for s in owned(victim.endpoint):
                    tgt = router.backends.pick(session=s,
                                               exclude=frozenset({victim.endpoint}))
                    if tgt is not None:
                        mig_secs.append(mig.migrate(s, victim, tgt)["seconds"])
                router.remove_backend(victim.endpoint, drain=True)
        for i, prompt in enumerate(_mig_prompts()):
            total += 1
            out = _lm_turn(router, prompt, f"fleet-s{i}", MIG_GEN)
            toks[(turn, i)] = out
            ok += bool(out)
    _fsync()
    return {"goodput": ok / max(1, total), "wall": time.perf_counter() - t0,
            "mig_secs": mig_secs, "stats": dict(mig.stats), "tokens": toks,
            "engines": engines, "workers": workers, "router": router,
            "peak": _peak_mib()}


def _stop_fleet(run: dict) -> None:
    run["router"].close()
    for w in run["workers"]:
        w.stop()


def run_fleet_migration(params, counters, card: str) -> tuple:
    """(c), then (e) on the unhalved run's workers."""
    from nnstreamer_tpu_torch.obs import health

    counters.reset()
    # health on before the unhalved run's engines are built: each registers
    # its warmed-readiness condition, which (e)'s push documents carry
    health.enable(interval_s=3600.0)
    try:
        full = _mig_run(params, halve=False)
        try:
            fed = run_federation(full, card)
        finally:
            _stop_fleet(full)
    finally:
        health.disable()
        health.registry().reset()
    halved = _mig_run(params, halve=True)
    _stop_fleet(halved)
    launches = counters.read()
    ratio = halved["goodput"] / max(full["goodput"], 1e-9)
    if ratio != 1.0 or halved["tokens"] != full["tokens"]:
        bad = [k for k in full["tokens"] if halved["tokens"].get(k) != full["tokens"][k]]
        raise AssertionError(f"fleet migration (c): goodput ratio {ratio}, turns "
                             f"differing from the unhalved run {bad[:8]}")
    st = halved["stats"]
    if st["migrated"] + st["absorbed"] == 0 or not launches.get("dequant_gelu_requant"):
        raise AssertionError(f"fleet migration (c): migrations {st}, launches {launches}")
    print(f"fleet migration (c): {MIG_WORKERS} workers halved twice mid-load, "
          f"{MIG_SESSIONS} sessions x {MIG_TURNS} turns x {MIG_GEN} tokens, w8a8: goodput "
          f"ratio {ratio:.4f}, every turn == the unhalved run's; migration "
          f"{float(np.mean(halved['mig_secs'])):.6f} s a session (max "
          f"{max(halved['mig_secs']):.6f}), {st['migrated']} migrated, {st['absorbed']} "
          f"absorbed, {st['pages_moved']} pages moved; wall {halved['wall']:.3f} s halved "
          f"against {full['wall']:.3f} s; peak memory {full['peak']:.1f} / "
          f"{halved['peak']:.1f} MiB [{card}]", flush=True)
    return launches, fed


def run_federation(run: dict, card: str) -> dict:
    """(e): an aggregator on an exporter; (c)'s workers push (half over the
    query wire, an OBS_PUSH frame on each worker's own connection; half
    over HTTP), each with its engine's prefix digest. Checks the federated
    /metrics, the worst-of-fleet /debug/fleet and /healthz, a silent worker
    going stalled and recovering, a page transfer's trace stitched across
    the sender and the receiving worker, and a routed request placed on
    its prefix's holder."""
    import socket
    import urllib.error
    import urllib.request

    from nnstreamer_tpu_torch import obs
    from nnstreamer_tpu_torch.obs import events, fleet as ofl, health, tracing
    from nnstreamer_tpu_torch.query import protocol
    from nnstreamer_tpu_torch.query import router as qrouter
    from nnstreamer_tpu_torch.serving import disagg
    from nnstreamer_tpu_torch.serving.kv_cache import prompt_path_hashes

    workers, engines, router = run["workers"], run["engines"], run["router"]
    tracing.enable()
    events.enable()
    events.ring().reset()
    agg = ofl.enable_aggregator(ttl_s=1.0, expire_after_s=600.0)
    exp = obs.start_exporter(port=0)
    base = exp.url.rsplit("/", 1)[0]
    pushers = []

    def digest(w):
        def read():
            with w._elock:
                return w.engine.kv_prefix_digest()
        return read

    def get(path):
        try:
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    half = len(workers) // 2

    def push(i):
        w, p = workers[i], pushers[i]
        if i >= half:
            if not p.push_now():
                raise AssertionError(f"fleet federation: HTTP push of {w.instance} failed")
            return
        frame = p.wire_frame()
        while frame is None:  # the wire interval (0.05 s) has not passed
            time.sleep(0.01)
            frame = p.wire_frame()
        with socket.create_connection((w.host, w.port), timeout=10) as s:
            protocol.send_message(s, protocol.Cmd.OBS_PUSH, *frame)
            protocol.send_message(s, protocol.Cmd.PING, {})
            protocol.recv_message(s)

    try:
        for i, w in enumerate(workers):
            pushers.append(ofl.FleetPusher(
                url=None if i < half else base,
                interval_s=0.05 if i < half else 3600.0,
                instance=w.instance, kv_digest=digest(w)))
        sp = _mig_prompts()[0]
        t0 = time.perf_counter()
        for i in range(len(workers)):
            push(i)
        push_s = time.perf_counter() - t0
        code, text = get("/metrics")
        text = text.decode()
        missing = [w.instance for w in workers if f'instance="{w.instance}"' not in text]
        if code != 200 or missing:
            raise AssertionError(f"fleet federation: /metrics {code}, no series of {missing}")
        code, body = get("/debug/fleet")
        snap = json.loads(body)
        if code != 200 or sorted(i["instance"] for i in snap["instances"]) \
                != sorted(w.instance for w in workers):
            raise AssertionError(f"fleet federation: /debug/fleet {code} {snap}")
        code, body = get("/healthz")
        hz = json.loads(body)
        if code != 200 or hz.get("fleet", {}).get("instances") != len(workers):
            raise AssertionError(f"fleet federation: /healthz {code} {hz}")
        # prefix placement: a request sharing a session's prompt lands on
        # the worker whose digest holds it
        hashes = prompt_path_hashes(sp, FLEET_PAGE)
        holder, depth = agg.longest_prefix(hashes)
        hw = next(w for w in workers if w.instance == holder)
        placed0 = qrouter._PREFIX_PLACED.labels(router.backends.owner).value
        hit0 = hw.engine.kv_stats["hit_tokens"]
        probe = np.concatenate([sp, np.random.default_rng(5).integers(
            0, FLEET_DIMS[0], 8).astype(np.int32)])
        rmeta, _ = router.dispatch({"lm": {"prompt": [int(x) for x in probe],
                                           "max_new": MIG_GEN}}, b"",
                                   prefix_hashes=hashes)
        placed = qrouter._PREFIX_PLACED.labels(router.backends.owner).value - placed0
        hits = hw.engine.kv_stats["hit_tokens"] - hit0
        if not rmeta.get("tokens") or placed != 1 or hits < depth * FLEET_PAGE:
            raise AssertionError(f"fleet federation: prefix placement placed {placed}, "
                                 f"holder {holder} hit {hits} of {depth} pages")
        # one page transfer under a root span: the sender's disagg.xfer
        # and the receiving worker's query.recv (the chunked frame's
        # assembly) share its trace; the workers' next pushes carry the
        # worker-side spans back to the aggregator
        src = next(i for i in range(len(workers)) if workers[i].instance != holder)
        with workers[src]._elock:
            doc = next(d for d in (engines[src]._kv.export_pages(q) for q in
                                   [_warm_prompt()] + _mig_prompts()) if d)
        chunked = len(disagg.encode_pages(doc)[1]) > protocol.CHUNK_SIZE
        xfer = disagg.PageTransferClient(hw.host, hw.port)
        with tracing.start_span("disagg.probe") as root:
            xfer.send_pages(doc)
        xfer.close()
        tid = root.context.trace_id
        for i in range(len(workers)):
            push(i)
        # the trace: the sender's span and the worker's, and copies that
        # came back through the workers' pushes
        code, body = get(f"/debug/traces/{tid}")
        tree = json.loads(body)

        def spans(node):
            out = [node]
            for c in node.get("children", []):
                out += spans(c)
            return out

        flat = [x for r in tree["tree"] for x in spans(r)]
        names = {s.get("name") for s in flat}
        pushed = {(s.get("attrs") or {}).get("instance") for s in flat} - {None}
        want = {"disagg.probe", "disagg.xfer"} | ({"query.recv"} if chunked else set())
        if code != 200 or not want <= names or not pushed & {w.instance for w in workers}:
            raise AssertionError(f"fleet federation: trace {tid}: {code}, spans "
                                 f"{sorted(n for n in names if n)}, pushed by {pushed}")
        # a worker that stops pushing goes stalled, then recovers
        quiet = workers[-1]
        time.sleep(1.2)
        for i in range(len(workers) - 1):
            push(i)
        health.check_now()
        code, body = get("/healthz")
        hz = json.loads(body)
        stalled = [c for c in hz["components"] if c["name"] == f"fleet:{quiet.instance}"]
        stall_ev = [e for e in events.ring().snapshot() if e["type"] == "fleet.stall"]
        if code != 503 or hz["status"] != "stalled" or not stalled \
                or stalled[0]["status"] != "stalled" or not stall_ev:
            raise AssertionError(f"fleet federation: a silent worker: /healthz {code} "
                                 f"{hz['status']}, {stalled}, {len(stall_ev)} stall events")
        for i in range(len(workers)):
            push(i)
        health.check_now()
        # in one process the workers' pushed health is this process's,
        # which held the stalled component until that check: push again
        for i in range(len(workers)):
            push(i)
        code, body = get("/healthz")
        rec_ev = [e for e in events.ring().snapshot() if e["type"] == "fleet.recover"]
        if code != 200 or not rec_ev:
            bad = [(c["name"], c["status"]) for c in json.loads(body)["components"]
                   if c["status"] != "ok"]
            raise AssertionError(f"fleet federation: recovery /healthz {code} {bad}, "
                                 f"{len(rec_ev)} recover events")
        print(f"fleet federation (e): {len(workers)} workers pushed ({half} over the "
              f"query wire, {len(workers) - half} over HTTP) in {push_s:.6f} s; /metrics "
              f"carries every worker's series under its instance label "
              f"({len(text)} bytes), /debug/fleet and /healthz roll up "
              f"{len(workers)} instances; a silent worker went stalled (503, fleet.stall) "
              f"and recovered (fleet.recover); trace {tid} stitched "
              f"({', '.join(sorted(want))}; spans pushed by {sorted(pushed)}); a routed "
              f"shared-prefix request placed on the digest's holder ({depth} pages, "
              f"{hits} tokens hit, nnstpu_router_prefix_placed_total +{placed:.0f}) "
              f"[{card}]", flush=True)
        return {"push_s": push_s}
    finally:
        for p in pushers:
            p.close()
        exp.close()
        ofl.disable_aggregator()
        events.disable()
        events.ring().reset()
        tracing.disable()
        tracing.store().reset()


def run_fleet_restore(params, counters, card: str) -> dict:
    """(d): bench.py's restore lane at the fleet widths: checkpoints to
    neighbour shelves, the busiest worker killed, its sessions restored
    onto the survivors; each restored session's next turn equals the same
    turn on an engine that never crashed; then the daemon's overhead."""
    from nnstreamer_tpu_torch.fleet import checkpoint as ckpt

    counters.reset()
    _peak_reset()
    engines, workers, router = _lm_fleet(params, RESTORE_WORKERS, "fleet-restore",
                                         RESTORE_GEN)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, FLEET_DIMS[0], 3 * FLEET_PAGE).astype(np.int32)
               for _ in range(RESTORE_SESSIONS)]
    daemons = []
    try:
        hist = {}
        for i, prompt in enumerate(prompts):
            sid = f"fleet-r{i}"
            hist[sid] = [int(x) for x in prompt] + _lm_turn(router, prompt, sid,
                                                             RESTORE_GEN)
        for i, w in enumerate(workers):
            peers = [workers[j].endpoint for j in range(len(workers)) if j != i]
            d = ckpt.CheckpointDaemon(engines[i], ckpt.NeighborStore(peers),
                                      lock=w._elock, name=f"fleet-ckpt-{i}")
            d.run_once()
            daemons.append(d)
        vi = max(range(len(workers)),
                 key=lambda i: len(router.backends.sessions_owned(workers[i].endpoint)))
        victim = workers[vi]
        moved = router.backends.sessions_owned(victim.endpoint)
        victim.kill()
        t0 = time.perf_counter()
        report = ckpt.SessionRestorer(router).restore_instance(
            victim.instance, victim.endpoint, daemons[vi].watermarks())
        restore_s = time.perf_counter() - t0
        live = [e for i, e in enumerate(engines) if i != vi]
        hit0 = sum(e.kv_stats["hit_tokens"] for e in live)
        tok0 = sum(e.kv_stats["prompt_tokens"] for e in live)
        after = {sid: _lm_turn(router, hist[sid], sid, RESTORE_GEN) for sid in moved}
        hits = sum(e.kv_stats["hit_tokens"] for e in live) - hit0
        toks = sum(e.kv_stats["prompt_tokens"] for e in live) - tok0
        warm = hits / max(1, toks)
    finally:
        router.close()
        for d in daemons:
            d.stop()
        for w in workers:
            w.stop()
    ref = _fleet_engine(params, MIG_POOL)
    want, _, _ = _unified(ref, [np.asarray(hist[s], np.int32) for s in moved], RESTORE_GEN)
    got = [after[s] for s in moved]
    if not moved or report["restored"] != len(moved) or got != want:
        raise AssertionError(f"fleet restore (d): {len(moved)} sessions moved, report "
                             f"{report['restored']} restored / {report['re_prefilled']} "
                             f"re-prefilled, tokens equal {got == want}")
    peak = _peak_mib()

    def serve(checkpointed: bool) -> float:
        eng = _fleet_engine(params, MIG_POOL)
        daemon = ckpt.CheckpointDaemon(eng, ckpt.MemoryStore(), name="fleet-ov")
        ov = {i: [int(x) for x in p] for i, p in enumerate(prompts)}
        n_tok, t0 = 0, time.perf_counter()
        for r in range(4):
            for i in range(RESTORE_SESSIONS):
                rid = eng.submit(np.asarray(ov[i], np.int32), max_new=RESTORE_GEN,
                                 session=f"ov-{i}")
                eng.run()
                out = [int(t) for t in eng.results[rid]]
                ov[i] += out
                n_tok += len(out)
            if checkpointed and r % 2 == 1:
                daemon.run_once()
        _fsync()
        return n_tok / (time.perf_counter() - t0)

    serve(True)
    base_runs, ckpt_runs = [], []
    for _ in range(RESTORE_REPS):
        base_runs.append(serve(False))
        ckpt_runs.append(serve(True))
    overhead = float(np.median(ckpt_runs)) / max(float(np.median(base_runs)), 1e-9)
    launches = counters.read()
    print(f"fleet restore (d): {RESTORE_WORKERS} workers, {RESTORE_SESSIONS} sessions, "
          f"checkpoints on neighbour shelves, the busiest worker killed: "
          f"{report['restored']} of {len(moved)} sessions restored from checkpoint in "
          f"{restore_s:.6f} s, warm ratio {warm:.4f}, their next turns == an uncrashed "
          f"engine's; checkpoint overhead ratio {overhead:.4f} (median of "
          f"{RESTORE_REPS} interleaved runs; the JAX bench gates 0.95, claimed nothing "
          f"here); peak memory {peak:.1f} MiB [{card}]", flush=True)
    return launches


def run_fleet_cli(tmp: str, card: str) -> None:
    """(f): ``nns-launch-torch`` in its own process with ``--role decode
    --kv-page-size 32 --obs-push wire --obs-aggregate --metrics-port 0
    --checkpoint-dir --autoscale 1:2 --backends A,B`` over two SSD-300
    query servers: exit 0 and the JAX CLI's ``fleet:`` lines."""
    import re

    opts = _ssd_opts(tmp)
    servers = [_ssd_server(60 + i, opts) for i in range(2)]
    try:
        backends = ",".join(f"127.0.0.1:{port}" for _, port in servers)
        source = (f"videotestsrc width=300 height=300 pattern=random "
                  f"num-buffers={FLEET_CLI_FRAMES} ! video/x-raw,format=RGB ! "
                  "tensor_converter")
        argv = [sys.executable, "-m", "nnstreamer_tpu_torch.cli",
                "--role", "decode", "--kv-page-size", str(FLEET_PAGE),
                "--obs-push", "wire", "--obs-aggregate", "--metrics-port", "0",
                "--checkpoint-dir", os.path.join(tmp, "ckpt"),
                "--autoscale", "1:2", "--backends", backends]
        if FLEET_DEVICE == "cpu":
            argv += ["--device", "cpu"]
        t0 = time.perf_counter()
        run = subprocess.run(argv + [f"{source} ! tensor_query_client ! tensor_sink"],
                             cwd=ROOT, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
    finally:
        for p, _ in servers:
            p.stop()
    want = [r"^fleet: aggregating as \S+ \(POST http://127\.0\.0\.1:\d+/fleet/push\)$",
            r"^fleet: pushing as \S+ \(query-wire piggyback\)$",
            r"^fleet: autoscaling 1\.\.2 replicas \(policy default\)$",
            r"^fleet: \d+ reconcile tick\(s\), \d+ up / \d+ in, \d+ migration\(s\)$"]
    lines = [ln for ln in run.stderr.splitlines() if ln.startswith("fleet:")]
    if run.returncode != 0 or len(lines) != len(want) \
            or not all(re.match(w, ln) for w, ln in zip(want, lines)):
        raise AssertionError(f"fleet cli (f): exit {run.returncode}, fleet lines {lines}, "
                             f"stderr {run.stderr[-2000:]}")
    print(f"fleet cli (f): nns-launch-torch --role decode --kv-page-size {FLEET_PAGE} "
          f"--obs-push wire --obs-aggregate --metrics-port 0 --checkpoint-dir DIR "
          f"--autoscale 1:2 --backends A,B over two SSD-300 query servers: exit 0 in "
          f"{wall:.3f} s (its own process), the JAX CLI's fleet lines: {lines} [{card}]",
          flush=True)


def run_fleet(counters) -> dict:
    """Phase 12c, sessions and the fleet on the card: (a) disaggregated
    w8a8 and float32 serving at full width against a unified engine, (b) a
    lost prefill worker and a page spill, (c) live migration through two
    halvings, (d) crash restore, (e) federation and fleet routing on (c)'s
    workers, (f) the CLI. Returns each part's launches."""
    from nnstreamer_tpu_torch import obs
    from nnstreamer_tpu_torch.models.causal_lm import quantize_lm_params

    card = _card()
    by_phase = {}
    obs.enable()
    try:
        params = _fleet_params()
        by_phase.update(run_fleet_disagg(params, "float32", counters, card, lost=False))
        _release()
        qparams = quantize_lm_params(params)
        del params
        by_phase.update(run_fleet_disagg(qparams, "w8a8", counters, card, lost=True))
        _release()
        by_phase["fleet migration"], _ = run_fleet_migration(qparams, counters, card)
        _release()
        by_phase["fleet restore"] = run_fleet_restore(qparams, counters, card)
        del qparams
        _release()
        counters.reset()
        with tempfile.TemporaryDirectory() as tmp:
            run_fleet_cli(tmp, card)
        by_phase["fleet cli"] = counters.read()
    finally:
        obs.disable()
    _release()
    return by_phase


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
    check_train_dir_resume(frames[:TRAIN_DIR_FRAMES])
    check_train_card_vs_cpu()


def check_train_dir_resume(frames: list) -> None:
    """``checkpoint_path=<dir> resume=true`` on the card: the first run
    trains ``frames`` and writes an orbax directory on EOS ({params,
    opt_state as optax's tuple, frames}); the directory's params equal the
    masters bit for bit; a second pipeline resumes from it at
    len(frames), its masters and adam's moments bit-equal to the
    directory's, and its EOS writes the same leaves back."""
    from nnstreamer_tpu_torch.utils import checkpoints

    n = len(frames)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "mobilenet_v2_ckpt")
        t0 = time.perf_counter()
        p, _, tr, _, _ = _train_pipeline("cuda", TRAIN_SPEC, ckpt, frames, serve=False)
        p.run(timeout=600)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        blob = checkpoints.load_variables(ckpt)
        load_s = time.perf_counter() - t0
        size = _dir_bytes(ckpt)
        masters = [t.cpu().numpy() for t in _tree_leaves(tr.params)]
        saved = _tree_leaves(blob["params"])
        if tr._n != n or blob["frames"] != n or int(blob["opt_state"][0]["count"]) != n \
                or blob["opt_state"][1] is not None or len(saved) != len(masters) \
                or any(a.tobytes() != b.tobytes() for a, b in zip(saved, masters)):
            raise AssertionError("train dir: the EOS directory differs from the masters")
        p2, src2, tr2, _, _ = _train_pipeline("cuda", TRAIN_SPEC, ckpt, serve=False)
        t0 = time.perf_counter()
        p2.start()
        resume_s = time.perf_counter() - t0
        try:
            m = tr2._masters
            resumed = {"params": tr2.params,
                       "mu": m.tree(tr2._opt_state["0"]["mu"]),
                       "nu": m.tree(tr2._opt_state["0"]["nu"])}
            want = {"params": blob["params"], "mu": blob["opt_state"][0]["mu"],
                    "nu": blob["opt_state"][0]["nu"]}
            for k in resumed:
                got = [t.cpu().numpy().tobytes() for t in _tree_leaves(resumed[k])]
                if tr2._n != n or got != [a.tobytes() for a in _tree_leaves(want[k])]:
                    raise AssertionError(f"train dir: resumed at {tr2._n} with {k} "
                                         "unlike the directory's")
            src2.end_of_stream()
            if not p2.wait_eos(300):
                raise AssertionError("train dir: the resumed pipeline did not end")
        finally:
            p2.stop()
        again = checkpoints.load_variables(ckpt)
        if any(a.tobytes() != b.tobytes() for a, b in
               zip(_tree_leaves(again["params"]), saved)) or again["frames"] != n:
            raise AssertionError("train dir: the resumed run wrote other leaves back")
    print(f"train checkpoint_path=<dir> resume=true: {n} frames then EOS in "
          f"{first_s:.3f} s, the orbax directory {size} bytes (params, adam's "
          f"moments, frames), read in {load_s:.3f} s, == the masters; resumed at {n} "
          f"(start {resume_s:.3f} s) with masters and moments == the directory's; "
          f"{_card()}", flush=True)


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

    from nnstreamer_tpu_torch import tune
    from nnstreamer_tpu_torch.obs import diag, quality, slo

    # the profiler's records stay (the kernel labels accumulate over the
    # phase); each run reads its own by time
    slo.disable()
    diag.disable()
    quality.disable()
    tune.disable(save=False)
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
    from nnstreamer_tpu_torch import tune
    from nnstreamer_tpu_torch.graph import element as gel
    from nnstreamer_tpu_torch.obs import diag, profile, quality, slo
    from nnstreamer_tpu_torch.ops import epilogue as epi

    hooks = {"DISPATCH_HOOK": profile.DISPATCH_HOOK,
             "ENGINE_HOOK": profile.ENGINE_HOOK,
             "KERNEL_HOOK": profile.KERNEL_HOOK, "SCHED_HOOK": profile.SCHED_HOOK,
             "PROFILE_CHAIN_HOOK": gel.PROFILE_CHAIN_HOOK,
             "EPILOGUE_SELECT_HOOK": epi.EPILOGUE_SELECT_HOOK,
             "SCHED_SLO_HOOK": slo.SCHED_SLO_HOOK, "ENGINE_SLO_HOOK": slo.ENGINE_SLO_HOOK,
             "ROUTER_SLO_HOOK": slo.ROUTER_SLO_HOOK, "DIAG_HOOK": diag.DIAG_HOOK,
             "QUALITY_HOOK": quality.QUALITY_HOOK, "TUNE_HOOK": tune.TUNE_HOOK}
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
                  tag: str, counters, flags=None, routes=OBS_ROUTES) -> dict:
    """bench.py's ssd_mobilenet_300_fps string through the CLI, obs on
    (``flags``, by default ``--metrics-port 0 --trace --watchdog --profile
    --events-dump``) or off; with ``scrape``, a second thread scrapes
    ``routes`` of the exporter while frames flow. Returns what the run
    showed."""
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
    if flags is None:
        flags = ["--metrics-port", "0", "--trace", "--watchdog", str(OBS_STALL_S),
                 "--profile", "--events-dump", events_path]
    flags = flags if on else []
    with _cli_objects() as box, _decoder_inputs() as rows, \
            _arrivals(TensorSink) as arrivals, _kept_programs() as programs:
        exporter = lambda: box["exporter"].port if "exporter" in box else None  # noqa
        playing = lambda: "pipeline" in box and box["pipeline"].running  # noqa
        scraper = _Scraper(exporter, routes, playing)
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


# --------------------------------------------------------------------------- #
# the obs layers on the base: slo, diag, quality, tune
# --------------------------------------------------------------------------- #

@contextlib.contextmanager
def _layer_objects():
    """What each layer's ``enable()`` built while inside (the CLI hands
    none back, and disables them at exit), by layer name."""
    from nnstreamer_tpu_torch import tune
    from nnstreamer_tpu_torch.obs import diag, quality, slo

    box, saved = {}, {}
    for name, mod in (("slo", slo), ("diag", diag), ("quality", quality),
                      ("tune", tune)):
        saved[name] = mod.enable

        def enabling(*a, _f=mod.enable, _n=name, **kw):
            box[_n] = _f(*a, **kw)
            return box[_n]

        mod.enable = enabling
    try:
        yield box
    finally:
        for name, mod in (("slo", slo), ("diag", diag), ("quality", quality),
                          ("tune", tune)):
            mod.enable = saved[name]


def _check_layers_ssd(run: dict, box: dict) -> dict:
    """The obs-on SSD run's layers: the tenant's SLO outcomes equal the
    frames, every quality tap saw observed + skipped frames (the filter's
    card-resident output skipped), every retained trace's critical-path
    segments sum to its duration exactly, and every layer route answered
    200 while the pipeline played. Returns the numbers."""
    from nnstreamer_tpu_torch.obs import tracing
    from nnstreamer_tpu_torch.obs.diag import critpath

    tag, frames = run["tag"], OBS_SSD_FRAMES
    row = box["slo"].snapshot()["tenants"][LAYER_TENANT]
    if sum(row["outcomes"].values()) != frames or row["outcomes"]["shed"]:
        raise AssertionError(f"layers ssd {tag}: SLO outcomes {row['outcomes']} for "
                             f"{frames} frames")
    taps = box["quality"].snapshot()["taps"]
    for name, t in taps.items():
        if t["seen"] != t["frames"] + t["skipped_device"]:
            raise AssertionError(f"layers ssd {tag}: tap {name} seen {t['seen']} != "
                                 f"{t['frames']} + {t['skipped_device']}")
    filt = taps.get(f"filter:filt_{tag}")
    if filt is None or filt["skipped_device"] != frames or filt["frames"]:
        raise AssertionError(f"layers ssd {tag}: the filter tap {filt} must skip "
                             f"all {frames} card-resident outputs")
    analysed = 0
    for summ in tracing.store().summaries():
        res = critpath.analyze(tracing.store().spans_of(summ["trace_id"]) or [])
        if res is None:
            continue
        analysed += 1
        if sum(res["segments"].values()) != res["total_ns"]:
            raise AssertionError(f"layers ssd {tag}: trace {res['trace_id']} segments "
                                 f"{res['segments']} do not sum to {res['total_ns']}")
    if not analysed:
        raise AssertionError(f"layers ssd {tag}: no trace to analyse")
    sc = run["scraper"]
    if sc is not None:  # the scraped turn (the other is the cost turn)
        for route in LAYER_ROUTES:
            codes = sc.while_playing(route)
            if not codes or any(c != 200 for c in codes):
                raise AssertionError(f"layers ssd {tag}: {route} while playing: {codes}")
        cp = json.loads(sc.last["/debug/diag/critpath"])
        tune_doc = json.loads(sc.last["/debug/tune"])
        if not cp["diag_enabled"] or not cp["traces_analyzed"] or not tune_doc["enabled"]:
            raise AssertionError(f"layers ssd {tag}: /debug/diag/critpath {cp}, "
                                 f"/debug/tune {tune_doc}")
    return dict(outcomes=row["outcomes"], analysed=analysed,
                taps={n: (t["seen"], t["frames"], t["skipped_device"])
                      for n, t in sorted(taps.items())},
                scrapes=len(sc.answers) if sc is not None else 0,
                bundles=len(box["diag"].bundles.list()))


def _tuned_rungs() -> dict:
    """The filter's bucket rung under the tuner: run_filter_options'
    ``bucket=4`` pipeline with the tuner on and an exporter, first with an
    empty store (each frame's rung is the default, and counted), then with
    a rung one up stored for padded size 4; /debug/tune lists the picks and
    the stored rung, and the outputs equal the tuner-off run's."""
    import urllib.request

    from nnstreamer_tpu_torch import obs, tune
    from nnstreamer_tpu_torch.core.types import Caps, TensorFormat, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.graph import Pipeline

    rng = np.random.default_rng(3)
    frames = [tuple(rng.standard_normal((7, 5, 3)).astype(np.float32) for _ in range(n))
              for n in (3, 1, 6, 9)]
    caps = Caps.tensors(TensorsConfig(TensorsInfo((), TensorFormat.FLEXIBLE), 30))

    def rung_model(x):  # the bundle's name is the tuner's label
        return x.amax(dim=(1, 2))

    def run():
        p = Pipeline("rungs")
        src = p.add_new("appsrc", caps=caps, data=list(frames))
        filt = p.add_new("tensor_filter", framework="torch-cuda", model=rung_model,
                         custom="bucket=4")
        sink = p.add_new("tensor_sink", store=True)
        Pipeline.link(src, filt, sink)
        p.run(timeout=120)
        return [b.memories[0].device() for b in sink.buffers]

    want = run()
    docs = []
    with tempfile.TemporaryDirectory() as tmp:
        tn = tune.enable(os.path.join(tmp, "rungs.json"), fit_from_profiler=False)
        exp = obs.start_exporter(port=0)
        try:
            got = run()
            if not _all_identical(got, want):
                raise AssertionError("tuned rungs: outputs differ from the tuner-off run")
            tn.store.put(tune.device_kind(), "rung_model", tune.shape_sig(("rung", 4)),
                         "xla_bucket_rung", 8, "sweep")
            got = run()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("tuned rungs: rung 8 outputs differ from rung 4's")
            with urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/debug/tune",
                                        timeout=30) as r:
                docs.append(json.loads(r.read()))
        finally:
            exp.close()
            tune.disable(save=False)
            obs.disable()
    st = docs[0]["local"]["stats"]
    # bucket 4 for 3 and 1 regions, 8 for 6, 12 for 9: four picks a run
    if st["picks"] != 8 or st["defaults"] != 6 or st["store_hits"] != 2 \
            or not any(k.endswith("|xla_bucket_rung") for k in docs[0]["local"]["entries"]):
        raise AssertionError(f"/debug/tune after the rung runs: {docs[0]}")
    return st


def _layers_lm_turn(qparams, mixes, mode: str, counters, keep: bool = False,
                    timed_gc: bool = False) -> dict:
    """bench.py's paged serving lane, w8a8, on a new 32-slot paged engine:
    each mix (requests with their deadlines) in turn, one session per prefix
    group. ``mode``: "off"; "layers" (slo, diag and quality, with tracing,
    health and events, which they read, and the tuner); "metrics",
    "tracing", "tracing full" (the span store left full by the run before)
    or "profile" alone. With ``timed_gc`` the collections a capture starts
    (core/graphs.py) are timed. Returns what the run showed."""
    from nnstreamer_tpu_torch import obs, sched, tune
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.obs import diag, events, health, profile, quality, slo, tracing
    from nnstreamer_tpu_torch.serving.lm_engine import LMEngine

    if mode != "tracing full":
        _obs_all_off()
    _hooks_off()
    box, confs, tmp = {}, {}, None
    if mode == "layers":
        tmp = tempfile.mkdtemp(prefix="layers-lm-")
        tracing.enable()
        health.enable(interval_s=3600.0)
        events.enable()
        box["slo"] = slo.enable()
        slo.set_objective("lm", p99_ms=LAYER_LM_P99_MS)
        box["diag"] = diag.enable(os.path.join(tmp, "bundles"))
        box["quality"] = quality.enable()
        box["tune"] = tune.enable(os.path.join(tmp, "tune.json"), fit_from_profiler=False)
        box["sched"] = sched.install()
        retire = LMEngine._retire_if_done

        def recording(self, slot, req):
            if req.conf is not None:
                confs[req.rid] = req.conf
            return retire(self, slot, req)

        LMEngine._retire_if_done = recording
    elif mode == "metrics":
        obs.enable()
    elif mode.startswith("tracing"):
        tracing.enable()
    elif mode == "profile":
        profile.enable()
    gc_s, real_gc = [], graphs.gc

    class _TimedGC:
        def __getattr__(self, name):
            return getattr(real_gc, name)

        def collect(self, *a):
            t0 = time.perf_counter()
            n = real_gc.collect(*a)
            gc_s.append(time.perf_counter() - t0)
            return n

    spans_before = sum(len(tracing.store().spans_of(x["trace_id"]) or [])
                       for x in tracing.store().summaries())
    graphs.reset_stats()
    if timed_gc:
        graphs.gc = _TimedGC()
    runs = []
    try:
        eng = _paged_engine(qparams, PAGED_SLOTS)
        counters.reset()
        for requests, deadlines in mixes:
            before = dict(eng.stats)
            rids = [eng.submit(p, max_new=g, deadline=dl, session=LAYER_SESSION)
                    for (p, g), dl in zip(requests, deadlines)]
            t0 = time.perf_counter()
            res = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append(dict(outs=[res[r] for r in rids], rids=rids, wall=wall,
                             stats={k: v - before[k] for k, v in eng.stats.items()}))
        launches = counters.read()
        captures = graphs.stats()["captures"]
        if mode == "layers":
            health.check_now()  # the p99 objective below the lane's latency
            box["snapshot"] = box["slo"].snapshot()
            box["bundles"] = box["diag"].bundles.list()
            box["requests"] = box["diag"].recent_requests()
            box["tn_stats"] = dict(box["tune"].stats)
            box["status"] = health.registry().component("slo:lm").status
    finally:
        graphs.gc = real_gc
        if mode == "layers":
            LMEngine._retire_if_done = retire
            sched.uninstall()
    spans = sum(len(tracing.store().spans_of(x["trace_id"]) or [])
                for x in tracing.store().summaries())
    tokens = [sum(len(o) for o in r["outs"]) for r in runs]
    out = dict(mode=mode, runs=runs, launches=launches, captures=captures,
               rate=tokens[0] / runs[0]["wall"], rate2=tokens[1] / runs[1]["wall"],
               gc_ms_per_capture=(sum(gc_s) * 1e3 / captures) if gc_s and captures else None,
               gc_calls=len(gc_s), spans_before=spans_before, spans=spans,
               box=box, confs=confs, tmp=tmp)
    if keep:
        out["eng"] = eng
    return out


def _plain_conf(logits: torch.Tensor) -> np.ndarray:
    """The confidence triple of one logits row in float64 torch ops."""
    p = torch.softmax(logits.to(torch.float64), dim=-1)
    ent = -torch.sum(torch.where(p > 0, p * torch.log(p), torch.zeros_like(p)))
    top2 = torch.topk(p, 2).values
    return np.array([ent.item(), top2[0].item(), (top2[0] - top2[1]).item()])


def _check_layers_lm(run: dict, off: dict, qparams, mixes) -> dict:
    """The obs-on paged run's layers: unshed tokens equal the obs-off run's
    (so the confidence admission's first tokens equal the plain one's), the
    expired requests shed without a slot, the SLO outcomes equal the
    engine's, each confidence triple within CONF_TOL of its plain float64
    computation from the same first-token logits (an eager full-prompt
    window prefill), the p99 breach writing exactly one bundle that
    nns-diag-torch reads back with its stanzas. Returns the numbers."""
    import io

    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.obs.diag import bundle as diag_bundle
    from nnstreamer_tpu_torch.obs.diag import cli as diag_cli
    from nnstreamer_tpu_torch.obs.health import Status
    from nnstreamer_tpu_torch.serving.lm_engine import next_pow2_bucket

    box = run["box"]
    want = {"met": 0, "missed": 0, "shed": 0}
    unshed = 0
    for mix, ref, (requests, deadlines) in zip(run["runs"], off["runs"], mixes):
        for out, ref_out, dl in zip(mix["outs"], ref["outs"], deadlines):
            if dl.expired() and not out:
                want["shed"] += 1
                continue
            unshed += 1
            want["missed" if dl.expired() else "met"] += 1
            if out != ref_out or not out:
                raise AssertionError("layers lm: an unshed request's tokens differ from "
                                     "the obs-off run's")
        n_exp = sum(1 for _, dl in zip(requests, deadlines) if dl.expired())
        if mix["stats"]["prefills"] != len(requests) - n_exp:
            raise AssertionError(f"layers lm: {mix['stats']['prefills']} prefills for "
                                 f"{len(requests)} requests, {n_exp} expired at submit")
    got = box["snapshot"]["tenants"]["lm"]["outcomes"]
    if got != want or not want["shed"]:
        raise AssertionError(f"layers lm: SLO outcomes {got} != the engine's {want}")
    if len(box["requests"]) != min(unshed, 512):
        raise AssertionError(f"layers lm: diag saw {len(box['requests'])} requests")
    # the confidence triples, against the same first-token logits
    worst, checked = 0.0, 0
    for mix, (requests, deadlines) in zip(run["runs"], mixes):
        for rid, (prompt, _), out in zip(mix["rids"], requests, mix["outs"]):
            if not out:
                continue
            t = len(prompt)
            tb = min(next_pow2_bucket(t), LM_MAX_LEN)
            padded = np.zeros((1, tb), np.int32)
            padded[0, :t] = prompt
            logits, _, _, _ = causal_lm.lm_prefill_window(
                qparams, torch.from_numpy(padded).cuda(),
                torch.tensor(t, dtype=torch.int32, device="cuda"), LM_DIMS[2], LM_MAX_LEN)
            if int(torch.argmax(logits[0])) != out[0]:
                raise AssertionError(f"layers lm: rid {rid}'s first token {out[0]} is not "
                                     "the argmax of its prefill logits")
            conf = run["confs"][rid].cpu().to(torch.float64).numpy()
            plain = _plain_conf(logits[0])
            if not np.allclose(conf, plain, rtol=CONF_TOL[0], atol=CONF_TOL[1]):
                raise AssertionError(f"layers lm: rid {rid} confidence {conf} != plain {plain}")
            worst = max(worst, float(np.max(np.abs(conf - plain) / (np.abs(plain) + 1e-12))))
            checked += 1
    # the breach: slo:lm DEGRADED, exactly one bundle (the rate limit)
    if box["status"] is not Status.DEGRADED or len(box["bundles"]) != 1:
        raise AssertionError(f"layers lm: slo:lm {box['status']}, bundles {box['bundles']}")
    path = os.path.join(run["tmp"], "bundles", box["bundles"][0]["id"] + ".json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = diag_cli.main([path, "--json"])
    doc = diag_bundle.load_bundle(path)
    stanzas = {k: doc.get(k) for k in ("slo", "sched", "profile", "events", "health")}
    if rc != 0 or json.loads(buf.getvalue())["id"] != doc["id"] \
            or any(v is None or "error" in v for v in stanzas.values()) \
            or "lm" not in doc["slo"]["tenants"] or not doc["events"]["events"] \
            or not isinstance(doc["routing"], list) \
            or doc["fleet_actions"] is not None:
        raise AssertionError(f"layers lm: nns-diag-torch read rc {rc}, bundle stanzas "
                             f"{ {k: type(v).__name__ for k, v in doc.items()} }")
    if run["box"]["tn_stats"]["trials"] or run["box"]["tn_stats"]["sweeps"]:
        raise AssertionError(f"layers lm: the tuner swept {run['box']['tn_stats']}")
    return dict(outcomes=got, conf_checked=checked, conf_worst_rel=worst,
                bundle=box["bundles"][0]["id"], cause=box["bundles"][0]["cause"]["kind"],
                captures=run["captures"], tuner=run["box"]["tn_stats"])


def _conf_admission_ms(on_eng, off_eng) -> list:
    """Device ms of one replay of each confidence admission graph beside the
    plain admission graph of the same signature (the other engine's), in
    turns: [(conf, plain), ...]."""
    pairs = []
    for prog in ("_paged_prefill_prog",):
        on_g, off_g = getattr(on_eng, prog)._graphs, getattr(off_eng, prog)._graphs
        for (args, static), g in sorted(on_g.items(), key=lambda kv: str(kv[0])):
            plain = off_g.get((args, tuple(kv for kv in static if kv[0] != "conf")))
            if ("conf", True) in static and plain is not None:
                a = _replay_ms(g.graph)
                b = _replay_ms(plain.graph)
                pairs.append((a, b, _replay_ms(g.graph), _replay_ms(plain.graph)))
    if not pairs:
        raise AssertionError("layers lm: no confidence admission graph beside a plain one")
    return pairs


def _tuned_flash(dev) -> dict:
    """The tuner on the card: an empty store sweeps flash's launch
    configurations at (8, 16, 1024, 64) causal, bf16 (wgmma) and float32
    (tf32x3), timing each with CUDA events; each configuration is held
    against the plain version; the saved store makes a new tuner pick the
    same with no trial. Returns the picks, the store path's directory and
    each configuration's device ms (CUDA-graph replay) and bound."""
    from nnstreamer_tpu_torch import tune
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa
    from nnstreamer_tpu_torch.tune import TuneStore, Tuner

    rng = np.random.default_rng(11)
    tmp = tempfile.mkdtemp(prefix="tune-")
    path = os.path.join(tmp, "tune.json")
    tn = tune.enable(path, fit_from_profiler=False)
    trials, trial = [], fa._trial_s

    def timed(q, causal, route, cfg):
        s_ = trial(q, causal, route, cfg)
        trials.append((str(q.dtype)[6:], cfg, s_))
        return s_

    fa._trial_s = timed
    picks, rows, sweep_s = {}, [], {}
    try:
        for dt in (torch.bfloat16, torch.float32):
            shape = (FLASH_B, 16, FLASH_T, 64)
            q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                       .to(dev, dt) for _ in range(3))
            route = fa._route(q, k, v)
            configs = fa.launch_configs(route, 64)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            picks[dt] = fa._tuned_config(q, True, route, configs)
            sweep_s[str(dt)[6:]] = time.perf_counter() - t0
            want = fa.flash_attention_plain(q, k, v, True)
            b, h, length, d = shape
            pairs = b * h * length * (length + 1) // 2
            nbytes, ops = 4 * q.numel() * q.element_size(), 4 * d * pairs
            bound, by = _bound_ms(nbytes, 3 * ops, "tf32") if dt == torch.float32 \
                else _bound_ms(nbytes, ops, dt)
            for cfg in configs:
                got = fa.flash_attention(q, k, v, True, config=cfg)
                torch.cuda.synchronize()
                if not _within(got, want, *FLASH_TOL[dt]):
                    raise AssertionError(f"flash {route} config {cfg} differs from plain: "
                                         f"max abs err {_max_abs_err(got, want)}")
                ms = _device_ms(lambda: fa.flash_attention(q, k, v, True, config=cfg), 5, 10)
                swept = min(t for n, c, t in trials if n == str(dt)[6:] and c == cfg) * 1e3
                rows.append(dict(dtype=str(dt)[6:], route=route, config=cfg,
                                 default=cfg == configs[0], ms=ms, sweep_ms=swept,
                                 max_abs_err=_max_abs_err(got, want), bound_ms=bound,
                                 bound_by=by, picked=cfg == picks[dt]))
        tn.store.save()
        if fa.flash_attention.tune_sweeps_in_capture:
            raise AssertionError("flash: a sweep ran inside a capture")
    finally:
        fa._trial_s = trial
        tune.disable(save=False)

    def never(cfg):
        raise AssertionError("a warm store swept")

    again = Tuner(store=TuneStore(path))
    for dt, pick in picks.items():
        shape_sig = tune.shape_sig(("b", FLASH_B), ("h", 16), ("l", FLASH_T), ("d", 64),
                                   ("c", 1), ("t", str(dt)[6:]))
        route = "wgmma" if dt == torch.bfloat16 else "tf32x3"
        got = again.pick("flash_launch", tune.device_kind(), f"cuda.flash_attention.{route}",
                         shape_sig, candidates=fa.launch_configs(route, 64),
                         default=None, measure=never)
        if got != pick:
            raise AssertionError(f"flash {route}: the saved store picks {got}, not {pick}")
    if again.stats["trials"] or again.stats["store_hits"] != 2:
        raise AssertionError(f"the warm tuner: {again.stats}")
    return dict(picks={str(k)[6:]: v for k, v in picks.items()}, rows=rows, path=path,
                trials=len(trials), sweep_s=sweep_s)


def _tuned_prefill(counters, path: str, picks: dict) -> dict:
    """The flash prefill lanes (bf16, float32) under CUDA graphs with the
    tuner on over the saved store, against the same lane with the picked
    configuration given explicitly and the tuner off: logits equal, no
    capture failed, no sweep inside a capture, no default taken in one, no
    trial; then an LM engine built with the tuner on makes no trial."""
    import functools

    from nnstreamer_tpu_torch import tune
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa
    from nnstreamer_tpu_torch.serving import LMEngine

    v, d, h, n_layers = LM_DIMS
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, v, (FLASH_B, FLASH_T)).astype(np.int32) for _ in range(2)]
    caps = Caps.tensors(TensorsConfig(TensorsInfo.from_strings(f"{FLASH_T}:{FLASH_B}",
                                                               "int32")))

    def run(params):
        p = Pipeline("tuned-prefill")
        src = p.add_new("appsrc", caps=caps, data=list(frames))
        filt = p.add_new("tensor_filter", framework="torch-cuda", model=causal_lm.prefill_bundle(
            params, h, FLASH_T, FLASH_B, flash=True))
        sink = p.add_new("tensor_sink", store=True)
        Pipeline.link(src, filt, sink)
        p.run(timeout=600)
        torch.cuda.synchronize()
        return [b.memories[0].device() for b in sink.buffers]

    launches, out = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        params = _lm_params(None if dt == torch.float32 else dt)
        tn = tune.enable(path, fit_from_profiler=False)
        before = (fa.flash_attention.tune_sweeps_in_capture,
                  fa.flash_attention.tune_capture_defaults, fa.flash_attention.tune_trials)
        graphs.reset_stats()
        counters.reset()
        try:
            tuned = run(params)
            launches[f"tuned prefill {name}"] = counters.read()
            st = graphs.stats()
            engine_trials = tn.stats["trials"]
            # chunk and page size left to the tuner: picked, never swept
            LMEngine(params, h, LM_MAX_LEN, n_slots=2, kv_pages=32)
        finally:
            tune.disable(save=False)
        after = (fa.flash_attention.tune_sweeps_in_capture,
                 fa.flash_attention.tune_capture_defaults, fa.flash_attention.tune_trials)
        plain_fa = causal_lm.flash_attention
        causal_lm.flash_attention = functools.partial(plain_fa, config=picks[name])
        try:
            named = run(params)
        finally:
            causal_lm.flash_attention = plain_fa
        if after != before or engine_trials or tn.stats["trials"] or st["captures"] < 1 \
                or tn.stats["store_hits"] < 2 * n_layers or tn.stats["defaults"] != 2:
            raise AssertionError(f"tuned prefill {name}: in-capture sweeps/defaults/trials "
                                 f"{before} -> {after}, tuner {tn.stats}, graphs {st}")
        if not _all_identical(tuned, named):
            raise AssertionError(f"tuned prefill {name}: logits differ from the lane with "
                                 f"config {picks[name]} given explicitly")
        out[name] = dict(captures=st["captures"], hits=tn.stats["store_hits"],
                         launches=launches[f"tuned prefill {name}"]["flash_attention"])
        del params
        _release()
    return dict(launches=launches, lanes=out)


def run_obs_layers(qparams, counters) -> dict:
    """The obs layers on the base (slo, diag, quality, tune) on the card:
    SSD-300 through the CLI on the DeviceEngine with all four on, against
    the same string with them off, in turns (off, on, off, on); the
    tuner's bucket rungs; bench.py's paged w8a8 lane with deadlines and
    sessions, slo, diag and quality on, against it off, in turns; the
    tuner's flash sweep and the flash prefill lanes under it; what the
    layers cost, split by obs layer, with the garbage collections a capture
    starts timed. Returns the launches of the runs."""
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa
    from nnstreamer_tpu_torch.resilience.policy import Deadline

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        priors = os.path.join(tmp, "box_priors.txt")
        write_box_priors(priors, size=300)
        labels = os.path.join(tmp, "coco.txt")
        with open(labels, "w") as f:
            f.write("\n".join(f"c{i}" for i in range(91)))
        ssd = {True: [], False: []}
        for i, on in enumerate(OBS_TURNS):
            flags = ["--sched", "--slo",
                     f"{LAYER_TENANT}:p99={LAYER_SSD_P99_MS}:goodput=0.99",
                     "--diag", os.path.join(tmp, f"diag{i}"), "--quality", "--tune",
                     os.path.join(tmp, f"tune{i}.json"), "--metrics-port", "0", "--trace",
                     "--profile", "--watchdog", str(OBS_STALL_S)]
            with _layer_objects() as box:
                run = _obs_ssd_turn(tmp, labels, priors, on, i == 1, f"l{i}", counters,
                                    flags=flags, routes=LAYER_ROUTES)
            if on:
                run["layers"] = _check_layers_ssd(run, box)
                launches[f"layers ssd {i}"] = run["launches"]
            del run["programs"], run["p"]
            _obs_all_off()
            _release()
            ssd[on].append(run)
        ref = ssd[False][0]
        for run in ssd[True] + ssd[False][1:]:
            if run["dets"] != ref["dets"] or not _all_identical(run["rows"], ref["rows"]):
                raise AssertionError(f"layers ssd {run['tag']}: boxes differ from the "
                                     "layers-off run")
    for run in ssd[True]:
        o = run["layers"]
        print(f"layers ssd {run['tag']} (bench.py's ssd_mobilenet_300_fps string, "
              f"{OBS_SSD_FRAMES} frames, CLI --sched --slo --diag --quality --tune "
              f"--metrics-port 0 --trace --profile --watchdog {OBS_STALL_S}): boxes == the "
              f"layers-off run; /debug/slo tenant {LAYER_TENANT} outcomes {o['outcomes']}; "
              f"quality taps (seen, observed, skipped on the card) {o['taps']}; "
              f"{o['analysed']} traces' critical paths sum exactly; "
              + (f"{o['scrapes']} scrapes of {len(LAYER_ROUTES)} routes, all 200 while "
                 "playing" if o["scrapes"] else "not scraped (a cost turn)")
              + f"; {o['bundles']} bundles", flush=True)
    rungs = _tuned_rungs()
    print(f"tuned rungs (bucket=4 filter, tuner on): /debug/tune stats {rungs}", flush=True)

    mixes = []
    for seed in (7, 8):
        requests = _paged_requests(seed)
        mixes.append((requests, [
            Deadline(time.monotonic() - 1.0) if i % LAYER_SHED_EVERY == 3
            else Deadline.after_s(3600.0) for i in range(len(requests))]))
    lm = {"off": [], "layers": []}
    for i, on in enumerate(OBS_TURNS):
        mode = "layers" if on else "off"
        lm[mode].append(_layers_lm_turn(qparams, mixes, mode, counters, keep=i < 2))
    first_on, first_off = lm["layers"][0], lm["off"][0]
    for run in lm["layers"] + lm["off"][1:]:
        for mix, ref in zip(run["runs"], first_off["runs"]):
            if mix["outs"] != ref["outs"]:
                raise AssertionError(f"layers lm {run['mode']}: tokens differ from the "
                                     "layers-off run")
    checked = _check_layers_lm(first_on, first_off, qparams, mixes)
    launches["layers lm w8a8"] = first_on["launches"]
    conf_pairs = _conf_admission_ms(first_on.pop("eng"), first_off.pop("eng"))
    _obs_all_off()
    _release()
    print(f"layers lm paged w8a8 ({PAGED_SLOTS} slots, {PAGED_POOL} pages of {PAGE_SIZE}, "
          f"2 mixes of {PAGED_REQUESTS} requests, every {LAYER_SHED_EVERY}th expired at "
          f"submit, session {LAYER_SESSION}; slo, diag, quality, tune on): unshed tokens == "
          f"the layers-off run (the confidence admission's first tokens == the plain "
          f"one's); SLO outcomes {checked['outcomes']} == the engine's; "
          f"{checked['conf_checked']} confidence triples within rtol {CONF_TOL[0]} atol "
          f"{CONF_TOL[1]} of float64 from the same logits (worst rel "
          f"{checked['conf_worst_rel']:.3e}); p99 {LAYER_LM_P99_MS} ms breach -> slo:lm "
          f"DEGRADED, one bundle ({checked['cause']}) read back by nns-diag-torch with its "
          f"stanzas; {checked['captures']} captures, none failed; tuner {checked['tuner']}",
          flush=True)
    print("confidence admission device ms per replay (conf, plain, conf, plain) by "
          f"signature: {conf_pairs}", flush=True)

    split = {}
    for mode, timed in (("off", True), ("metrics", False), ("tracing", True),
                        ("tracing full", True), ("profile", False)):
        split[mode] = _layers_lm_turn(qparams, mixes, mode, counters, timed_gc=timed)
        for mix, ref in zip(split[mode]["runs"], first_off["runs"]):
            if mix["outs"] != ref["outs"]:
                raise AssertionError(f"layers lm {mode}: tokens differ from the off run")
        _release()
    _obs_all_off()
    _hooks_off()

    dev = torch.device("cuda", 0)
    flash = _tuned_flash(dev)
    for r in flash["rows"]:
        print(f"tuned flash_attention (8, 16, 1024, 64) {r['dtype']} causal [{r['route']}] "
              f"config {r['config']}{' (default)' if r['default'] else ''}"
              f"{' PICKED' if r['picked'] else ''}: device ms/call (CUDA graph) "
              f"{r['ms']:.6f}, the sweep's best trial {r['sweep_ms']:.6f} ms, bound_ms "
              f"{r['bound_ms']:.8f} ({r['bound_by']}), max abs err vs plain "
              f"{r['max_abs_err']:.3e}", flush=True)
    prefill = _tuned_prefill(counters, flash["path"], flash["picks"])
    launches.update(prefill["launches"])
    print(f"tuned flash: picks {flash['picks']} after {flash['trials']} timed trials of "
          f"{fa.TRIAL_LAUNCHES} launches (sweep wall s {flash['sweep_s']}); a "
          f"new tuner on the saved store picks the same with 0 trials; prefill lanes under "
          f"the tuner {prefill['lanes']}: logits == the lanes with the pick given "
          f"explicitly, 0 sweeps and 0 defaults inside captures, an LM engine built with "
          f"the tuner on made 0 trials", flush=True)

    card = _card()
    cost = {"ssd_fps": {"off": [r["fps"] for r in ssd[False]],
                        "on": [r["fps"] for r in ssd[True]]},
            "lm_tokens_per_s": {"off": [r["rate"] for r in lm["off"]],
                                "on": [r["rate"] for r in lm["layers"]]},
            "lm_tokens_per_s_second_mix": {"off": [r["rate2"] for r in lm["off"]],
                                           "on": [r["rate2"] for r in lm["layers"]]},
            "split_tokens_per_s": {m: r["rate"] for m, r in split.items()},
            "split_second_mix": {m: r["rate2"] for m, r in split.items()},
            "gc_ms_per_capture": {m: r["gc_ms_per_capture"] for m, r in split.items()
                                  if r["gc_ms_per_capture"] is not None},
            "gc_calls": {m: r["gc_calls"] for m, r in split.items()},
            "spans_in_store": {m: (r["spans_before"], r["spans"]) for m, r in split.items()},
            "captures": {m: r["captures"] for m, r in split.items()},
            "conf_admission_ms": conf_pairs,
            "flash_configs": flash["rows"], "card": card}
    print(f"obs layers cost ({card}), turns off/on/off/on: SSD-300 steady frames/s off "
          f"{cost['ssd_fps']['off']}, on {cost['ssd_fps']['on']}; w8a8 paged lane "
          f"tokens/s on new engines off {cost['lm_tokens_per_s']['off']}, on "
          f"{cost['lm_tokens_per_s']['on']}, second mix off "
          f"{cost['lm_tokens_per_s_second_mix']['off']}, on "
          f"{cost['lm_tokens_per_s_second_mix']['on']}", flush=True)
    print(f"obs split on the new-engine mix ({card}): tokens/s {cost['split_tokens_per_s']}, "
          f"second mix {cost['split_second_mix']}; gc.collect ms per capture "
          f"{cost['gc_ms_per_capture']} over {cost['captures']} captures "
          f"({cost['gc_calls']} collections; spans in the store before/after "
          f"{cost['spans_in_store']})", flush=True)
    LOOP_STATS["obs layers"] = cost
    return launches


# -- the parallel layer (run_parallel): ranks on the one card -------------- #

#: the rank groups' collective timeout (s): a hung collective fails its rank
PAR_TIMEOUT = 120.0
#: where the ranks run (a rehearsal on the CPU sets "cpu" and small sizes)
PAR_DEVICE = "cuda"
PAR_FIRST_LOGITS = 4     # requests whose first-token logits are compared
#: the gloo groups (model 2 and 4) serve the first 10 of the mix's 24
#: requests (cut to keep the script's time; the gloo mix runs 16-113
#: tokens/s on one H100): all LM_SLOTS (8) slots filled, and requests 8 and
#: 9 admitted into the two slots the 32-token requests free mid-decode, so
#: a slot is reset and reused across the ranks; the longest request (128
#: tokens) still sets the decode steps
PAR_GLOO_REQUESTS = 10
PAR_CLOCK_STEPS = 5      # decode steps timed with COLLECTIVE_CLOCK on
#: sequence-parallel prefill: one 1024-token prompt over sp 4, every mode
SP_T, SP_WORLD, SP_DECODE = 1024, 4, 16
SP_MODES = ("ring", "ring-flash", "a2a", "a2a-flash")
#: against the single-card dense prefill: ring and a2a (float32 online
#: softmax over the shards against one softmax) within the JAX tests' ring
#: tolerance; the flash modes within PREFILL_F32_TOL, the float32 flash
#: prefill lane's own tolerance against dense (tf32x3 is 1e-5 of plain a
#: call, and 8 layers of d 1024 compound it: a2a-flash's K/V 3.8e-5 from the
#: dense prefill in the first run)
SP_TOL = {"ring": (2e-4, 2e-5), "a2a": (2e-4, 2e-5),
          "ring-flash": PREFILL_F32_TOL, "a2a-flash": PREFILL_F32_TOL}
#: make_tp_prefill -> make_tp_generate at model 4
TPG_PROMPT, TPG_STEPS = 512, 10
#: dryrun_multichip's sizes (__graft_entry__.py:99-360) on 4 ranks
DRY_SPEC = "zoo://mobilenet_v2?width=0.25&size=32&num_classes=16&batch=4&dtype=float32"
DRY_TOL = (2e-4, 2e-5)
DRY_TRAIN_STEPS = 3
DRY_CKPT_TOL = (1e-4, 1e-5)


def _par_cfg() -> dict:
    """What the rank functions need of this module's sizes, passed to them
    (a spawned rank imports this file afresh)."""
    return {"device": PAR_DEVICE, "dims": LM_DIMS, "max_len": LM_MAX_LEN,
            "slots": LM_SLOTS, "chunk": LM_CHUNK, "requests": LM_REQUESTS,
            "prompts": LM_PROMPTS, "gens": LM_GENS, "sp_t": SP_T,
            "tpg_prompt": TPG_PROMPT}


def _sync(cfg: dict) -> None:
    if cfg["device"] != "cpu":
        torch.cuda.synchronize()


def _par_requests(cfg: dict) -> list:
    v = cfg["dims"][0]
    rng = np.random.default_rng(5)
    prompts, gens = cfg["prompts"], cfg["gens"]
    return [(rng.integers(0, v, prompts[i % len(prompts)]).astype(np.int32),
             gens[i % len(gens)]) for i in range(cfg["requests"])]


#: this process's bench LM params by quant (a rank runs several parts on
#: them; nothing writes to them)
_PAR_PARAMS: dict = {}


def _par_params(cfg: dict, quant: str):
    """The bench LM from seed 0, float32 or w8a8 (quantized on the device),
    as every rank and the single-card reference build it; built once a
    process."""
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.models.convert import causal_lm_params

    if quant not in _PAR_PARAMS:
        if quant == "w8a8":
            _PAR_PARAMS[quant] = causal_lm.quantize_lm_params(_par_params(cfg, "float32"))
        else:
            v, d, h, n_layers = cfg["dims"]
            _PAR_PARAMS[quant] = causal_lm_params(causal_lm.init_causal_lm(
                0, v, d, h, n_layers, cfg["max_len"]), cfg["device"])
    return _PAR_PARAMS[quant]


def _padded(cfg: dict, prompt: np.ndarray) -> torch.Tensor:
    from nnstreamer_tpu_torch.serving import next_pow2_bucket

    tb = min(next_pow2_bucket(len(prompt)), cfg["max_len"])
    out = np.zeros((1, tb), np.int32)
    out[0, :len(prompt)] = prompt
    return torch.from_numpy(out).to(cfg["device"])


def par_tp_serve(cfg: dict, quant: str, eager: bool) -> dict:
    """A rank of the TP serving run: TPLMEngine over {"model": world} on the
    mix (after a one-step warm-up), the first-token logits of the
    first PAR_FIRST_LOGITS prompts through the TP admit prefill, and
    PAR_CLOCK_STEPS decode steps over the slots with the collectives
    clocked."""
    import torch.distributed as dist

    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel import mesh as pmesh
    from nnstreamer_tpu_torch.parallel.tp_decode import tp_decode_step_slots
    from nnstreamer_tpu_torch.parallel.tp_prefill import tp_prefill_window
    from nnstreamer_tpu_torch.serving import TPLMEngine

    mesh = make_mesh({"model": dist.get_world_size()})
    h, max_len = cfg["dims"][2], cfg["max_len"]
    requests = _par_requests(cfg)
    with graphs.disabled() if eager else contextlib.nullcontext():
        eng = TPLMEngine(_par_params(cfg, quant), h, max_len, mesh,
                         n_slots=cfg["slots"], chunk=cfg["chunk"])
        # warm-up: with graphs the whole mix, so the timed run replays as
        # the single-card reference's does; eagerly one prefill and one
        # step (handles, allocator, communicators: under gloo every step
        # pays its collectives)
        captured = graphs.enabled() and str(dist.get_backend()) != "gloo"
        for p, g in requests if captured else [(requests[0][0], 2)]:
            eng.submit(p, max_new=g)
        eng.run()
        graphs.reset_stats()
        before = dict(eng.stats)
        rids = [eng.submit(p, max_new=g) for p, g in requests]
        _sync(cfg)
        t0 = time.perf_counter()
        res = eng.run()
        _sync(cfg)
        wall = time.perf_counter() - t0
        st = graphs.stats()
        stats = {k: v - before[k] for k, v in eng.stats.items()}
        first = [tp_prefill_window(eng._tp, _padded(cfg, p), len(p), h, max_len, mesh,
                                   "model")[0][0].float().cpu().numpy()
                 for p, _ in requests[:PAR_FIRST_LOGITS]]
        # the decode step alone, its collectives clocked (the device is
        # synchronised around each, so the step runs slower than served)
        pmesh.COLLECTIVE_CLOCK = {}
        tok, pos = eng._tokens.clone(), eng._pos.clone().clamp(max=max_len - 8)
        _sync(cfg)
        t1 = time.perf_counter()
        for _ in range(PAR_CLOCK_STEPS):
            tp_decode_step_slots(eng._tp, tok, eng._kc, eng._vc, pos, h, mesh)
        _sync(cfg)
        step_ms = (time.perf_counter() - t1) * 1e3 / PAR_CLOCK_STEPS
        clock = {op: [c / PAR_CLOCK_STEPS, s * 1e3 / PAR_CLOCK_STEPS]
                 for op, (c, s) in pmesh.COLLECTIVE_CLOCK.items()}
        pmesh.COLLECTIVE_CLOCK = None
    return {"tokens": [res[r] for r in rids], "wall": wall, "stats": stats,
            "first_logits": np.stack(first), "captures": st["captures"],
            "replays": st["replays"], "lockstep": eng.lockstep_checks,
            "backend": str(dist.get_backend()), "step_ms": step_ms, "clock": clock,
            "kc_shape": tuple(eng._kc.shape)}


def _margin_at(cfg: dict, params, prompt: np.ndarray, ref: list, j: int) -> float:
    """The single-card top-2 logit margin at generated position ``j`` of
    ``prompt``'s greedy path ``ref`` (the window prefill, then steps)."""
    from nnstreamer_tpu_torch.models import causal_lm

    h, dev = cfg["dims"][2], cfg["device"]
    lg, kc, vc, pos = causal_lm.lm_prefill_window(
        params, torch.from_numpy(prompt[None]).to(dev), len(prompt), h, cfg["max_len"])
    for t in range(j):
        tok = torch.tensor([[ref[t]]], dtype=torch.int32, device=dev)
        lg, kc, vc, pos = causal_lm.lm_decode_step(params, tok, kc, vc, pos, h)
    top = torch.topk(lg[0].float(), 2).values
    return float(top[0] - top[1])


def _tp_serving_check(cfg: dict, name: str, res: list, want: list,
                      want_first: np.ndarray, quant: str, requests: list,
                      flips: list) -> dict:
    """Every rank's tokens against the single-card engine's: w8a8 equal and
    the first-token logits bit-equal; float32 equal, or each flip recorded
    with the single-card top-2 margin where it happened."""
    for r, rr in enumerate(res[1:], 1):
        if rr["tokens"] != res[0]["tokens"]:
            raise AssertionError(f"{name}: rank {r}'s tokens differ from rank 0's")
    got = res[0]["tokens"]
    first_err = float(np.max(np.abs(res[0]["first_logits"] - want_first)))
    mine = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            margin = _margin_at(cfg, _par_params(cfg, quant), requests[i][0], b, j)
            mine.append({"run": name, "request": i, "position": j,
                         "tp": a[j] if j < len(a) else None, "single": b[j],
                         "single_top2_margin": margin})
    flips += mine
    if quant == "w8a8" and (mine or first_err != 0.0):
        raise AssertionError(f"{name}: w8a8 tokens or first-token logits differ from the "
                             f"single-card engine's (flips {mine}, logits by {first_err})")
    return {"first_logits_max_abs_diff": first_err,
            "requests_equal": sum(a == b for a, b in zip(got, want))}


def par_sp_prefill(cfg: dict, mode: str) -> dict:
    """A rank of the sequence-parallel prefill: lm_prefill(mesh=sp) of one
    prompt under NNS_LM_SP_MODE=mode, timed, and the flash launches it made
    on this rank; rank 0 holds it against the single-card dense prefill
    (logits, K/V within SP_TOL[mode]) and SP_DECODE greedy steps from each
    cache."""
    import torch.distributed as dist

    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa
    from nnstreamer_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"sp": dist.get_world_size()})
    params = _par_params(cfg, "float32")
    v, _, h, _ = cfg["dims"]
    max_len = cfg["max_len"]
    tokens = torch.from_numpy(np.random.default_rng(17).integers(
        0, v, (1, cfg["sp_t"])).astype(np.int32)).to(cfg["device"])
    os.environ["NNS_LM_SP_MODE"] = mode
    try:
        causal_lm.lm_prefill(params, tokens, h, max_len, mesh=mesh)  # warm-up
        fa.flash_attention.launches = 0
        _sync(cfg)
        dist.barrier()
        t0 = time.perf_counter()
        lg, kc, vc, pos = causal_lm.lm_prefill(params, tokens, h, max_len, mesh=mesh)
        _sync(cfg)
        ms = (time.perf_counter() - t0) * 1e3
        launches = fa.flash_attention.launches
    finally:
        os.environ.pop("NNS_LM_SP_MODE", None)
    out = {"ms": ms, "launches": launches}
    if dist.get_rank() == 0:
        rl, rk, rv, rp = causal_lm.lm_prefill(params, tokens, h, max_len)
        rtol, atol = SP_TOL[mode]
        out.update(logits_err=_max_abs_err(lg, rl), k_err=_max_abs_err(kc, rk),
                   v_err=_max_abs_err(vc, rv),
                   within=_within(lg, rl, rtol, atol) and _within(kc, rk, rtol, atol)
                   and _within(vc, rv, rtol, atol) and int(pos[0]) == int(rp[0]))
        toks = {}
        for name, (l0, k, vv, p) in (("sp", (lg, kc, vc, pos)), ("single", (rl, rk, rv, rp))):
            tok = torch.argmax(l0, -1)[:, None].to(torch.int32)
            seq = [int(tok)]
            for _ in range(SP_DECODE - 1):
                l0, k, vv, p = causal_lm.lm_decode_step(params, tok, k, vv, p, h)
                tok = torch.argmax(l0, -1)[:, None].to(torch.int32)
                seq.append(int(tok))
            toks[name] = seq
        out["tokens"] = toks
    return out


def par_tp_generate(cfg: dict, quant: str) -> dict:
    """A rank of make_tp_prefill -> make_tp_generate; rank 0 also runs the
    single-card window prefill and steps."""
    import torch.distributed as dist

    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.parallel import make_mesh, make_tp_generate, tp_shard_params
    from nnstreamer_tpu_torch.parallel.tp_prefill import make_tp_prefill

    mesh = make_mesh({"model": dist.get_world_size()})
    params = _par_params(cfg, quant)
    v, _, h, _ = cfg["dims"]
    max_len, t = cfg["max_len"], cfg["tpg_prompt"]
    prompt = np.random.default_rng(23).integers(0, v, (1, t)).astype(np.int32)
    tp = tp_shard_params(params, h, mesh)
    _sync(cfg)
    t0 = time.perf_counter()
    lg, kc, vc, pos = make_tp_prefill(h, max_len, mesh)(tp, prompt)
    first = torch.argmax(lg, -1)[:, None].to(torch.int32)
    toks = make_tp_generate(h, max_len, mesh)(tp, first, kc, vc, pos, TPG_STEPS)
    _sync(cfg)
    out = {"ms": (time.perf_counter() - t0) * 1e3,
           "tokens": [int(first)] + toks[0].cpu().tolist()}
    if dist.get_rank() == 0:
        rl, rk, rv, rp = causal_lm.lm_prefill_window(
            params, torch.from_numpy(prompt).to(cfg["device"]), t, h, max_len)
        out["first_logits_diff"] = _max_abs_err(lg, rl)
        tok = torch.argmax(rl, -1)[:, None].to(torch.int32)
        seq = [int(tok)]
        for _ in range(TPG_STEPS):
            rl, rk, rv, rp = causal_lm.lm_decode_step(params, tok, rk, rv, rp, h)
            tok = torch.argmax(rl, -1)[:, None].to(torch.int32)
            seq.append(int(tok))
        out["single"] = seq
    return out


def _dry_stage_fn(p, h):
    return torch.tanh(h @ p["w"])


def par_dryrun(cfg: dict, ckpt_dir: str) -> dict:
    """dryrun_multichip's lanes on the ranks, each against its single-rank
    oracle: GPipe over every rank as a stage; MoE over data x expert 2; the
    sharded train step of DRY_SPEC over data 2 x model for DRY_TRAIN_STEPS
    steps against plain steps; a checkpoint saved at (2, n/2), restored at
    (n, 1) and stepped once against the unrestored state's step."""
    import torch.distributed as dist

    from nnstreamer_tpu_torch.filters.torch_cuda import resolve_model
    from nnstreamer_tpu_torch.models.convert import moe_params
    from nnstreamer_tpu_torch.models.zoo import ForwardModule
    from nnstreamer_tpu_torch.ops.optim import Optimizer
    from nnstreamer_tpu_torch.parallel import (
        init_moe_params, make_expert_parallel_moe, make_gpipe_apply, make_mesh,
        make_sharded_train_step, moe_apply, restore_sharded_state, save_sharded_state,
        sequential_apply, shard_stage_params, stack_stage_params)
    from nnstreamer_tpu_torch.parallel.sharding import full_value
    from nnstreamer_tpu_torch.parallel.train import cross_entropy_loss

    n, dev = dist.get_world_size(), torch.device(cfg["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    rtol, atol = DRY_TOL
    out = {}
    d = 8
    stacked = stack_stage_params([
        {"w": torch.from_numpy((rng.normal(size=(d, d)) / np.sqrt(d))
                               .astype(np.float32)).to(dev)} for _ in range(n)])
    x = torch.from_numpy(rng.normal(size=(2 * n, d)).astype(np.float32)).to(dev)
    pp_mesh = make_mesh({"stage": n})
    got = make_gpipe_apply(_dry_stage_fn, pp_mesh)(shard_stage_params(stacked, pp_mesh), x)
    want = sequential_apply(_dry_stage_fn, stacked, x)
    out["gpipe"] = (_within(got, want, rtol, atol), _max_abs_err(got, want))
    ep = next((k for k in range(n // 2, 1, -1) if n % k == 0), n)
    mp = moe_params(init_moe_params(0, d, 2 * d, ep), dev)
    xm = torch.from_numpy(rng.normal(size=(2 * (n // ep), 8, d)).astype(np.float32)).to(dev)
    fn, placed = make_expert_parallel_moe(mp, make_mesh({"data": n // ep, "expert": ep}))
    ym, aux = fn(placed, xm)
    yr, auxr = moe_apply(mp, xm)
    out["moe"] = (_within(ym, yr, rtol, atol)
                  and torch.equal(aux["expert_counts"], auxr["expert_counts"]),
                  _max_abs_err(ym, yr))
    bundle = resolve_model(DRY_SPEC, {}, dev)
    call = ForwardModule(bundle.module, bundle.forward)
    params = {k: t.detach().clone() for k, t in bundle.module.state_dict().items()
              if t.is_floating_point()}

    def apply_fn(p, xb):
        return torch.func.functional_call(call, {f"inner.{k}": t for k, t in p.items()},
                                          (xb,))

    size, classes, batch = 32, 16, 4
    xb = torch.from_numpy(rng.normal(size=(batch, size, size, 3)).astype(np.float32)).to(dev)
    yb = torch.from_numpy(rng.integers(0, classes, (batch,)).astype(np.int32)).to(dev)
    step, sp, so = make_sharded_train_step(apply_fn, params, make_mesh({"data": 2,
                                                                        "model": n // 2}))
    opt = Optimizer("sgd", 1e-3)
    ref = {k: v.clone() for k, v in params.items()}
    ref_state = {k: opt.init(v) for k, v in ref.items()}
    losses, ref_losses = [], []
    for _ in range(DRY_TRAIN_STEPS):
        sp, so, loss = step(sp, so, xb, yb)
        losses.append(float(loss))
        leaves = {k: v.detach().requires_grad_(True) for k, v in ref.items()}
        with torch.enable_grad():
            lr_ = cross_entropy_loss(apply_fn(leaves, xb), yb)
            grads = torch.autograd.grad(lr_, list(leaves.values()))
        for (k, v), g in zip(ref.items(), grads):
            opt.update(v, g, ref_state[k])
        ref_losses.append(float(lr_.detach()))
    full = {k: full_value(v) for k, v in sp.items()}
    out["train"] = (bool(np.allclose(losses, ref_losses, rtol=1e-4))
                    and all(_within(full[k], ref[k], *DRY_CKPT_TOL) for k in ref),
                    max(_max_abs_err(full[k], ref[k]) for k in ref), losses)
    path = os.path.join(ckpt_dir, "ckpt")
    save_sharded_state(path, sp, so)
    p_ref, _, loss_ref = step(sp, so, xb, yb)
    mesh_b = make_mesh({"data": n, "model": 1})
    step_b, pb_init, ob_init = make_sharded_train_step(apply_fn, params, mesh_b)
    pb, ob = restore_sharded_state(path, pb_init, mesh=mesh_b, opt_state_like=ob_init)
    p_res, _, loss_res = step_b(pb, ob, xb, yb)
    fa_ = {k: full_value(v) for k, v in p_res.items()}
    fr_ = {k: full_value(v) for k, v in p_ref.items()}
    out["ckpt"] = (bool(np.isclose(float(loss_res), float(loss_ref), rtol=1e-4))
                   and all(_within(fa_[k], fr_[k], *DRY_CKPT_TOL) for k in fr_),
                   max(_max_abs_err(fa_[k], fr_[k]) for k in fr_))
    dist.barrier()
    return out


def par_trainer(cfg: dict, mesh: str) -> dict:
    """tensor_trainer in a pipeline on this rank's device: a (fn, params)
    linear model, 6 frames of batch 4, sgd; ``mesh`` "data:2" or ""."""
    from nnstreamer_tpu_torch import core
    from nnstreamer_tpu_torch.graph import Pipeline

    rng = np.random.default_rng(0)
    true_w = rng.normal(size=(8, 4)).astype(np.float32)
    frames = []
    for _ in range(6):
        x = rng.normal(size=(4, 8)).astype(np.float32)
        frames.append((x, np.argmax(x @ true_w, -1).astype(np.int32)))
    w = (np.random.default_rng(3).normal(size=(8, 4)) * 0.1).astype(np.float32)
    p = Pipeline(device=cfg["device"])
    src = p.add_new("appsrc", caps=core.Caps.tensors(core.TensorsConfig(
        core.TensorsInfo.from_strings("8:4,4", "float32,int32"), 30)), data=frames)
    t = p.add_new("tensor_trainer", model=(lambda prm, xx: xx @ prm, w),
                  learning_rate=0.05, optimizer="sgd", mesh=mesh)
    Pipeline.link(src, t, p.add_new("fakesink"))
    p.run(timeout=120)
    return {"losses": list(t.losses), "params": t.params}


def _efficient_residuals(q, k, v, causal: bool) -> tuple:
    """PyTorch's memory-efficient attention with its log-sum-exp: the
    function of B5's residual mode in one library call (out = acc / l,
    lse = m + log l), timed beside the kernel and used nowhere in the port."""
    out, lse = torch.ops.aten._scaled_dot_product_efficient_attention(
        q, k, v, None, True, is_causal=causal)[:2]
    return out, lse[..., :q.shape[2]]


def _flash_ring_rows(fa) -> list:
    """B5 at the shapes (b) launches, in this process: the residual float32
    kernel at a ring shard pair (1, 16, SP_T/4, 64), full and causal, and
    the normalised float32 one at the a2a shape (1, 16/4, SP_T, 64) causal
    (``_flash_rows``)."""
    heads = LM_DIMS[2]
    hd = LM_DIMS[1] // heads
    return _flash_rows(fa, [
        ("residual full", (1, heads, SP_T // SP_WORLD, hd), False, True),
        ("residual causal", (1, heads, SP_T // SP_WORLD, hd), True, True),
        ("normalised causal", (1, heads // SP_WORLD, SP_T, hd), True, False)])


def _flash_sharded_rows(fa) -> list:
    """B5 at the shapes run_sharded launches: the stream transformer's
    ring-flash shard pair (1, 8, 4096/4, 16) residual and a2a-flash
    (1, 8/4, 4096, 16) normalised over sp 4, and the MoE transformer's over
    sp 2 (1, 8, 2048, 16) and (1, 4, 4096, 16); all full (not causal)."""
    import urllib.parse

    rows = []
    for name, spec, sp in (("stream", ST_SPEC, 4), ("moe", MOE_SP_SPEC, 2)):
        opts = dict(urllib.parse.parse_qsl(spec.split("?", 1)[1]))
        heads, dim, seq = int(opts["heads"]), int(opts["dim"]), int(opts["seq"])
        rows += _flash_rows(fa, [
            (f"{name} ring-flash residual full", (1, heads, seq // sp, dim // heads),
             False, True),
            (f"{name} a2a-flash normalised full", (1, heads // sp, seq, dim // heads),
             False, False)])
    return rows


def _flash_rows(fa, cases) -> list:
    """B5 at each (name, shape, causal, residual) float32 case: first held
    against plain (``_flash_case``: FLASH_TOL, m and l within 1e-5), then
    timed: device ms, plain ms, the bound, and the library call's ms: the
    memory-efficient attention with its log-sum-exp for the residual
    cases, SDPA for the normalised ones."""
    rows = []
    rng = np.random.default_rng(31)
    for name, shape, causal, resid in cases:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
                   for _ in range(3))
        err = _flash_case(fa, q, k, v, causal, f"{shape} float32 {name}")
        ms = _device_ms(lambda: fa.flash_attention(q, k, v, causal, return_residuals=resid),
                        5, 10)
        pms = _device_ms(lambda: fa.flash_attention_plain(q, k, v, causal,
                                                          return_residuals=resid), 2, 3)
        if resid:
            acc, m, l_sum = fa.flash_attention(q, k, v, causal, return_residuals=True)
            lo, lse = _efficient_residuals(q, k, v, causal)
            # how far the library's (out, lse) lies from the kernel's (acc / l, m + log l)
            lib_err = max(_max_abs_err(lo, acc / l_sum[..., None]),
                          _max_abs_err(lse, m + torch.log(l_sum)))
            lms = _device_ms(lambda: _efficient_residuals(q, k, v, causal), 10, 10)
            lib = (f"{lms:.6f} (_scaled_dot_product_efficient_attention with its "
                   f"log-sum-exp; from the kernel's acc/l and m + log l by {lib_err:.3e})")
        else:
            lms = _device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal), 10, 10)
            lib = f"{lms:.6f} (scaled_dot_product_attention)"
        b, h, length, d = shape
        pairs = b * h * length * (length + 1) // 2 if causal else b * h * length * length
        nbytes = 4 * q.numel() * 4 + (2 * b * h * length * 4 if resid else 0)
        # the tf32x3 route: three tf32 products for each float32 one
        bound, by = _bound_ms(nbytes, 3 * 4 * d * pairs, "tf32")
        rows.append({"case": name, "shape": shape, "max_abs_err": err, "ms": ms,
                     "plain_ms": pms, "bound_ms": bound, "bound_by": by, "library_ms": lms})
        print(f"flash_attention {name} {shape} float32 [{fa._route(q, k, v)}] device "
              f"ms/call (CUDA graph): kernel={ms:.6f} plain={pms:.6f} library={lib}; "
              f"bound_ms={bound:.8f} ({by})", flush=True)
    return rows


def run_parallel(counters) -> dict:
    """The parallel layer, ranks started by parallel/launch.py on the card:
    (a) TP serving of the bench LM's mix, float32 and w8a8, at model 2 and 4
    (gloo, the ranks sharing the card, eager) and model 1 (NCCL, CUDA graphs
    and eagerly), against the single-card LMEngine; (b) the
    sequence-parallel prefill over sp 4 in every mode against the
    single-card prefill, with B5's launches across the ranks; (c)
    make_tp_prefill -> make_tp_generate at model 4; (d) dryrun_multichip's
    GPipe, MoE, sharded train step and checkpoint re-shape on 4 ranks, and
    the trainer's mesh=data:2 on 2. Returns the launches by part (the
    ranks' flash launches summed)."""
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa

    cfg = _par_cfg()
    card = _card() if PAR_DEVICE != "cpu" else "cpu"
    t_phase = time.perf_counter()
    requests = _par_requests(cfg)
    h, max_len = cfg["dims"][2], cfg["max_len"]
    by_phase = {}
    rows = []
    if PAR_DEVICE != "cpu":  # timing launches: no path's count
        rows = _flash_ring_rows(fa) + _flash_sharded_rows(fa)
    want, want_first, single_rate = {}, {}, {}
    for quant in ("float32", "w8a8"):
        params = _par_params(cfg, quant)
        counters.reset()
        eng = _single_engine(params, cfg)
        _serve_on(eng, requests)  # warm-up: every capture, then replays
        outs, wall = _serve_on(eng, requests)
        by_phase[f"parallel single-card {quant}"] = counters.read()
        want[quant] = outs
        single_rate[quant] = sum(len(o) for o in outs) / wall
        want_first[quant] = np.stack([
            causal_lm.lm_prefill_window(params, _padded(cfg, p), len(p), h, max_len)[0][0]
            .float().cpu().numpy() for p, _ in requests[:PAR_FIRST_LOGITS]])
        del params, eng
        _release()
    flips, tp_lines, sp_res, tpg, sharded_lines = [], {}, {}, {}, {}
    ckpt_dir = tempfile.mkdtemp(prefix="nns_ckpt_")
    plan = ((2, None, (False,)), (4, None, (False,)),
            (1, "nccl" if PAR_DEVICE != "cpu" else None, (False, True)))
    t0 = time.perf_counter()
    groups = _start_groups([(world, backend) for world, backend, _ in plan])
    print(f"rank groups of {[w for w, _, _ in plan]} started together in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    try:
        for world, backend, modes in plan:
            t0 = time.perf_counter()
            with groups.pop(world) as g:
                n_req = PAR_GLOO_REQUESTS if world > 1 else cfg["requests"]
                if n_req <= cfg["slots"]:
                    raise AssertionError(f"model {world}: {n_req} requests fill "
                                         f"{cfg['slots']} slots without reusing one")
                wcfg = dict(cfg, requests=n_req)
                w_tokens = sum(gen for _, gen in requests[:n_req])
                for quant in ("float32", "w8a8"):
                    for eager in modes:
                        res = g.run(par_tp_serve, wcfg, quant, eager)
                        r0 = res[0]
                        graphed = not eager and r0["backend"] != "gloo"
                        name = f"tp model {world} {quant} {'graphs' if graphed else 'eager'}"
                        chk = _tp_serving_check(cfg, name, res, want[quant][:n_req],
                                                want_first[quant][:n_req], quant,
                                                requests[:n_req], flips)
                        tp_lines[name] = {
                            "requests": n_req, "tokens_per_s": w_tokens / r0["wall"],
                            "single_card_tokens_per_s": single_rate[quant],
                            "backend": r0["backend"], "decode_steps": r0["stats"]["decode_steps"],
                            "prefills": r0["stats"]["prefills"], "captures": r0["captures"],
                            "replays": r0["replays"], "lockstep_checks": r0["lockstep"],
                            "clocked_step_ms": max(r["step_ms"] for r in res),
                            "collective_ms_per_step": {
                                op: max(r["clock"].get(op, [0, 0.0])[1] for r in res)
                                for op in r0["clock"]},
                            "collectives_per_step": {op: c for op, (c, _) in r0["clock"].items()},
                            "kc_shape": r0["kc_shape"], **chk}
                        print(f"{name} (ranks on {PAR_DEVICE}, {r0['backend']}): {w_tokens} tokens "
                              f"in {r0['wall']:.3f} s = {w_tokens / r0['wall']:.2f} tokens/s "
                              f"(single card {single_rate[quant]:.2f}); "
                              f"{json.dumps(tp_lines[name])}", flush=True)
                if world == SP_WORLD:
                    for mode in SP_MODES:
                        res = g.run(par_sp_prefill, cfg, mode)
                        r0 = res[0]
                        launches = sum(r["launches"] for r in res)
                        want_l = 0 if PAR_DEVICE == "cpu" else {
                            "ring": 0, "a2a": 0,
                            "ring-flash": cfg["dims"][3] * world * (world + 1) // 2,
                            "a2a-flash": cfg["dims"][3] * world}[mode]
                        if not r0["within"] or r0["tokens"]["sp"] != r0["tokens"]["single"] \
                                or launches != want_l:
                            raise AssertionError(
                                f"sp prefill {mode}: within {r0['within']} (logits "
                                f"{r0['logits_err']}, K {r0['k_err']}, V {r0['v_err']}), tokens "
                                f"{r0['tokens']}, flash launches {launches} (want {want_l})")
                        sp_res[mode] = {"ms": max(r["ms"] for r in res),
                                        "flash_launches": launches,
                                        "per_rank": [r["launches"] for r in res],
                                        "logits_err": r0["logits_err"], "k_err": r0["k_err"],
                                        "v_err": r0["v_err"]}
                        print(f"sp prefill {mode} (sp {world}, T {cfg['sp_t']}, float32): "
                              f"{json.dumps(sp_res[mode])}; {SP_DECODE} greedy tokens from its "
                              f"cache == from the single-card cache", flush=True)
                    for quant in ("float32", "w8a8"):
                        res = g.run(par_tp_generate, cfg, quant)
                        r0 = res[0]
                        if any(r["tokens"] != r0["tokens"] for r in res) or (
                                quant == "w8a8" and (r0["tokens"] != r0["single"]
                                                     or r0["first_logits_diff"] != 0.0)):
                            raise AssertionError(f"tp prefill+generate {quant}: {r0}")
                        tpg[quant] = {"ms": max(r["ms"] for r in res),
                                      "tokens_equal": r0["tokens"] == r0["single"],
                                      "first_logits_max_abs_diff": r0["first_logits_diff"]}
                        if r0["tokens"] != r0["single"]:
                            flips.append({"run": f"tp prefill+generate {quant}",
                                          "tp": r0["tokens"], "single": r0["single"]})
                        print(f"tp prefill+generate model {world} {quant} (prompt "
                              f"{cfg['tpg_prompt']}, {TPG_STEPS} steps): {json.dumps(tpg[quant])}",
                              flush=True)
                    res = g.run(par_dryrun, cfg, ckpt_dir)
                    if not all(r[k][0] for r in res for k in ("gpipe", "moe", "train", "ckpt")):
                        raise AssertionError(f"dryrun lanes: {res}")
                    dry = res[0]
                    print(f"dryrun lanes on {world} ranks, each == its single-rank oracle: gpipe "
                          f"max err {dry['gpipe'][1]:.3e}, moe {dry['moe'][1]:.3e}, train "
                          f"({DRY_TRAIN_STEPS} steps, losses {dry['train'][2]}) "
                          f"{dry['train'][1]:.3e}, checkpoint (2, 2) -> (4, 1) "
                          f"{dry['ckpt'][1]:.3e}", flush=True)
                    sharded = run_sharded(g, card)
                    by_phase.update(sharded["launches"])
                    sharded_lines.update(sharded["lines"])
                if world == 1:
                    sharded_lines["a nccl"] = run_sharded_nccl(g, card)
                if world == 2:
                    got = g.run(par_trainer, cfg, "data:2")
                    ref = g.run(par_trainer, cfg, "")[0]
                    for r in got:
                        if not (np.allclose(r["losses"], ref["losses"], rtol=1e-4)
                                and np.allclose(r["params"], ref["params"], rtol=1e-4,
                                                atol=1e-5)):
                            raise AssertionError(f"trainer mesh=data:2: {r} against {ref}")
                    print(f"trainer mesh=data:2 on {PAR_DEVICE}: losses {got[0]['losses']} == "
                          f"the unsharded trainer's within rtol 1e-4", flush=True)
            print(f"rank group of {world} ({g.backend}): {time.perf_counter() - t0:.3f} s",
                  flush=True)
    finally:
        for g in groups.values():
            g.close()
        _PAR_PARAMS.clear()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"tp float32 flips against the single-card engine: {json.dumps(flips)}",
          flush=True)
    by_phase["parallel sp prefill"] = {
        "flash_attention": sum(v["flash_launches"] for v in sp_res.values())}
    print(f"parallel phase: {time.perf_counter() - t_phase:.3f} s; {card}; "
          f"{json.dumps({'b5_rows': rows, 'tp': tp_lines, 'sp': sp_res, 'tp_generate': tpg, 'sharded': sharded_lines})}",
          flush=True)
    return by_phase


# -- sharded serving and the model families (run_sharded): ranks on the card - #

#: (a) full-width MobileNet-v2 served sharded over auto_mesh_2d(4) (data 2 x
#: model 2) behind tensor_query, against the unsharded bundle on the card
SHARD_SPEC = ("zoo://mobilenet_v2?width=1.0&size=224&num_classes=1001&batch=8"
              "&dtype=float32")
SHARD_BATCH, SHARD_SIZE = 8, 224
SHARD_FRAMES = 16        # batches through the composite check
SHARD_UNEVEN = (9, 5, 1)  # batches the data axis does not divide
SHARD_RETRY = 6          # frames through the failover check
SHARD_NCCL = 4           # batches through the 1-rank NCCL group
SHARD_TOL = (2e-4, 2e-5)
#: (b) the stream transformer at zoo widths, seq 4096, over sp 4; and the
#: aggregator -> filter pipeline at the zoo defaults (seq 256, bf16)
ST_SPEC = "zoo://stream_transformer?layers=2&dim=128&heads=8&seq=4096&dtype=float32"
ST_PIPE_SPEC = "zoo://stream_transformer"
ST_PIPE_WINDOWS = 4
ST_TOL = (5e-3, 5e-4)    # JAX's own for the sequence-parallel forward
ST_PIPE_TOL = (1e-1, 1e-1)  # bf16 through 2 layers against the float32 model
#: (c) the MoE transformer at zoo widths, float32: ep_bundle on {data 2,
#: expert 2} at seq 256 batch 2; sp x ep on {sp 2, expert 2} at seq 4096
MOE_EP_SPEC = ("zoo://moe_transformer?layers=2&dim=128&heads=8&experts=8&seq=256"
               "&batch=2&capacity_factor=1.25&dtype=float32")
MOE_SP_SPEC = ("zoo://moe_transformer?layers=2&dim=128&heads=8&experts=8&seq=4096"
               "&capacity_factor=1.25&dtype=float32")
MOE_TOL = (2e-4, 2e-5)
MOE_SP_MODES = ("ring-flash", "a2a-flash")
#: (d) the two convnets through image_labeling
LENET_SPEC, LENET_FRAMES = "zoo://lenet", 16
V1_SPEC, V1_FRAMES, V1_SIZE = "zoo://mobilenet_v1", 8, 224
#: where (b)'s pipeline and (d) run (a rehearsal on the CPU sets "cpu")
FAMILY_DEVICE = "cuda"


def _shard_cfg() -> dict:
    """What the sharded rank functions need of this module's sizes."""
    return {"device": PAR_DEVICE, "shard_spec": SHARD_SPEC, "batch": SHARD_BATCH,
            "size": SHARD_SIZE, "uneven": SHARD_UNEVEN, "st_spec": ST_SPEC,
            "moe_ep_spec": MOE_EP_SPEC, "moe_sp_spec": MOE_SP_SPEC}


def _shard_frames(cfg: dict, batches, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (b, cfg["size"], cfg["size"], 3)).astype(np.uint8)
            for b in batches]


def _seq_input(spec_meta: dict, batch: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (batch, spec_meta["seq"], spec_meta["dim"]), dtype=np.float32)


def _lead_or_follow(served, calls):
    """Rank 0 opens a filter on ``served`` on its card and returns
    ``calls(filter)``, closing it (which stops the session); the others
    follow and return their invoke counts."""
    import torch.distributed as dist

    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter
    from nnstreamer_tpu_torch.parallel import follow

    if dist.get_rank() != 0:
        return follow(served)
    filt = TorchCudaFilter()
    filt.open(FilterProps(model=served, device=served.metadata["input_sharding"]))
    try:
        return calls(filt)
    finally:
        filt.close()


def _invoke_host(filt, x: np.ndarray) -> np.ndarray:
    from nnstreamer_tpu_torch.core.buffer import TensorMemory

    return filt.invoke([TensorMemory(torch.from_numpy(x))])[0].host()


def shard_uneven_reload(cfg: dict) -> dict:
    """A rank of (a)'s filter run: the sharded MobileNet-v2 through the
    leader's filter on batches of ``cfg["uneven"]`` (zero-padded to the data
    axis and trimmed), then a hot reload to the bundle at seed 7 and one
    full batch; every collective clocked (COLLECTIVE_CLOCK)."""
    from nnstreamer_tpu_torch.models.zoo import get_model
    from nnstreamer_tpu_torch.parallel import auto_mesh_2d, sharded_bundle
    from nnstreamer_tpu_torch.parallel import mesh as pmesh
    from nnstreamer_tpu_torch.parallel.launch import rank_device

    dev = rank_device()
    mesh = auto_mesh_2d()
    s1 = sharded_bundle(get_model(cfg["shard_spec"], device=dev), mesh)
    s2 = sharded_bundle(get_model(cfg["shard_spec"] + "&seed=7", device=dev), mesh)

    def calls(filt):
        outs = [_invoke_host(filt, x) for x in _shard_frames(cfg, cfg["uneven"], 5)]
        filt.reload_model(s2)
        outs.append(_invoke_host(filt, _shard_frames(cfg, (cfg["batch"],), 6)[0]))
        return {"outs": outs, "invokes": s1.metadata["session"].invokes}

    pmesh.COLLECTIVE_CLOCK = {}
    try:
        out = _lead_or_follow(s1, calls)
        out["clock"] = dict(pmesh.COLLECTIVE_CLOCK)
        return out
    finally:
        pmesh.COLLECTIVE_CLOCK = None


def _timed_forward(cfg: dict, fn, x: torch.Tensor) -> tuple:
    """(output, ms, flash launches) of ``fn(x)`` after one warm-up call."""
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa

    fn(x)
    _sync(cfg)
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    y = fn(x)
    _sync(cfg)
    return y, (time.perf_counter() - t0) * 1e3, fa.flash_attention.launches


def stream_sp(cfg: dict, mode: str) -> dict:
    """A rank of (b): ``make_sp_apply`` of the stream transformer over every
    rank on ``sp`` in ``mode``, the whole seeded input on every rank; the
    whole output (rank 0), the forward's ms and this rank's B5 launches."""
    import torch.distributed as dist

    from nnstreamer_tpu_torch.models.stream_transformer import make_sp_apply
    from nnstreamer_tpu_torch.models.zoo import get_model
    from nnstreamer_tpu_torch.parallel import make_mesh, mesh as pmesh
    from nnstreamer_tpu_torch.parallel.launch import rank_device

    dev = rank_device()
    bundle = get_model(cfg["st_spec"], device=dev)
    apply, params = make_sp_apply(bundle, make_mesh({"sp": pmesh.world()}), mode)
    x = torch.from_numpy(_seq_input(bundle.metadata, 1, 11)).to(dev)
    y, ms, launches = _timed_forward(cfg, lambda t: apply(params, t), x)
    return {"y": y if dist.get_rank() == 0 else None, "ms": ms, "launches": launches}


def moe_ep_serve(cfg: dict) -> dict:
    """A rank of (c)'s filter run: ``ep_bundle`` over {data 2, expert 2}
    through the leader's filter on one seeded batch."""
    from nnstreamer_tpu_torch.models.moe_transformer import ep_bundle
    from nnstreamer_tpu_torch.models.zoo import get_model
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.launch import rank_device

    bundle = get_model(cfg["moe_ep_spec"], device=rank_device())
    served = ep_bundle(bundle, make_mesh({"data": 2, "expert": 2}))
    x = _seq_input(bundle.metadata, 2, 12)

    def calls(filt):
        _invoke_host(filt, x)  # warm-up
        t0 = time.perf_counter()
        y = _invoke_host(filt, x)
        return {"y": y, "ms": (time.perf_counter() - t0) * 1e3}

    return _lead_or_follow(served, calls)


def moe_sp_ep(cfg: dict, mode: str) -> dict:
    """A rank of (c)'s sp x ep run: ``make_sp_ep_infer`` over {sp 2, expert
    2} in ``mode`` with the router metrics; the output (rank 0), metrics,
    ms and this rank's B5 launches."""
    import torch.distributed as dist

    from nnstreamer_tpu_torch.models.moe_transformer import make_sp_ep_infer
    from nnstreamer_tpu_torch.models.zoo import get_model
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.launch import rank_device

    dev = rank_device()
    bundle = get_model(cfg["moe_sp_spec"], device=dev)
    infer, placed = make_sp_ep_infer(bundle, make_mesh({"sp": 2, "expert": 2}),
                                     sp_mode=mode)
    x = torch.from_numpy(_seq_input(bundle.metadata, 1, 13)).to(dev)
    (y, metrics), ms, launches = _timed_forward(
        cfg, lambda t: infer(placed, t, metrics=True), x)
    return {"y": y if dist.get_rank() == 0 else None, "metrics": metrics, "ms": ms,
            "launches": launches}


def _direct_rate(spec: str, frames: list) -> dict:
    """The unsharded filter on the card over the same batches, one at a
    time with its output read back (after one warm-up batch): batches/s and
    the per-batch p50."""
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter

    filt = TorchCudaFilter()
    filt.open(FilterProps(model=spec, device=PAR_DEVICE))
    try:
        _invoke_host(filt, frames[0])
        times = []
        for x in frames:
            t0 = time.perf_counter()
            _invoke_host(filt, x)
            times.append(time.perf_counter() - t0)
    finally:
        filt.close()
    return {"batches_per_s": len(frames) / sum(times),
            "p50_ms": float(np.median(times)) * 1e3}


def _hop_rates(res: dict) -> dict:
    """A sync client's rates behind the hop: batches/s after the first
    batch (its round trips back to back), the round trip p50 of those, and
    the first batch's (the session's first invoke, with cuDNN's warm-up)."""
    rtt = res["rtt"]
    return {"batches_per_s": (len(rtt) - 1) / sum(rtt[1:]),
            "rtt_p50_ms": float(np.median(rtt[1:])) * 1e3, "first_ms": rtt[0] * 1e3}


def _labels_equal(got: list, want: list) -> bool:
    return all(np.array_equal(np.argmax(g, -1), np.argmax(w, -1))
               for g, w in zip(got, want))


def _clock_per_invoke(res: list) -> dict:
    """Each collective's ms an invoke, the slowest rank's, and the count."""
    r0 = res[0]
    return {op: {"calls_per_invoke": r0["clock"][op][0] / r0["invokes"],
                 "ms_per_invoke": max(r["clock"].get(op, [0, 0.0])[1] / r["invokes"]
                                      for r in res) * 1e3}
            for op in r0["clock"]}


def run_sharded(g, card: str) -> dict:
    """(a)-(c) on the 4-rank gloo group (the ranks sharing the card); returns
    each part's lines and the ranks' B5 launches by part."""
    from nnstreamer_tpu_torch.models.zoo import get_model
    from nnstreamer_tpu_torch.parallel.composite import (
        composite_query_retry_check, composite_sharded_query_check, uint8_frames)

    cfg = _shard_cfg()
    lines, launches = {}, {}
    t0 = time.perf_counter()
    oracle = get_model(SHARD_SPEC, device=PAR_DEVICE)
    frames = uint8_frames(SHARD_BATCH, SHARD_SIZE, SHARD_FRAMES, 3)
    direct = _direct_rate(SHARD_SPEC, frames)
    res = composite_sharded_query_check(g, SHARD_SPEC, oracle, SHARD_BATCH, SHARD_SIZE,
                                        SHARD_FRAMES, 3, *SHARD_TOL)
    if not _labels_equal(res["outputs"], res["oracle"]):
        raise AssertionError("sharded serving: labels differ from the unsharded bundle's")
    lines["a composite"] = {"batches": SHARD_FRAMES, **_hop_rates(res),
                            "max_abs_err": res["max_abs_err"], "direct_unsharded": direct,
                            "invokes": [r["invokes"] for r in res["ranks"]]}
    print(f"sharded (a) MobileNet-v2 {SHARD_SIZE} float32 batch {SHARD_BATCH} over data 2 "
          f"x model 2 ({g.world} {g.backend} ranks on {PAR_DEVICE}) behind tensor_query: "
          f"{json.dumps(lines['a composite'])}; every batch within rtol/atol "
          f"{SHARD_TOL} of the unsharded bundle on the card, labels equal [{card}]",
          flush=True)
    res = g.run(shard_uneven_reload, cfg)
    oracle7 = get_model(SHARD_SPEC + "&seed=7", device=PAR_DEVICE)
    x8 = _shard_frames(cfg, (SHARD_BATCH,), 6)[0]
    with torch.inference_mode():
        want = [b.apply(torch.from_numpy(x).to(PAR_DEVICE)).float().cpu().numpy()
                for b, x in [(oracle, x) for x in _shard_frames(cfg, SHARD_UNEVEN, 5)]
                + [(oracle7, x8)]]
    outs = res[0]["outs"]
    errs = [float(np.abs(o - w).max()) if o.shape == w.shape else float("inf")
            for o, w in zip(outs, want)]
    if not all(o.shape == w.shape and np.allclose(o, w, rtol=SHARD_TOL[0], atol=SHARD_TOL[1])
               for o, w in zip(outs, want)) or not _labels_equal(outs, want):
        raise AssertionError(f"sharded uneven batches / reload: max abs errs {errs}")
    lines["a uneven+reload"] = {"batches": list(SHARD_UNEVEN) + [SHARD_BATCH],
                                "max_abs_err": errs, "invokes": res[0]["invokes"],
                                "collectives": _clock_per_invoke(res)}
    print(f"sharded (a) uneven batches {SHARD_UNEVEN} (padded to the data axis, trimmed) "
          f"and a reload to seed 7, each == its unsharded bundle: "
          f"{json.dumps(lines['a uneven+reload'])} (collectives clocked, the card "
          f"synchronised around each) [{card}]", flush=True)
    res = composite_query_retry_check(g, SHARD_SPEC, oracle, SHARD_BATCH, SHARD_SIZE,
                                      SHARD_RETRY, 11, *SHARD_TOL)
    if not _labels_equal(res["outputs"], res["oracle"]):
        raise AssertionError("sharded failover: labels differ")
    lines["a failover"] = {"frames": SHARD_RETRY, "max_abs_err": res["max_abs_err"],
                           "sessions": len(res["ranks"]), "port": res["port"]}
    print(f"sharded (a) failover: the session stopped before frame 2, a new one on the "
          f"same ranks bound port {res['port']}, all {SHARD_RETRY} frames returned within "
          f"tolerance: {json.dumps(lines['a failover'])}", flush=True)
    del oracle, oracle7
    # (b) the stream transformer over sp 4
    st = get_model(ST_SPEC, device=PAR_DEVICE)
    x = torch.from_numpy(_seq_input(st.metadata, 1, 11)).to(PAR_DEVICE)
    with torch.inference_mode():
        single = st.apply(x).float().cpu().numpy()
    world, layers = g.world, st.metadata["layers"]
    for mode in SP_MODES:
        res = g.run(stream_sp, cfg, mode)
        n = sum(r["launches"] for r in res)
        want_n = 0 if PAR_DEVICE == "cpu" else {
            "ring": 0, "a2a": 0, "ring-flash": layers * world * world,
            "a2a-flash": layers * world}[mode]
        y = res[0]["y"]
        err = float(np.abs(y - single).max())
        if not np.allclose(y, single, rtol=ST_TOL[0], atol=ST_TOL[1]) or n != want_n:
            raise AssertionError(f"stream sp {mode}: max abs err {err}, B5 launches {n} "
                                 f"(want {want_n})")
        launches[f"sharded stream sp {mode}"] = {"flash_attention": n}
        lines[f"b sp {mode}"] = {"ms": max(r["ms"] for r in res), "max_abs_err": err,
                                 "flash_launches": n,
                                 "per_rank": [r["launches"] for r in res]}
        print(f"sharded (b) stream transformer seq {st.metadata['seq']} over sp {world} "
              f"{mode}: {json.dumps(lines[f'b sp {mode}'])}; within {ST_TOL} of the "
              f"single-card forward, B5 launches == {want_n} [{card}]", flush=True)
    del st
    # (c) the MoE transformer: ep_bundle, then sp x ep
    moe = get_model(MOE_EP_SPEC, device=PAR_DEVICE)
    x = _seq_input(moe.metadata, 2, 12)
    with torch.inference_mode():
        want = moe.apply(torch.from_numpy(x).to(PAR_DEVICE)).float().cpu().numpy()
    res = g.run(moe_ep_serve, cfg)
    err = float(np.abs(res[0]["y"] - want).max())
    if not np.allclose(res[0]["y"], want, rtol=MOE_TOL[0], atol=MOE_TOL[1]):
        raise AssertionError(f"moe ep_bundle: max abs err {err}")
    lines["c ep_bundle"] = {"ms": res[0]["ms"], "max_abs_err": err,
                            "follower_invokes": [r["invokes"] for r in res[1:]]}
    print(f"sharded (c) ep_bundle over data 2 x expert 2 through the filter (seq "
          f"{moe.metadata['seq']}, batch 2, {moe.metadata['experts']} experts): "
          f"{json.dumps(lines['c ep_bundle'])}; within {MOE_TOL} of the single-card "
          f"bundle [{card}]", flush=True)
    moe = get_model(MOE_SP_SPEC, device=PAR_DEVICE)
    x = torch.from_numpy(_seq_input(moe.metadata, 1, 13)).to(PAR_DEVICE)
    metrics = {}
    with torch.inference_mode():
        single = moe.module(x, metrics=metrics).float().cpu().numpy()
    counts = {k: v["expert_counts"].cpu().numpy() for k, v in metrics.items()}
    dropped = {k: float(v["dropped"]) for k, v in metrics.items()}
    layers = moe.metadata["layers"]
    for mode in MOE_SP_MODES:
        res = g.run(moe_sp_ep, cfg, mode)
        n = sum(r["launches"] for r in res)
        # each rank: sp (= 2) ring launches a layer, or one a2a launch
        want_n = 0 if PAR_DEVICE == "cpu" else (
            layers * 2 * world if mode == "ring-flash" else layers * world)
        r0 = res[0]
        err = float(np.abs(r0["y"] - single).max())
        same = all(np.array_equal(r["metrics"][k]["expert_counts"], counts[k])
                   and float(r["metrics"][k]["dropped"]) == dropped[k]
                   for r in res for k in counts)
        if not np.allclose(r0["y"], single, rtol=ST_TOL[0], atol=ST_TOL[1]) \
                or not same or n != want_n:
            raise AssertionError(f"moe sp x ep {mode}: max abs err {err}, counts/drops "
                                 f"equal {same}, B5 launches {n} (want {want_n})")
        launches[f"sharded moe sp x ep {mode}"] = {"flash_attention": n}
        lines[f"c sp x ep {mode}"] = {
            "ms": max(r["ms"] for r in res), "max_abs_err": err, "flash_launches": n,
            "expert_counts": {k: v.tolist() for k, v in counts.items()},
            "dropped": dropped}
        print(f"sharded (c) sp x ep over sp 2 x expert 2 {mode} (seq "
              f"{moe.metadata['seq']}): {json.dumps(lines[f'c sp x ep {mode}'])}; within "
              f"{ST_TOL} of the single-card forward, expert counts and drops equal, B5 "
              f"launches == {want_n} [{card}]", flush=True)
    del moe
    print(f"sharded phase on {world} ranks: {time.perf_counter() - t0:.3f} s", flush=True)
    return {"lines": lines, "launches": launches}


def run_sharded_nccl(g, card: str) -> dict:
    """(a) once more on the 1-rank NCCL group: the served bundle's protocol
    with an axis of 1 (no follower), against the unsharded bundle."""
    from nnstreamer_tpu_torch.models.zoo import get_model
    from nnstreamer_tpu_torch.parallel.composite import composite_sharded_query_check

    oracle = get_model(SHARD_SPEC, device=PAR_DEVICE)
    res = composite_sharded_query_check(g, SHARD_SPEC, oracle, SHARD_BATCH, SHARD_SIZE,
                                        SHARD_NCCL, 3, *SHARD_TOL)
    if not _labels_equal(res["outputs"], res["oracle"]):
        raise AssertionError("sharded serving (NCCL): labels differ")
    line = {"batches": SHARD_NCCL, **_hop_rates(res), "max_abs_err": res["max_abs_err"],
            "backend": g.backend}
    print(f"sharded (a) on the 1-rank {g.backend} group behind tensor_query: "
          f"{json.dumps(line)} [{card}]", flush=True)
    return line


def _label_pipeline(spec: str, frames: list, caps, labels: str, eager: bool,
                    custom: str = "", device: str = None) -> tuple:
    """``appsrc ! tensor_converter ! tensor_filter model=spec custom=custom !
    tensor_decoder image_labeling ! tensor_sink`` in graphs or eager mode on
    ``device`` (FAMILY_DEVICE unless given): (sink, the decoder's inputs,
    wall, steady rate, graph stats)."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.graph import Pipeline

    p = Pipeline("cls", device=device or FAMILY_DEVICE)
    src = p.add_new("appsrc", caps=caps, data=frames)
    conv = p.add_new("tensor_converter")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=spec,
                     custom=custom)
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
    if sink.num_buffers != len(frames):
        raise AssertionError(f"{spec}: {sink.num_buffers} of {len(frames)} labels out")
    return sink, seen, wall, _steady_fps(arrivals), st


def _check_labels(spec: str, frames: list, runs: dict, name: str) -> list:
    """Each graphs-mode label equal to the model's own argmax on its frame,
    and the replayed logits and labels equal to the eager run's."""
    from nnstreamer_tpu_torch.models.zoo import get_model

    sink, seen = runs[False][0], runs[False][1]
    bundle = get_model(spec, device=FAMILY_DEVICE)
    for frame, buf in zip(frames, sink.buffers):
        with torch.inference_mode():
            logits = bundle.fn()(torch.from_numpy(frame[None]).to(FAMILY_DEVICE))
        want = int(logits.argmax(dim=-1)[0])
        if buf.meta["label_index"] != want:
            raise AssertionError(f"{name}: label {buf.meta['label_index']} != argmax {want}")
    if not _all_identical(_memories(seen), _memories(runs[True][1])) \
            or [b.meta["label_index"] for b in sink.buffers] \
            != [b.meta["label_index"] for b in runs[True][0].buffers]:
        raise AssertionError(f"{name}: replayed logits or labels differ from the eager ones")
    return [b.meta["label"] for b in sink.buffers]


def run_convnets(tmp: str) -> None:
    """(d): LeNet-5 on a GRAY8 28x28 stream and MobileNet-v1 224 through
    image_labeling, each checked as run_classification checks MobileNet-v2."""
    from nnstreamer_tpu_torch.core.types import Caps

    rng = np.random.default_rng(17)
    cases = [
        ("lenet (zoo://mnist's model) 28x28 GRAY8", LENET_SPEC, 10,
         Caps("video/x-raw", {"format": "GRAY8", "width": 28, "height": 28,
                              "framerate": Fraction(30)}),
         [rng.integers(0, 256, (28, 28, 1), dtype=np.uint8) for _ in range(LENET_FRAMES)]),
        (f"mobilenet_v1 {V1_SIZE}", V1_SPEC, 1001,
         Caps("video/x-raw", {"format": "RGB", "width": V1_SIZE, "height": V1_SIZE,
                              "framerate": Fraction(30)}),
         [rng.integers(0, 256, (V1_SIZE, V1_SIZE, 3), dtype=np.uint8)
          for _ in range(V1_FRAMES)])]
    for name, spec, n_labels, caps, frames in cases:
        labels = os.path.join(tmp, f"labels{n_labels}.txt")
        with open(labels, "w") as f:
            f.write("\n".join(f"l{i}" for i in range(n_labels)))
        runs = {eager: _label_pipeline(spec, frames, caps, labels, eager)
                for eager in (False, True)}
        got = _check_labels(spec, frames, runs, name)
        if FAMILY_DEVICE != "cpu":  # the CPU captures nothing
            _record_graphs(name.split()[0], 1, "fps", runs[False][3], runs[True][3],
                           runs[False][4])
        print(f"{name} image_labeling: {len(frames)} frames in {runs[False][2]:.3f} s "
              f"(incl. model build), labels {got}; each == the model's argmax, "
              f"replayed logits == the eager ones", flush=True)


def run_stream_pipeline() -> None:
    """(b)'s pipeline on one card: per-frame embeddings -> tensor_aggregator
    (windows of seq frames) -> tensor_filter zoo://stream_transformer (zoo
    defaults: layers 2, dim 128, heads 8, seq 256, bf16) -> tensor_sink, in
    graphs and eager mode: replayed windows == eager ones, each within
    ST_PIPE_TOL of the float32 model with the same seeded weights."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.models.zoo import get_model

    ref = get_model(ST_PIPE_SPEC + "?dtype=float32", device=FAMILY_DEVICE)
    seq, dim = ref.metadata["seq"], ref.metadata["dim"]
    rng = np.random.default_rng(19)
    frames = [rng.standard_normal((1, 1, dim), dtype=np.float32)
              for _ in range(seq * ST_PIPE_WINDOWS)]
    caps = Caps.tensors(TensorsConfig(TensorsInfo.from_strings(f"{dim}:1:1", "float32"), 30))
    runs = {}
    for eager in (False, True):
        p = Pipeline("stream-transformer", device=FAMILY_DEVICE)
        src = p.add_new("appsrc", caps=caps, data=list(frames))
        agg = p.add_new("tensor_aggregator", frames_out=seq, frames_dim=1)
        filt = p.add_new("tensor_filter", framework="xla-tpu", model=ST_PIPE_SPEC)
        arrivals = []
        sink = p.add_new("tensor_sink", store=True,
                         new_data=lambda b, a=arrivals: a.append(time.perf_counter()))
        Pipeline.link(src, agg, filt, sink)
        with _mode(eager):
            p.run(timeout=600)
            st = graphs.stats()
        if sink.num_buffers != ST_PIPE_WINDOWS:
            raise AssertionError(f"stream pipeline: {sink.num_buffers} of "
                                 f"{ST_PIPE_WINDOWS} windows")
        runs[eager] = ([b.memories[0].host() for b in sink.buffers],
                       _steady_fps(arrivals), st)
    if not all(np.array_equal(a, b) for a, b in zip(runs[False][0], runs[True][0])):
        raise AssertionError("stream pipeline: replayed windows differ from the eager ones")
    errs = []
    for k, out in enumerate(runs[False][0]):
        window = np.concatenate(frames[k * seq:(k + 1) * seq], axis=1)
        with torch.inference_mode():
            want = ref.apply(torch.from_numpy(window).to(FAMILY_DEVICE)).cpu().numpy()
        errs.append(float(np.abs(out - want).max()))
        if out.shape != (1, seq, dim) or not np.allclose(out, want, rtol=ST_PIPE_TOL[0],
                                                         atol=ST_PIPE_TOL[1]):
            raise AssertionError(f"stream pipeline window {k}: max abs err {errs[-1]}")
    if FAMILY_DEVICE != "cpu":
        _record_graphs("stream transformer", 1, "windows/s", runs[False][1],
                       runs[True][1], runs[False][2])
    print(f"stream transformer (zoo defaults: seq {seq}, dim {dim}, bf16) behind "
          f"tensor_aggregator: {ST_PIPE_WINDOWS} windows, replayed == eager, max abs err "
          f"against the float32 model {max(errs):.4e} (within {ST_PIPE_TOL})", flush=True)


#: the model-files phase: checkpoints, quant=w8, exported programs and the
#: torch filter (``run_model_files``; a rehearsal on the CPU sets "cpu")
MF_DEVICE = "cuda"
MF_SSD_FRAMES = 32
MF_V1_FRAMES = 16
MF_SSD_ARCH = "arch=zoo://ssd_mobilenet_v2"
#: (e): the orbax directory the JAX package wrote (scripts/make_orbax_fixture.py)
#: and its .msgpack twin, served as LeNet over MF_LENET_FRAMES GRAY8 frames
MF_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data")
MF_LENET_FRAMES = 16
#: an exported program against the zoo bundle it was exported from, both on
#: the card: float32 LeNet; MobileNet-v2's bf16 logits within 1e-2 of scale
MF_EXPORT_TOL = {"lenet": (1e-5, 1e-6), "mobilenet_v2": (1e-2, 0.0)}
#: the scripted LeNet through the torch filter against its eager module
MF_SCRIPT_TOL = (1e-5, 1e-6)
#: the scripted LeNet of (d): uint8 (b, 28, 28, 1) -> (b, 10) float32 logits
MF_SCRIPT_SEED = 23


class ScriptLeNet(torch.nn.Module):
    """(d)'s TorchScript model: the frame as the pipeline hands it (uint8
    NHWC) to float32 logits."""

    def __init__(self) -> None:
        super().__init__()
        torch.manual_seed(MF_SCRIPT_SEED)
        self.conv = torch.nn.Conv2d(1, 4, 3, 1)
        self.fc = torch.nn.Linear(4 * 13 * 13, 10)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2) / 255.0
        x = F.max_pool2d(torch.relu(self.conv(x)), 2)
        return self.fc(x.reshape(x.size(0), -1))


def _mf_ssd(tmp: str, counters) -> dict:
    """(a) SSD-300 at full width restored from a .msgpack through the
    README's detection pipeline (``model=<ckpt> custom="arch=..."``), with
    graphs and eagerly: detections bit-equal to the same weights loaded
    in-process (``convert.load_flax``), and not the seed-0 bundle's."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.models.convert import load_flax, to_flax_variables
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors
    from nnstreamer_tpu_torch.models.zoo import get_model
    from nnstreamer_tpu_torch.utils.checkpoints import load_variables, save_variables

    priors = os.path.join(tmp, "box_priors.txt")
    write_box_priors(priors, size=300)
    labels = os.path.join(tmp, "coco.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"c{i}" for i in range(91)))
    ckpt = os.path.join(tmp, "ssd300_seed1.msgpack")
    ckpt_dir = os.path.join(tmp, "ssd300_seed1")
    seeded = get_model(SSD_SPEC + "&seed=1", device=MF_DEVICE, fresh=True)
    tree = to_flax_variables(seeded.module)
    save_variables(ckpt, tree)
    t0 = time.perf_counter()
    save_variables(ckpt_dir, tree)
    dir_save_s = time.perf_counter() - t0
    del seeded, tree
    loaded = load_flax(get_model(SSD_SPEC, device=MF_DEVICE, fresh=True),
                       load_variables(ckpt))

    def run(model, custom: str, eager: bool) -> tuple:
        p = Pipeline("ssd-restored", device=MF_DEVICE)
        src = p.add_new("videotestsrc", width=300, height=300, pattern="random",
                        num_buffers=MF_SSD_FRAMES)
        conv = p.add_new("tensor_converter")
        filt = p.add_new("tensor_filter", framework="xla-tpu", model=model,
                         custom=custom)
        dec = p.add_new("tensor_decoder", mode="bounding_box", option1="mobilenet-ssd",
                        option2=labels, option3=priors, option4="300:300",
                        option5="300:300")
        arrivals = []
        sink = p.add_new("tensor_sink", store=True,
                         new_data=lambda b, a=arrivals: a.append(time.perf_counter()))
        Pipeline.link(src, conv, filt, dec, sink)
        with _mode(eager):
            p.run(timeout=600)
            st = graphs.stats()
        if sink.num_buffers != MF_SSD_FRAMES:
            raise AssertionError(f"restored ssd: {sink.num_buffers} of "
                                 f"{MF_SSD_FRAMES} frames")
        dets = [b.meta["detections"] for b in sink.buffers]
        return dets, _steady_fps(arrivals), st

    counters.reset()
    runs = {eager: run(ckpt, MF_SSD_ARCH, eager) for eager in (False, True)}
    launches = counters.read()
    want = {eager: run(loaded, "", eager)[0] for eager in (False, True)}
    seed0 = run(SSD_SPEC, "", False)[0]
    if MF_DEVICE != "cpu":
        for name in ("class_reduce", "nms_sweep"):
            if launches.get(name) != 2 * MF_SSD_FRAMES:
                raise AssertionError(f"restored ssd: {name} launched "
                                     f"{launches.get(name)} times for 2 x {MF_SSD_FRAMES}")
    for eager in (False, True):
        if runs[eager][0] != want[False] or want[eager] != want[False]:
            raise AssertionError(f"restored ssd ({'eager' if eager else 'graphs'}): "
                                 "detections differ from the in-process restore")
    if runs[False][0] == seed0:
        raise AssertionError("restored ssd: detections equal the seed-0 bundle's")
    n = sum(len(d) for d in runs[False][0])
    if n == 0:
        raise AssertionError("restored ssd: no detections")
    del loaded
    print(f"model files (a) SSD-300 restored from {os.path.basename(ckpt)} "
          f"(custom=\"{MF_SSD_ARCH}\"): {MF_SSD_FRAMES} frames, {n} detections, "
          f"graphs and eager == the in-process load_flax restore, != seed 0; steady "
          f"fps {runs[False][1]:.2f} (eager {runs[True][1]:.2f}); launches {launches}",
          flush=True)
    if MF_DEVICE != "cpu":
        _record_graphs("restored ssd", 1, "fps", runs[False][1], runs[True][1],
                       runs[False][2])
    _mf_ssd_orbax(ckpt, ckpt_dir, dir_save_s, runs, run, counters)
    return launches


def _mf_where() -> str:
    return _card() if MF_DEVICE != "cpu" else "on the CPU"


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path)
               for f in fs)


def _mf_ssd_orbax(ckpt: str, ckpt_dir: str, save_s: float, runs: dict, run,
                  counters) -> None:
    """(a') the same seed-1 tree, written by the port as an orbax directory
    (utils/orbax_dir.py: OCDBT store, zarr chunks, zstd through
    libzstd.so.1), served through ``model=<dir>`` with graphs and eagerly:
    ``class_reduce`` and ``nms_sweep`` launched once a frame, detections
    bit-equal to the ``.msgpack`` restore's in both modes; the directory's
    leaves bit-equal to the file's. Prints the directory's bytes, the save
    and load seconds and zstd's decompression rate over its chunks."""
    from nnstreamer_tpu_torch.utils import ocdbt, zstd
    from nnstreamer_tpu_torch.utils.checkpoints import load_variables

    t0 = time.perf_counter()
    got = load_variables(ckpt_dir)
    load_s = time.perf_counter() - t0
    want = load_variables(ckpt)
    got_items, want_items = _tree_items(got), _tree_items(want)
    if [p for p, _ in got_items] != [p for p, _ in want_items] or any(
            a.dtype != b.dtype or a.tobytes() != b.tobytes()
            for (_, a), (_, b) in zip(got_items, want_items)):
        raise AssertionError("orbax ssd: the directory's leaves differ from the .msgpack's")
    reader = ocdbt.Reader(ckpt_dir)
    chunks = [reader.read(k) for k in reader.list() if not k.endswith(b".zarray")]
    t0 = time.perf_counter()
    raw = sum(len(zstd.decompress(c)) for c in chunks)
    zstd_s = time.perf_counter() - t0
    counters.reset()
    dirs = {eager: run(ckpt_dir, MF_SSD_ARCH, eager) for eager in (False, True)}
    launches = counters.read()
    if MF_DEVICE != "cpu":
        for name in ("class_reduce", "nms_sweep"):
            if launches.get(name) != 2 * MF_SSD_FRAMES:
                raise AssertionError(f"orbax ssd: {name} launched {launches.get(name)} "
                                     f"times for 2 x {MF_SSD_FRAMES}")
    for eager in (False, True):
        if dirs[eager][0] != runs[eager][0]:
            raise AssertionError(f"orbax ssd ({'eager' if eager else 'graphs'}): "
                                 "detections differ from the .msgpack restore's")
    print(f"model files (a') SSD-300 restored from an orbax directory the port wrote "
          f"({_dir_bytes(ckpt_dir)} bytes in {len(os.listdir(ckpt_dir))} entries, "
          f"{len(chunks)} zstd chunks; .msgpack {os.path.getsize(ckpt)} bytes): save "
          f"{save_s:.3f} s, load {load_s:.3f} s, zstd decompression {raw / zstd_s / 1e6:.1f} "
          f"MB/s ({raw} bytes); leaves == the .msgpack's; {MF_SSD_FRAMES} frames graphs "
          f"and eager == the .msgpack restore's detections; launches {launches}; steady fps "
          f"{dirs[False][1]:.2f} (eager {dirs[True][1]:.2f}); {_mf_where()}", flush=True)


def _mf_orbax_fixture(tmp: str) -> None:
    """(e) the committed orbax directory the JAX package wrote with orbax
    0.11.32 (tests/data/orbax_lenet_seed1: jax.Array leaves, a per-process
    store under the root manifest) read on this machine, which has no JAX
    orbax: leaves bit-equal to lenet_seed1.msgpack; LeNet served from each
    through ``model=<path> custom="arch=zoo://lenet"`` and image_labeling
    over MF_LENET_FRAMES GRAY8 frames on the card: labels and logits
    equal."""
    from nnstreamer_tpu_torch.core.types import Caps
    from nnstreamer_tpu_torch.utils.checkpoints import load_variables

    directory = os.path.join(MF_FIXTURE, "orbax_lenet_seed1")
    msgpack = os.path.join(MF_FIXTURE, "lenet_seed1.msgpack")
    t0 = time.perf_counter()
    got = load_variables(directory)
    load_s = time.perf_counter() - t0
    got_items, want_items = _tree_items(got), _tree_items(load_variables(msgpack))
    if [p for p, _ in got_items] != [p for p, _ in want_items] or any(
            a.dtype != b.dtype or a.tobytes() != b.tobytes()
            for (_, a), (_, b) in zip(got_items, want_items)):
        raise AssertionError("orbax fixture: leaves differ from lenet_seed1.msgpack's")
    rng = np.random.default_rng(29)
    frames = [rng.integers(0, 256, (28, 28, 1), dtype=np.uint8)
              for _ in range(MF_LENET_FRAMES)]
    caps = Caps("video/x-raw", {"format": "GRAY8", "width": 28, "height": 28,
                                "framerate": Fraction(30)})
    labels = os.path.join(tmp, "labels10.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"l{i}" for i in range(10)))
    out = {}
    for path in (directory, msgpack):
        sink, seen = _label_pipeline(path, frames, caps, labels, False,
                                     custom="arch=zoo://lenet", device=MF_DEVICE)[:2]
        out[path] = ([b.meta["label_index"] for b in sink.buffers],
                     [b.memories[0].host() for b in seen])
    (dl, dx), (ml, mx) = out[directory], out[msgpack]
    if dl != ml or len(dx) != len(mx) or any(a.tobytes() != b.tobytes()
                                             for a, b in zip(dx, mx)):
        raise AssertionError("orbax fixture: LeNet from the directory serves other "
                             "labels or logits than from the .msgpack")
    print(f"model files (e) the JAX package's orbax directory ({_dir_bytes(directory)} "
          f"bytes, orbax 0.11.32) read here in {load_s:.3f} s: {len(got_items)} leaves "
          f"== lenet_seed1.msgpack's; LeNet served from it over {MF_LENET_FRAMES} "
          f"frames: labels {dl} and logits == the .msgpack's", flush=True)


def _mf_quant_v1(tmp: str) -> None:
    """(b) MobileNet-v1 1.0/224/1001 behind custom="quant=w8" through
    image_labeling, captured and eager: codes and scales bit-equal to those
    computed on the CPU from the same tree, labels equal between the modes
    and to the quantized logits' argmax."""
    from nnstreamer_tpu_torch.core.types import Caps
    from nnstreamer_tpu_torch.models.quantize import quantize_bundle
    from nnstreamer_tpu_torch.models.zoo import get_model

    labels = os.path.join(tmp, "labels1001.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"l{i}" for i in range(1001)))
    rng = np.random.default_rng(29)
    frames = [rng.integers(0, 256, (V1_SIZE, V1_SIZE, 3), dtype=np.uint8)
              for _ in range(MF_V1_FRAMES)]
    caps = Caps("video/x-raw", {"format": "RGB", "width": V1_SIZE, "height": V1_SIZE,
                                "framerate": Fraction(30)})
    runs = {eager: _label_pipeline(V1_SPEC, frames, caps, labels, eager,
                                   custom="quant=w8", device=MF_DEVICE)
            for eager in (False, True)}
    card = get_model(V1_SPEC, device=MF_DEVICE).metadata["_w8_bundle"]
    cpu = quantize_bundle(get_model(V1_SPEC, device="cpu", fresh=True))
    leaves = _tree_items(cpu.params)
    for (path, got), (want_path, leaf) in zip(_tree_items(card.params), leaves):
        if path != want_path or not _identical(got.detach().cpu(), leaf.detach()):
            raise AssertionError(f"quant=w8 on the card: {path} differs from the CPU's")
    sink = runs[False][0]
    got = [b.meta["label_index"] for b in sink.buffers]
    if got != [b.meta["label_index"] for b in runs[True][0].buffers]:
        raise AssertionError("quant=w8 mobilenet_v1: labels differ between graphs and eager")
    with torch.inference_mode():
        want = [int(card.fn()(torch.from_numpy(x[None]).to(MF_DEVICE)).argmax(-1)[0])
                for x in frames]
    if got != want:
        raise AssertionError(f"quant=w8 mobilenet_v1: labels {got} != argmax {want}")
    md = card.metadata
    print(f"model files (b) mobilenet_v1 {V1_SIZE} 1001 classes quant=w8: "
          f"{MF_V1_FRAMES} frames, labels == argmax, graphs == eager, {len(leaves)} leaves of "
          f"codes/scales == the CPU's bit for bit; params_nbytes {md['params_nbytes']} "
          f"of {md['params_nbytes_f32']} unquantized; steady fps {runs[False][3]:.2f} "
          f"(eager {runs[True][3]:.2f})", flush=True)
    if MF_DEVICE != "cpu":
        _record_graphs("mobilenet_v1 quant=w8", 1, "fps", runs[False][3],
                       runs[True][3], runs[False][4])


#: (c)'s models: name -> (zoo spec, frame shape, video format)
MF_EXPORTS = {"lenet": (LENET_SPEC, (28, 28, 1), "GRAY8"),
              "mobilenet_v2": (CLS_SPEC, (224, 224, 3), "RGB")}


def _mf_export_start(tmp: str) -> tuple:
    """Start (c)'s export: a process on the CPU alone (no card visible, two
    threads) writes each model of MF_EXPORTS with export_model; it runs
    while (a) and (b) do. Returns (process, paths, start time)."""
    paths = {name: os.path.join(tmp, f"{name}.jaxexport") for name in MF_EXPORTS}
    code = ("from nnstreamer_tpu_torch.models import export_model, get_model\n"
            + "".join(f"export_model({paths[n]!r}, get_model({s!r}, device='cpu'))\n"
                      for n, (s, _, _) in MF_EXPORTS.items()))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, paths, time.perf_counter()


def _mf_exported(export: tuple) -> None:
    """(c) LeNet and MobileNet-v2 at full width, exported by export_model in
    a CPU process, served from model=<x>.jaxexport on the card through the
    filter's CUDA graph: outputs against the zoo bundle on the card."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.core.types import Caps
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.models.zoo import get_model

    proc, paths, t0 = export
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"export in a CPU process failed: {err[-2000:]}")
    export_s = time.perf_counter() - t0
    cases = MF_EXPORTS
    rng = np.random.default_rng(31)
    for name, (spec, shape, fmt) in cases.items():
        frames = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(8)]
        caps = Caps("video/x-raw", {"format": fmt, "width": shape[1],
                                    "height": shape[0], "framerate": Fraction(30)})
        p = Pipeline("exported", device=MF_DEVICE)
        src = p.add_new("appsrc", caps=caps, data=list(frames))
        conv = p.add_new("tensor_converter")
        filt = p.add_new("tensor_filter", model=paths[name])  # framework=auto
        sink = p.add_new("tensor_sink", store=True)
        Pipeline.link(src, conv, filt, sink)
        with _mode(False):
            p.run(timeout=600)
            st = graphs.stats()
        if filt.resolved_framework != "xla-tpu" or sink.num_buffers != len(frames):
            raise AssertionError(f"exported {name}: {filt.resolved_framework}, "
                                 f"{sink.num_buffers} frames")
        if MF_DEVICE != "cpu" and (st["captures"] < 1 or st["replays"] < 1):
            raise AssertionError(f"exported {name}: not served through a CUDA graph {st}")
        zoo = get_model(spec, device=MF_DEVICE)
        rtol, atol = MF_EXPORT_TOL[name]
        err, exact = 0.0, True
        for x, b in zip(frames, sink.buffers):
            out = b.memories[0].device()
            if out.device.type != torch.device(MF_DEVICE).type:
                raise AssertionError(f"exported {name}: output on {out.device}")
            with torch.inference_mode():
                want = zoo.fn()(torch.from_numpy(x[None]).to(MF_DEVICE))
            exact = exact and _identical(out, want)
            err = max(err, _max_abs_err(out, want))
            scale = float(want.abs().max())
            if not torch.allclose(out, want, rtol=rtol, atol=max(atol, rtol * scale)):
                raise AssertionError(f"exported {name}: max abs err {err} (scale {scale})")
        print(f"model files (c) {name} exported in a CPU process (done {export_s:.1f} s "
              f"after its start, beside (a) and (b)) and served from .jaxexport on the card: {len(frames)} frames, "
              f"captures {st['captures']} replays {st['replays']}, max abs err "
              f"against the zoo bundle {err:.3e} (bit-equal: {exact})", flush=True)


def _mf_torch_filter(tmp: str) -> None:
    """(d) framework=torch / pytorch through nns-launch (the reference's
    pytorch string): a TorchScript LeNet scripted here and the hand-built
    legacy zip, each against its module run eagerly on the card."""
    from PIL import Image

    from nnstreamer_tpu_torch.cli import main as cli
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    png = os.path.join(tmp, "digit.png")
    Image.fromarray(np.random.default_rng(37).integers(0, 256, (28, 28), dtype=np.uint8),
                    "L").save(png)
    script = ScriptLeNet().eval()
    scripted = os.path.join(tmp, "lenet_script.pt")
    torch.jit.script(script).save(scripted)
    legacy = os.path.join(tmp, "lenet_legacy.pt")
    legacy_net = write_legacy_lenet(legacy, seed=0)
    dev = torch.device(MF_DEVICE)
    cases = [("torch", scripted, script, "10:1", "float32", np.float32, MF_SCRIPT_TOL),
             ("pytorch", legacy, legacy_net, "10:1:1:1", "uint8", np.uint8, (0.0, 0.0))]
    for fw, model, net, odims, otype, np_type, (rtol, atol) in cases:
        out = os.path.join(tmp, f"{fw}.out.log")
        launch = (f"filesrc location={png} ! pngdec ! videoscale ! imagefreeze ! "
                  "videoconvert ! video/x-raw,format=GRAY8,framerate=0/1 ! "
                  f"tensor_converter ! tensor_filter framework={fw} model={model} "
                  f"input=1:28:28:1 inputtype=uint8 output={odims} outputtype={otype} ! "
                  f"filesink location={out}")
        with _decoder_inputs(TensorFilter) as into:
            rc = cli(["--device", MF_DEVICE, launch])
        if rc != 0 or len(into) != 1:
            raise AssertionError(f"nns-launch framework={fw}: exit {rc}, "
                                 f"{len(into)} frames: {launch}")
        got = torch.from_numpy(np.fromfile(out, np_type)).reshape(1, 10)
        x = into[0].memories[0].device(dev)
        with torch.no_grad():
            want = net.to(dev)(x).cpu()
        err = _max_abs_err(got.float(), want.float())
        if (rtol, atol) == (0.0, 0.0):
            ok = torch.equal(got, want)
        else:
            ok = torch.allclose(got, want, rtol=rtol, atol=atol)
        if not ok:
            raise AssertionError(f"framework={fw}: {got} != eager {want}")
        print(f"model files (d) nns-launch framework={fw} on {os.path.basename(model)}: "
              f"output == the module run eagerly on the card (max abs err {err:.3e})",
              flush=True)


def run_model_files(counters) -> dict:
    """The model-files phase: (a) a restored SSD-300 and (a') the same from
    an orbax directory, (b) MobileNet-v1 quant=w8, (c) exported programs,
    (d) the torch filter, (e) the JAX package's orbax fixture. Returns (a)'s
    kernel launches."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        export = _mf_export_start(tmp)
        try:
            launches = _mf_ssd(tmp, counters)
            _release()
            _mf_quant_v1(tmp)
        finally:
            _mf_exported(export)
        _mf_torch_filter(tmp)
        _mf_orbax_fixture(tmp)
    _release()
    print(f"model files phase: {time.perf_counter() - t0:.3f} s; {_mf_where()}",
          flush=True)
    return launches


#: the TFLite phase (``run_tflite``): (a) ssd_mobilenet_v2_coco as a float32
#: .tflite through framework=tensorflow2-lite, (b) MobileNet-v2 224 uint8 as
#: the reference's quant file through tensorflow-lite, (c) framework=
#: tensorflow; a rehearsal on the CPU sets "cpu" and smaller sizes
TFL_DEVICE = "cuda"
TFL_SSD = {"size": 300, "width": 1.0}
TFL_CLS = {"size": 224, "width": 1.0}
TFL_FRAMES = 32
#: frames also run through the same file loaded on the CPU
TFL_CPU_FRAMES = 4
#: the card's post-process boxes and scores against the CPU's (rtol, atol);
#: counts and classes equal
TFL_SSD_TOL = (1e-4, 1e-5)


def _tfl_frames(size: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            for _ in range(TFL_FRAMES)]


def _tfl_pipeline(model: str, framework: str, frames: list, tail: dict,
                  eager: bool, transform: str = "") -> tuple:
    """``appsrc ! tensor_converter ! [tensor_transform !] tensor_filter
    framework=... model=... ! tensor_decoder ... ! tensor_sink`` on
    TFL_DEVICE in graphs or eager mode: (sink, the decoder's inputs, steady
    rate, graph stats)."""
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.core.types import Caps
    from nnstreamer_tpu_torch.graph import Pipeline

    size = frames[0].shape[0]
    p = Pipeline("tflite", device=TFL_DEVICE)
    caps = Caps("video/x-raw", {"format": "RGB", "width": size, "height": size,
                                "framerate": Fraction(30)})
    chain = [p.add_new("appsrc", caps=caps, data=list(frames)),
             p.add_new("tensor_converter")]
    if transform:
        chain.append(p.add_new("tensor_transform", mode="arithmetic",
                               option=transform))
    chain.append(p.add_new("tensor_filter", framework=framework, model=model))
    chain.append(p.add_new("tensor_decoder", **tail))
    arrivals = []
    chain.append(p.add_new("tensor_sink", store=True,
                           new_data=lambda b, a=arrivals: a.append(time.perf_counter())))
    Pipeline.link(*chain)
    with _decoder_inputs() as seen, _mode(eager):
        p.run(timeout=600)
        st = graphs.stats()
    if chain[-1].num_buffers != len(frames):
        raise AssertionError(f"tflite {framework}: {chain[-1].num_buffers} of "
                             f"{len(frames)} frames")
    return chain[-1], seen, _steady_fps(arrivals), st


def _tfl_load(path: str, device) -> tuple:
    from nnstreamer_tpu_torch.models.tflite_import import load_tflite

    t0 = time.perf_counter()
    bundle = load_tflite(path, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return bundle, time.perf_counter() - t0


@contextlib.contextmanager
def _recording(ep, names) -> list:
    """Record the arguments of each call of the ``ep`` kernel wrappers
    ``names`` while inside."""
    calls, saved = [], {n: getattr(ep, n) for n in names}

    def wrap(name, fn):
        def recorded(*args, **kwargs):
            calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        recorded.launches = 0  # the wrapper counts these launches, not fn
        return recorded

    for n, fn in saved.items():
        setattr(ep, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ep, n, fn)


def _tfl_inside_the_op(ep, card, frame: np.ndarray) -> dict:
    """One eager call of the card bundle with the kernels' arguments
    recorded: B2 and B3 at their shapes inside the post-process, each equal
    to its plain version on the same inputs; B3 at K 1917 timed."""
    from nnstreamer_tpu_torch.core import graphs

    x = torch.from_numpy(frame).to(TFL_DEVICE)
    with graphs.disabled(), torch.inference_mode(), \
            _recording(ep, ("class_reduce", "nms_sweep")) as calls:
        card.fn()(x)
    if TFL_DEVICE == "cpu":
        return {}
    shapes = [(n, tuple(a[0].shape)) for n, a, _ in calls]
    if [n for n, _ in shapes] != ["class_reduce", "nms_sweep"]:
        raise AssertionError(f"tflite ssd: kernels inside the op {shapes}")
    (_, (cls,), _), (_, cols, kw) = calls
    best, idx = ep.class_reduce(cls)
    pbest, pidx = ep.class_reduce_plain(cls)
    swept = ep.nms_sweep(*cols, **kw)
    plain = ep.nms_sweep_plain(*cols, **kw)
    torch.cuda.synchronize()
    if not (_identical(best, pbest) and torch.equal(idx, pidx)):
        raise AssertionError("tflite ssd: class_reduce differs from plain inside the op")
    if not torch.equal(swept, plain):
        raise AssertionError("tflite ssd: nms_sweep differs from plain inside the op")
    k = int(cols[0].shape[0])
    ms = _device_ms(lambda: ep.nms_sweep(*cols, **kw), 5, 5)
    floor_ms = _launch_floor_ms(cols[0].device)
    plain_ms = _device_ms(lambda: ep.nms_sweep_plain(*cols, **kw), 1, 2)
    bound, by = _bound_ms(6 * k * 4, NMS_OPS_PER_PAIR * k * (k - 1) / 2)
    alive = int((swept > 0).sum())
    print(f"tflite ssd: inside TFLite_Detection_PostProcess class_reduce {tuple(cls.shape)} "
          f"and nms_sweep K={k} (global scratch past {ep.NMS_SMEM_MAX_K}; {alive} "
          f"kept) == their plain versions; nms_sweep K={k} device ms/call (CUDA "
          f"graph): kernel={ms:.6f} plain={plain_ms:.6f} library=none; "
          f"bound_ms={bound:.8f} ({by}), launch floor {floor_ms:.6f}; phases "
          f"{_nms_split_text(k)}; {_card()}", flush=True)
    return {"k": k, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound}


def _tfl_ssd(tmp: str, counters) -> dict:
    """(a) ssd_mobilenet_v2_coco written as a float32 .tflite, served through
    ``tensor_filter framework=tensorflow2-lite ! tensor_decoder
    mode=bounding_box option1=mobilenet-ssd-postprocess`` with graphs and
    eagerly: decoder inputs and detections bit-equal, B2 once and B3 twice a
    frame (the post-process's K 1917 sweep and the decoder's K 10); the
    post-process on the card against the same file on the CPU."""
    from nnstreamer_tpu_torch.ops.kernels import epilogue as ep

    path = os.path.join(tmp, "ssd_mobilenet_v2_coco.tflite")
    t0 = time.perf_counter()
    meta = write_ssd_mobilenet_v2_tflite(path, **TFL_SSD)
    write_s = time.perf_counter() - t0
    card, load_s = _tfl_load(path, TFL_DEVICE)
    labels = os.path.join(tmp, "coco90.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"c{i}" for i in range(90)))
    size = TFL_SSD["size"]
    frames = _tfl_frames(size, 41)
    tail = dict(mode="bounding_box", option1="mobilenet-ssd-postprocess",
                option2=labels, option4=f"{size}:{size}", option5=f"{size}:{size}")
    runs, launches = {}, {}
    for eager in (False, True):
        counters.reset()
        runs[eager] = _tfl_pipeline(path, "tensorflow2-lite", frames, tail, eager,
                                    "typecast:float32,add:-127.5,div:127.5")
        for name, n in counters.read().items():
            launches[name] = launches.get(name, 0) + n
        if TFL_DEVICE != "cpu":
            got = counters.read()
            if got["class_reduce"] != TFL_FRAMES or got["nms_sweep"] != 2 * TFL_FRAMES:
                raise AssertionError(f"tflite ssd ({'eager' if eager else 'graphs'}): "
                                     f"launches {got} for {TFL_FRAMES} frames")
    dets = {e: [b.meta["detections"] for b in runs[e][0].buffers] for e in runs}
    if dets[False] != dets[True] or not _all_identical(
            _memories(runs[False][1]), _memories(runs[True][1])):
        raise AssertionError("tflite ssd: replayed outputs differ from the eager ones")
    n = sum(len(d) for d in dets[False])
    if n == 0:
        raise AssertionError("tflite ssd: no detections")
    cpu, _ = _tfl_load(path, "cpu")
    worst = 0.0
    for frame in frames[:TFL_CPU_FRAMES]:
        x = torch.from_numpy(((frame.astype(np.float32) - 127.5) / 127.5)[None])
        with torch.inference_mode():
            got = [t.cpu() for t in card.fn()(x.to(TFL_DEVICE))]
            want = cpu.fn()(x)
        if not (torch.equal(got[3], want[3]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"tflite ssd: card count/classes {got[3]} {got[1]} "
                                 f"!= the CPU's {want[3]} {want[1]}")
        for g, w in ((got[0], want[0]), (got[2], want[2])):
            worst = max(worst, _max_abs_err(g, w))
            if not torch.allclose(g, w, rtol=TFL_SSD_TOL[0], atol=TFL_SSD_TOL[1]):
                raise AssertionError(f"tflite ssd: card boxes/scores off the CPU's by "
                                     f"{_max_abs_err(g, w)}")
    inside = _tfl_inside_the_op(ep, card, ((frames[0].astype(np.float32) - 127.5)
                                           / 127.5)[None])
    st = runs[False][3]
    print(f"tflite (a) ssd_mobilenet_v2_coco {size}x{size} float32 .tflite "
          f"({meta['bytes']} bytes, {meta['anchors']} anchors, grids {meta['grids']}; "
          f"written in {write_s:.3f} s, loaded on the card in {load_s:.3f} s) through "
          f"framework=tensorflow2-lite: {TFL_FRAMES} frames, {n} detections, graphs "
          f"== eager; {TFL_CPU_FRAMES} frames' post-process on the card == the CPU's "
          f"in count and classes, boxes and scores within {TFL_SSD_TOL} (max abs err "
          f"{worst:.3e}); steady fps {runs[False][2]:.2f} (eager {runs[True][2]:.2f}; "
          f"336.29 with the earlier K > 1024 nms_sweep route on an H100 80GB HBM3 at "
          f"700 W); launches {launches}; {_card()}", flush=True)
    if TFL_DEVICE != "cpu":
        _record_graphs("tflite ssd", 1, "fps", runs[False][2], runs[True][2], st)
    return {"launches": launches, "nms_k1917": inside}


def _tfl_cls(tmp: str) -> None:
    """(b) the layout of mobilenet_v2_1.0_224_quant.tflite (uint8 in and out),
    through ``tensor_filter framework=tensorflow-lite ! tensor_decoder
    mode=image_labeling`` with graphs and eagerly: codes bit-equal, labels
    equal; the codes on the card against the same file on the CPU."""
    path = os.path.join(tmp, "mobilenet_v2_1.0_224_quant.tflite")
    t0 = time.perf_counter()
    meta = write_mobilenet_v2_quant_tflite(path, **TFL_CLS)
    write_s = time.perf_counter() - t0
    card, load_s = _tfl_load(path, TFL_DEVICE)
    labels = os.path.join(tmp, "labels1001.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"l{i}" for i in range(1001)))
    frames = _tfl_frames(TFL_CLS["size"], 43)
    tail = dict(mode="image_labeling", option1=labels)
    runs = {eager: _tfl_pipeline(path, "tensorflow-lite", frames, tail, eager)
            for eager in (False, True)}
    got = [b.meta["label_index"] for b in runs[False][0].buffers]
    if got != [b.meta["label_index"] for b in runs[True][0].buffers] \
            or not _all_identical(_memories(runs[False][1]), _memories(runs[True][1])):
        raise AssertionError("tflite quant: replayed codes or labels differ from eager")
    cpu, _ = _tfl_load(path, "cpu")
    steps, flipped, total = 0, 0, 0
    for frame, label in zip(frames[:TFL_CPU_FRAMES], got):
        x = torch.from_numpy(frame[None])
        with torch.inference_mode():
            card_codes = card.fn()(x.to(TFL_DEVICE))[0].cpu().to(torch.int32)
            cpu_codes = cpu.fn()(x)[0].to(torch.int32)
        diff = (card_codes - cpu_codes).abs()
        steps, flipped = max(steps, int(diff.max())), flipped + int((diff > 0).sum())
        total += diff.numel()
        if int(cpu_codes.argmax()) != label or int(card_codes.argmax()) != label:
            raise AssertionError(f"tflite quant: label {label} on the card, the CPU's "
                                 f"argmax {int(cpu_codes.argmax())}")
    if steps > 1 or flipped > 0.02 * total:
        raise AssertionError(f"tflite quant: card codes off the CPU's by up to {steps} "
                             f"steps on {flipped} of {total}")
    print(f"tflite (b) mobilenet_v2 {TFL_CLS['size']} uint8 .tflite ({meta['bytes']} bytes; "
          f"written in {write_s:.3f} s, loaded on the card in {load_s:.3f} s) through "
          f"framework=tensorflow-lite and image_labeling: {TFL_FRAMES} frames, "
          f"{len(set(got))} distinct labels, graphs == eager; {TFL_CPU_FRAMES} frames "
          f"on the card vs the CPU: labels equal, codes {flipped} of {total} differ "
          f"(at most {steps} step); steady fps {runs[False][2]:.2f} (eager "
          f"{runs[True][2]:.2f})", flush=True)
    if TFL_DEVICE != "cpu":
        _record_graphs("tflite quant", 1, "fps", runs[False][2], runs[True][2],
                       runs[False][3])


def _tfl_tensorflow(tmp: str) -> None:
    """(c) framework=tensorflow: with TensorFlow installed, a frozen GraphDef
    built here through nns-launch, its outputs on the filter's device, equal
    to ``Session.run``, with no card memory taken by TensorFlow; without
    it, ``open()`` raises the ImportError naming tensorflow."""
    from nnstreamer_tpu_torch.cli import main as cli
    from nnstreamer_tpu_torch.core.types import TensorsInfo
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.tf_backend import TensorFlowFilter

    try:
        import tensorflow as tf
    except ImportError as e:
        f = TensorFlowFilter()
        try:
            f.open(FilterProps(model=os.path.join(tmp, "absent.pb"), device=TFL_DEVICE))
        except ImportError as raised:
            if "tensorflow" not in str(raised):
                raise AssertionError(f"framework=tensorflow: {raised!r}") from raised
            print(f"tflite (c) framework=tensorflow: `import tensorflow` fails on this "
                  f"machine ({e}); open() raised {type(raised).__name__}: {raised}",
                  flush=True)
            return
        raise AssertionError("framework=tensorflow opened without tensorflow")
    rng = np.random.default_rng(47)
    w = rng.standard_normal((784, 10)).astype(np.float32) * 0.05
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [None, 784], name="input")
        tf.nn.softmax(tf.matmul(x, tf.constant(w)), name="softmax")
    model = os.path.join(tmp, "mnist.pb")
    with open(model, "wb") as f:
        f.write(g.as_graph_def().SerializeToString())
    data = os.path.join(tmp, "9.raw")
    digit = rng.integers(0, 256, 784, dtype=np.uint8)
    digit.tofile(data)
    out = os.path.join(tmp, "tf.out.log")
    launch = (f"filesrc location={data} ! application/octet-stream ! "
              "tensor_converter input-dim=784:1 input-type=uint8 ! "
              "tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
              f"tensor_filter framework=tensorflow model={model} input=784:1 "
              "inputtype=float32 inputname=input output=10:1 outputtype=float32 "
              f"outputname=softmax ! filesink location={out}")
    free0 = torch.cuda.mem_get_info()[0] if TFL_DEVICE != "cpu" else 0
    seen, invoke = [], TensorFlowFilter.invoke

    def recorded(self, inputs):
        outs = invoke(self, inputs)
        seen.append(([m.host().copy() for m in inputs], outs))
        return outs

    TensorFlowFilter.invoke = recorded
    try:
        rc = cli(["--device", TFL_DEVICE, launch])
    finally:
        TensorFlowFilter.invoke = invoke
    taken = (free0 - torch.cuda.mem_get_info()[0]) / 2 ** 20 if TFL_DEVICE != "cpu" else 0.0
    if rc != 0 or len(seen) != 1:
        raise AssertionError(f"nns-launch framework=tensorflow: exit {rc}, {len(seen)} frames")
    (fed,), (result,) = seen[0][0], seen[0][1]
    with tf.compat.v1.Session(graph=g, config=tf.compat.v1.ConfigProto(
            device_count={"GPU": 0})) as sess:
        want = sess.run("softmax:0", {"input:0": fed.reshape(1, 784)})
    got = result.device()
    if got.device.type != torch.device(TFL_DEVICE).type \
            or not np.array_equal(got.cpu().numpy(), want) \
            or not np.array_equal(np.fromfile(out, np.float32).reshape(1, 10), want):
        raise AssertionError(f"framework=tensorflow: output on {got.device} differs "
                             "from Session.run")
    if taken > 256:
        raise AssertionError(f"framework=tensorflow: TensorFlow took {taken:.1f} MiB of the card")
    print(f"tflite (c) framework=tensorflow {tf.__version__} through nns-launch: output "
          f"on {got.device} == Session.run; card memory taken while it ran "
          f"{taken:.1f} MiB", flush=True)


def run_tflite(counters) -> dict:
    """The TFLite phase: (a) SSD-MobileNet-v2, (b) quantized MobileNet-v2,
    (c) framework=tensorflow. Returns (a)'s launches and its K-1917 sweep."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ssd = _tfl_ssd(tmp, counters)
        _release()
        _tfl_cls(tmp)
        _release()
        _tfl_tensorflow(tmp)
    _release()
    print(f"tflite phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return ssd


def _start_groups(specs: list) -> dict:
    """{world: RankGroup} for each (world, backend), started in threads so
    their spawns and CUDA contexts come up together; all closed if one
    fails."""
    from nnstreamer_tpu_torch.parallel.launch import RankGroup

    groups, errors = {}, []

    def start(world, backend):
        try:
            groups[world] = RankGroup(world, device=PAR_DEVICE, timeout=PAR_TIMEOUT,
                                      backend=backend)
        except BaseException as e:  # noqa: BLE001 — raised below, in order
            errors.append(e)

    threads = [threading.Thread(target=start, args=spec) for spec in specs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for g in groups.values():
            g.close()
        raise errors[0]
    return groups


def _single_engine(params, cfg: dict):
    """The single-card engine the TP runs are held against."""
    from nnstreamer_tpu_torch.serving import LMEngine

    return LMEngine(params, cfg["dims"][2], cfg["max_len"], n_slots=cfg["slots"],
                    chunk=cfg["chunk"], device=cfg["device"])


def _serve_on(eng, requests: list) -> tuple:
    """(tokens per request, wall seconds) of ``requests`` on ``eng``."""
    rids = [eng.submit(p, max_new=g) for p, g in requests]
    t0 = time.perf_counter()
    res = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return [res[r] for r in rids], time.perf_counter() - t0


#: the arena of ``write_legacy_lenet``'s file
LEGACY_ARENA = '''op_version_set = 0
def forward(self,
    input_1: Tensor) -> Tensor:
  _0 = torch.div(torch.permute(torch._cast_Float(input_1, False), [0, 3, 1, 2]), 255.)
  _1 = torch._convolution(_0, self.conv1.weight, self.conv1.bias, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, False, False, True)
  _2 = torch.max_pool2d(torch.relu(_1), [2, 2], [2, 2], [0, 0], [1, 1], False)
  _3 = ops.prim.NumToTensor(torch.size(_2, 0))
  _4 = torch.view(_2, [int(_3), -1])
  _5 = torch.addmm(self.fc.bias, _4, torch.t(self.fc.weight), beta=1, alpha=1)
  _6 = torch.zeros([int(_3), 10], dtype=None, layout=None, device=torch.device("cpu"), pin_memory=False)
  _7 = torch.softmax(torch.add(_5, _6, alpha=1), 1)
  return torch._cast_Byte(torch.mul(_7, 255.), False)
'''


class LegacyLeNet(torch.nn.Module):
    """The model ``write_legacy_lenet`` serializes, as an eager module whose
    forward runs the arena's ops in its order: uint8 (b, 28, 28, 1) ->
    (b, 10) uint8 softmax scores, as the reference's pytorch_lenet5.pt."""

    def __init__(self, seed):
        super().__init__()
        g = np.random.default_rng(seed)
        self.w1 = torch.nn.Parameter(torch.from_numpy(g.normal(0, 0.2, (6, 1, 5, 5)).astype(np.float32)), False)
        self.b1 = torch.nn.Parameter(torch.from_numpy(g.normal(0, 0.1, (6,)).astype(np.float32)), False)
        self.w2 = torch.nn.Parameter(torch.from_numpy(g.normal(0, 0.05, (10, 6 * 12 * 12)).astype(np.float32)), False)
        self.b2 = torch.nn.Parameter(torch.from_numpy(g.normal(0, 0.1, (10,)).astype(np.float32)), False)

    def forward(self, x):
        x = x.float().permute(0, 3, 1, 2) / 255.
        x = F.max_pool2d(torch.relu(F.conv2d(x, self.w1, self.b1)), [2, 2], [2, 2])
        x = x.reshape(x.shape[0], -1)
        y = torch.addmm(self.b2, x, self.w2.t())
        return (torch.softmax(y + x.new_zeros((x.shape[0], 10)), 1) * 255.).to(torch.uint8)


def write_legacy_lenet(path: str, seed: int = 0) -> torch.nn.Module:
    """A legacy (torch-1.0 era) TorchScript zip at ``path`` in the layout
    models/torch_legacy.py reads: ``model.json`` protoVersion 2 with the
    module tree and tensor metadata, raw tensor blobs (the conv bias at an
    offset into the weight's blob, the dense weight a transposed strided
    view of its storage) and the ``code/`` arena, whose forward uses the
    era's ops (``_cast_Float``, ``_convolution``, ``NumToTensor``, a factory
    op with a baked-in ``device="cpu"``). Returns the eager module it
    serializes (seeded weights)."""
    net = LegacyLeNet(seed)
    w1, b1 = net.w1.detach().numpy(), net.b1.detach().numpy()
    w2, b2 = net.w2.detach().numpy(), net.b2.detach().numpy()
    tensors = [
        # conv weight and bias share one blob, the bias at an offset
        {"dims": ["6", "1", "5", "5"], "offset": "0", "strides": ["25", "25", "5", "1"],
         "dataType": "FLOAT", "data": {"key": "tensors/0"}},
        {"dims": ["6"], "offset": str(w1.size), "strides": ["1"],
         "dataType": "FLOAT", "data": {"key": "tensors/0"}},
        # the dense weight stored transposed: a strided view of its storage
        {"dims": ["10", str(w2.shape[1])], "offset": "0", "strides": ["1", "10"],
         "dataType": "FLOAT", "data": {"key": "tensors/1"}},
        {"dims": ["10"], "offset": "0", "strides": ["1"],
         "dataType": "FLOAT", "data": {"key": "tensors/2"}}]
    model = {"protoVersion": "2", "producerName": "pytorch", "producerVersion": "1.0",
             "mainModule": {
                 "name": "main",
                 "submodules": [
                     {"name": "conv1", "parameters": [{"name": "weight", "tensorId": "0"},
                                                      {"name": "bias", "tensorId": "1"}]},
                     {"name": "fc", "parameters": [{"name": "weight", "tensorId": "2"},
                                                   {"name": "bias", "tensorId": "3"}]}],
                 "torchscriptArena": {"key": "code/main.py"}},
             "tensors": tensors}
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("lenet/model.json", json.dumps(model))
        z.writestr("lenet/tensors/0", np.concatenate([w1.ravel(), b1]).tobytes())
        z.writestr("lenet/tensors/1", np.ascontiguousarray(w2.T).tobytes())
        z.writestr("lenet/tensors/2", b2.tobytes())
        z.writestr("lenet/code/main.py", LEGACY_ARENA)
    return net.eval()


# --------------------------------------------------------------------------- #
# .tflite writer: TFLite models built here from a seed, on the port's own
# FlatBuffers and FlexBuffers builders (the card's machine has no
# ``flatbuffers`` package)
# --------------------------------------------------------------------------- #

#: schema TensorType and BuiltinOperator codes the writer uses
TFL_F32, TFL_I32, TFL_U8 = 0, 2, 3
TFL_ADD, TFL_AVG_POOL, TFL_CONCAT, TFL_CONV, TFL_DWCONV = 0, 1, 2, 3, 4
TFL_LOGISTIC, TFL_RESHAPE, TFL_SOFTMAX, TFL_CUSTOM = 14, 22, 25, 32
#: TFLite_Detection_PostProcess of ssd_mobilenet_v2_coco as
#: export_tflite_ssd_graph.py writes it
SSD_POSTPROCESS = {"max_detections": 10, "max_classes_per_detection": 1,
                   "detections_per_class": 100, "use_regular_nms": False,
                   "nms_score_threshold": 1e-8, "nms_iou_threshold": 0.6,
                   "num_classes": 90, "y_scale": 10.0, "x_scale": 10.0,
                   "h_scale": 5.0, "w_scale": 5.0}


def tflite_flexbuffer_map(values: dict) -> bytes:
    """A custom operator's options: a FlexBuffers map of ints, floats and
    bools (``converters/flexbuf_codec.Builder``)."""
    from nnstreamer_tpu_torch.converters import flexbuf_codec

    b = flexbuf_codec.Builder()
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
    """A one-subgraph ``.tflite`` flatbuffer. ``tensors``: dicts of
    ``shape``, ``type``, ``data`` (numpy or None), ``quant`` ((scale, zero
    point) or None) and ``name``; ``operators``: dicts of ``code``,
    ``inputs``, ``outputs``, ``options`` ((union type, [(slot, packer,
    value, default), ...]) or None), ``custom_code`` and
    ``custom_options``. The layout is that of ``tests/test_tflite_ops.py``'s
    ``build_tflite`` (buffer 0 empty, version 3, identifier ``TFL3``)."""
    from nnstreamer_tpu_torch.converters import flatbuf_codec as fb

    b = fb.Builder(1 << 20)
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
        shape = b.create_vector(fb.I32, t["shape"])
        name = b.create_string(t.get("name", ""))
        quant = None
        if t.get("quant") is not None:
            scale, zp = t["quant"]
            scales = b.create_vector(fb.F32, np.atleast_1d(scale).tolist())
            zps = b.create_vector(fb.I64, np.atleast_1d(zp).tolist())
            b.start_object(7)
            b.add_uoffset(2, scales)
            b.add_uoffset(3, zps)
            quant = b.end_object()
        b.start_object(8)
        b.add_uoffset(0, shape)
        b.add_scalar(1, fb.I8, t["type"], 0)
        b.add_scalar(2, fb.U32, buf, 0)
        b.add_uoffset(3, name)
        if quant is not None:
            b.add_uoffset(4, quant)
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
        b.add_scalar(0, fb.I8, min(code, 127), 0)
        if custom_off is not None:
            b.add_uoffset(1, custom_off)
        b.add_scalar(3, fb.I32, code, 0)
        code_tables.append(b.end_object())
    op_tables = []
    for op in operators:
        ins = b.create_vector(fb.I32, op["inputs"])
        outs = b.create_vector(fb.I32, op["outputs"])
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
        b.add_scalar(0, fb.U32, codes.index((op["code"], op.get("custom_code"))), 0)
        b.add_uoffset(1, ins)
        b.add_uoffset(2, outs)
        if opt_off is not None:
            b.add_scalar(3, fb.U8, opt[0], 0)
            b.add_uoffset(4, opt_off)
        if custom_off is not None:
            b.add_uoffset(5, custom_off)
        op_tables.append(b.end_object())
    tensor_vec = b.create_offset_vector(tables)
    in_vec = b.create_vector(fb.I32, inputs)
    out_vec = b.create_vector(fb.I32, outputs)
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
    desc = b.create_string("written by chip_smoke.py")
    b.start_object(8)
    b.add_scalar(0, fb.U32, 3, 0)
    b.add_uoffset(1, code_vec)
    b.add_uoffset(2, subgraphs)
    b.add_uoffset(3, desc)
    b.add_uoffset(4, buffer_vec)
    model = b.end_object()
    return bytes(b.finish(model, b"TFL3"))


def _tfl_conv_options(stride: int, act: int) -> tuple:
    from nnstreamer_tpu_torch.converters.flatbuf_codec import I8, I32

    # Conv2DOptions: 0 padding (SAME), 1 stride_w, 2 stride_h, 3 activation
    return (1, [(0, I8, 0, 0), (1, I32, stride, 0), (2, I32, stride, 0),
                (3, I8, act, 0)])


def _tfl_dwconv_options(stride: int, act: int) -> tuple:
    from nnstreamer_tpu_torch.converters.flatbuf_codec import I8, I32

    # DepthwiseConv2DOptions: 0 padding, 1/2 strides, 3 depth_multiplier,
    # 4 activation
    return (2, [(0, I8, 0, 0), (1, I32, stride, 0), (2, I32, stride, 0),
                (3, I32, 1, 0), (4, I8, act, 0)])


class TFLiteNet:
    """A TFLite graph under construction: NHWC float32 activations, convs
    with their folded-BatchNorm bias, seeded weights (He-normal for a
    ReLU6 conv, LeCun-normal for a linear one). ``acts`` lists the
    activation tensors (the calibration's outputs); ``quantize`` turns the
    graph into its uint8 form on calibrated grids."""

    RELU6, LINEAR = 3, 0

    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)
        self.tensors: list = []
        self.operators: list = []
        self.acts: list = []
        self.inputs: list = []
        self.outputs: list = []

    def tensor(self, shape, data=None, type_=TFL_F32, name="", **role) -> int:
        self.tensors.append(dict(shape=tuple(int(d) for d in shape), type=type_,
                                 data=data, name=name, **role))
        return len(self.tensors) - 1

    def act(self, shape, name="", **role) -> int:
        i = self.tensor(shape, name=name, role="act", **role)
        self.acts.append(i)
        return i

    def shape(self, i: int) -> tuple:
        return self.tensors[i]["shape"]

    def _weights(self, shape, fan_in: int, act: int) -> np.ndarray:
        std = np.sqrt((2.0 if act == self.RELU6 else 1.0) / fan_in)
        return (self.rng.standard_normal(shape) * std).astype(np.float32)

    def conv(self, x: int, cout: int, k: int = 1, stride: int = 1,
             act: int = RELU6, gain: float = 1.0, name: str = "") -> int:
        n, h, w, cin = self.shape(x)
        wt = self.tensor((cout, k, k, cin), self._weights(
            (cout, k, k, cin), k * k * cin, act) * np.float32(gain), role="weight")
        bias = self.tensor((cout,), (self.rng.standard_normal(cout) * 0.05)
                           .astype(np.float32), role="bias", of=(x, wt))
        y = self.act((n, -(-h // stride), -(-w // stride), cout), name)
        self.operators.append(dict(code=TFL_CONV, inputs=[x, wt, bias], outputs=[y],
                                   options=_tfl_conv_options(stride, act)))
        return y

    def dwconv(self, x: int, stride: int, act: int = RELU6) -> int:
        n, h, w, c = self.shape(x)
        wt = self.tensor((1, 3, 3, c), self._weights((1, 3, 3, c), 9, act),
                         role="weight")
        bias = self.tensor((c,), (self.rng.standard_normal(c) * 0.05)
                           .astype(np.float32), role="bias", of=(x, wt))
        y = self.act((n, -(-h // stride), -(-w // stride), c))
        self.operators.append(dict(code=TFL_DWCONV, inputs=[x, wt, bias], outputs=[y],
                                   options=_tfl_dwconv_options(stride, act)))
        return y

    def add(self, a: int, b: int) -> int:
        y = self.act(self.shape(a))
        self.operators.append(dict(code=TFL_ADD, inputs=[a, b], outputs=[y]))
        return y

    def reshape(self, x: int, shape, name: str = "") -> int:
        s = self.tensor((len(shape),), np.asarray(shape, np.int32), TFL_I32)
        y = self.act(shape, name, same_as=x)
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
                h = self.conv(h, depth(c), act=self.LINEAR)
                y = self.add(y, h) if i > 0 else h
                layer += 1
        return tap, self.conv(y, depth(1280) if width > 1 else 1280)

    def quantize(self, ranges: dict) -> None:
        """uint8 grids: the input's (1/128, 128); each activation's from its
        calibrated (min, max) with 0 inside, a reshape's and a pool's its
        input's; weights per tensor; a bias on its conv's accumulator grid
        (input scale × weight scale, int32); a softmax's (1/256, 0)."""
        def grid(lo, hi):
            lo, hi = min(lo, 0.0), max(hi, 0.0)
            scale = max((hi - lo) / 255.0, 1e-8)
            return np.float32(scale), int(np.clip(round(-lo / scale), 0, 255))

        for i, t in enumerate(self.tensors):
            role = t.get("role")
            if role == "input":
                t["quant"] = (np.float32(1 / 128), 128)
            elif role == "act" and "softmax" in t:
                t["quant"] = (np.float32(1 / 256), 0)
            elif role == "act" and "same_as" not in t:
                t["quant"] = grid(*ranges[i])
            elif role == "weight":
                a = t["data"]
                scale, zp = grid(float(a.min()), float(a.max()))
                t["data"] = np.clip(np.round(a / scale) + zp, 0, 255).astype(np.uint8)
                t["quant"] = (scale, zp)
            if role in ("input", "act", "weight"):
                t["type"] = TFL_U8
        for t in self.tensors:  # pass-through grids, in graph order
            if "same_as" in t:
                t["quant"] = self.tensors[t["same_as"]]["quant"]
        for t in self.tensors:
            if t.get("role") == "bias":
                x, w = t["of"]
                scale = np.float32(self.tensors[x]["quant"][0]) \
                    * np.float32(self.tensors[w]["quant"][0])
                t["data"] = np.round(t["data"] / scale).astype(np.int32)
                t["type"], t["quant"] = TFL_I32, (scale, 0)

    def write(self, path: str, outputs=None) -> int:
        blob = tflite_bytes(self.tensors, self.operators, self.inputs,
                            self.outputs if outputs is None else outputs)
        with open(path, "wb") as f:
            f.write(blob)
        return len(blob)


def _run_outputs(net: TFLiteNet, path: str, outputs: list, inputs: list) -> list:
    """The graph so far written with ``outputs`` as its outputs (16 at
    most, a frame's most), run by the port on the CPU on each of
    ``inputs`` (the written file is the same whatever card runs it): one
    tuple of tensors an input."""
    from nnstreamer_tpu_torch.models.tflite_import import load_tflite

    net.write(path, outputs=outputs)
    bundle = load_tflite(path, device="cpu")
    with torch.inference_mode():
        runs = [bundle.fn()(torch.from_numpy(x)) for x in inputs]
    os.remove(path)
    return runs


def _calibrate(net: TFLiteNet, path: str, inputs: list) -> dict:
    """Each activation's (min, max) over ``inputs`` in the float graph."""
    lo, hi = {}, {}
    for start in range(0, len(net.acts), 16):
        acts = net.acts[start:start + 16]
        for run in _run_outputs(net, path, acts, inputs):
            for i, y in zip(acts, run):
                lo[i] = min(lo.get(i, np.inf), float(y.min()))
                hi[i] = max(hi.get(i, -np.inf), float(y.max()))
    return {i: (lo[i], hi[i]) for i in net.acts}


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


def write_ssd_mobilenet_v2_tflite(path: str, size: int = 300, width: float = 1.0,
                                  seed: int = 0) -> dict:
    """ssd_mobilenet_v2_coco as ``export_tflite_ssd_graph.py`` writes it,
    float32, seeded: the MobileNet-v2 body, feature maps at layer_15's
    expansion, layer_19 and four extra 1x1/3x3-stride-2 pairs (512, 256,
    256, 128 × ``width``), 1x1 box and class predictors (3 anchors a cell on
    the first map, 6 after), 91 class columns through LOGISTIC and
    ``TFLite_Detection_PostProcess`` (``SSD_POSTPROCESS``, anchors a
    constant). The class heads are centred and scaled to logits of
    standard deviation 1 on four seeded frames (``_center_heads``: scores
    spread, none saturated). Returns the anchor count and grids."""
    from nnstreamer_tpu_torch.converters.flatbuf_codec import I32

    net = TFLiteNet(seed)
    x = net.tensor((1, size, size, 3), name="normalized_input_image_tensor",
                   role="input")
    net.inputs = [x]
    tap, top = net.mobilenet_v2_body(x, width)
    maps = [tap, top]
    y = top
    for d in (512, 256, 256, 128):
        d = max(16, int(d * width))
        y = net.conv(net.conv(y, d // 2), d, 3, 2)
        maps.append(y)
    boxes, classes, grids, class_convs = [], [], [], []
    for i, m in enumerate(maps):
        _, h, w, _ = net.shape(m)
        grids.append(h)
        a = 3 if i == 0 else 6
        boxes.append(net.reshape(net.conv(m, a * 4, act=net.LINEAR, gain=0.5),
                                 (1, h * w * a, 4)))
        logit = net.conv(m, a * 91, act=net.LINEAR)
        class_convs.append(net.operators[-1])
        classes.append(net.reshape(logit, (1, h * w * a, 91)))
    anchors = ssd_anchors(grids)
    n = len(anchors)

    def concat(parts, last, name):
        y = net.act((1, n, last), name)
        net.operators.append(dict(code=TFL_CONCAT, inputs=parts, outputs=[y],
                                  options=(10, [(0, I32, 1, 0)])))
        return y

    box_enc = concat(boxes, 4, "raw_outputs/box_encodings")
    logits = concat(classes, 91, "raw_outputs/class_logits")
    rng = np.random.default_rng(seed + 1)
    calib = [rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32) for _ in range(4)]
    _center_heads(net, path, class_convs, calib, 1.0)
    scores = net.act((1, n, 91), "class_predictions")
    net.operators.append(dict(code=TFL_LOGISTIC, inputs=[logits], outputs=[scores]))
    anchor_t = net.tensor((n, 4), anchors, name="anchors")
    outs = [net.act((1, 10, 4), "TFLite_Detection_PostProcess"),
            net.act((1, 10), "TFLite_Detection_PostProcess:1"),
            net.act((1, 10), "TFLite_Detection_PostProcess:2"),
            net.act((1,), "TFLite_Detection_PostProcess:3")]
    net.operators.append(dict(code=TFL_CUSTOM, custom_code="TFLite_Detection_PostProcess",
                              custom_options=tflite_flexbuffer_map(SSD_POSTPROCESS),
                              inputs=[box_enc, scores, anchor_t], outputs=outs))
    net.outputs = outs
    nbytes = net.write(path)
    return {"anchors": n, "grids": grids, "bytes": nbytes}


def _center_heads(net: TFLiteNet, path: str, convs: list, inputs: list,
                  std: float) -> None:
    """Seeded ReLU6 features have a positive mean, which gives each output
    channel of a linear head an offset of its own, so one class would win
    everywhere. Over the calibration ``inputs``, each head conv's bias loses
    its channel's mean, then weights and bias are scaled so the centred
    outputs have standard deviation ``std``."""
    runs = _run_outputs(net, path, [op["outputs"][0] for op in convs], inputs)
    centred = []
    for j, op in enumerate(convs):
        y = torch.cat([r[j].reshape(-1, r[j].shape[-1]) for r in runs]).double().cpu()
        mean = y.mean(dim=0)
        bias = net.tensors[op["inputs"][2]]
        bias["data"] = (bias["data"] - mean.numpy()).astype(np.float32)
        centred.append((y - mean).reshape(-1))
    gain = np.float32(std / float(torch.cat(centred).std()))
    for op in convs:
        for t in op["inputs"][1:]:
            net.tensors[t]["data"] = net.tensors[t]["data"] * gain


def write_mobilenet_v2_quant_tflite(path: str, size: int = 224, width: float = 1.0,
                                    seed: int = 0) -> dict:
    """The layout of the reference's ``mobilenet_v2_1.0_224_quant.tflite``,
    seeded: uint8 (1, size, size, 3) in on the grid (1/128, 128), the
    MobileNet-v2 body, a VALID average pool over the last grid, a 1x1 conv
    to 1001 logits, RESHAPE to (1, 1001) and SOFTMAX, uint8 (1, 1001) out
    on (1/256, 0); every activation uint8 on a per-tensor grid calibrated
    from the float graph over four seeded frames, weights uint8 per tensor,
    biases int32 on their accumulator grids. The logits are centred and
    scaled to a standard deviation of 6 first (``_center_heads``: a softmax
    with a clear top-1 that varies with the frame)."""
    from nnstreamer_tpu_torch.converters.flatbuf_codec import F32, I8, I32

    net = TFLiteNet(seed)
    x = net.tensor((1, size, size, 3), name="input", role="input")
    net.inputs = [x]
    _, top = net.mobilenet_v2_body(x, width)
    _, g, _, c = net.shape(top)
    pooled = net.act((1, 1, 1, c), same_as=top)
    net.operators.append(dict(code=TFL_AVG_POOL, inputs=[top], outputs=[pooled], options=(
        5, [(0, I8, 1, 0), (1, I32, 1, 0), (2, I32, 1, 0), (3, I32, g, 0), (4, I32, g, 0)])))
    logits4 = net.conv(pooled, 1001, act=net.LINEAR)
    rng = np.random.default_rng(seed + 1)
    calib = [(rng.integers(0, 256, (1, size, size, 3)).astype(np.float32) - 128) / 128
             for _ in range(4)]
    _center_heads(net, path, [net.operators[-1]], calib, 6.0)
    logits = net.reshape(logits4, (1, 1001))
    probs = net.act((1, 1001), "MobilenetV2/Predictions/Reshape_1", softmax=True)
    net.operators.append(dict(code=TFL_SOFTMAX, inputs=[logits], outputs=[probs],
                              options=(9, [(0, F32, 1.0, 0.0)])))
    net.outputs = [probs]
    ranges = _calibrate(net, path, calib)
    net.quantize(ranges)
    return {"bytes": net.write(path)}


#: the examples phase: ``examples/<name>_torch.py``, each by its ``main``
#: at its own defaults on the card, in this order
EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
EXAMPLES = ("classify_stream", "adaptive_batch_serving", "deploy_serve",
            "remote_offload", "mqtt_fanout", "online_finetune", "serve_lm",
            "streaming_generate", "serve_reference_models")
#: reruns of the repaired repo loop (an accumulator through tensor_mux)
EXAMPLES_LOOP_RUNS = 20


def _example_module(name: str):
    import importlib

    if EXAMPLES_DIR not in sys.path:
        sys.path.insert(0, EXAMPLES_DIR)
    return importlib.import_module(f"{name}_torch")


def _example(name: str, argv=()) -> tuple:
    """``examples/<name>_torch.py``'s ``main(argv)`` in this process (its
    default device: the card); returns what it printed and its seconds."""
    import io

    mod = _example_module(name)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = mod.main(list(argv))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rc not in (None, 0):
        raise AssertionError(f"{name}_torch: main returned {rc}")
    return out.getvalue(), dt


def _lines(text: str, prefix: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith(prefix)]


def _check_example(name: str, text: str) -> str:
    """What ``name`` printed, checked; returns its summary line."""
    import ast
    import re

    def need(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"{name}_torch: {what}; it printed:\n{text}")

    if name == "classify_stream":
        frames = _lines(text, "frame ")
        need(frames and all(re.fullmatch(r"frame \d+: class\d+", ln)
                            for ln in frames), "no frame label lines")
        row = _lines(text, "tensor_filter")  # its name counts every filter made
        need(len(row) == 1 and int(row[0].split()[1]) == 100,
             "the filter saw != 100 frames")
        return _lines(text, "filter latency:")[0]
    if name == "adaptive_batch_serving":
        line = _lines(text, "400 per-frame results in ")
        need(line and "batch=16, budget=50.0ms" in line[0], "not 400 results")
        return line[0]
    if name == "deploy_serve":
        line = _lines(text, "served 8 frames; first label: class")
        need(line and _lines(text, "exported "), "not 8 frames served")
        return line[0]
    if name == "remote_offload":
        frames = _lines(text, "frame ")
        need(len(frames) == 10 and all("nan" not in ln and "inf" not in ln
                                       for ln in frames), "not 10 finite logits")
        return f"{len(frames)} frames behind the hop; {frames[-1]}"
    if name == "mqtt_fanout":
        line = _lines(text, "recorder got 10, detector got 10")
        need(line, "a subscriber missed frames")
        return line[0]
    if name == "online_finetune":
        line = _lines(text, "loss: ")
        m = re.fullmatch(r"loss: ([\d.]+) → ([\d.]+) after 50 online steps",
                         line[0] if line else "")
        need(m and float(m.group(2)) < float(m.group(1)), "the loss did not fall")
        need(_lines(text, "trained params ready for filter.update_model(): (16, 4)"),
             "no trained params")
        return line[0]
    if name == "serve_lm":
        toks = {ln.split("->")[0].strip(): ast.literal_eval(ln.split("->")[1].strip())
                for ln in text.splitlines() if "->" in ln}
        need(set(toks) == {"greedy", "sampled t=1.0", "nucleus p=0.9", "top-k 16",
                           "w8a8 int8"}, "missing requests")
        need(all(len(v) == 16 for k, v in toks.items() if k != "w8a8 int8")
             and len(toks["w8a8 int8"]) == 12
             and all(0 <= t < 128 for v in toks.values() for t in v),
             "wrong token counts or ids")
        line = _lines(text, "speculative: identical greedy output")
        need(line, "no speculative line")
        return line[0]
    if name == "streaming_generate":
        m = re.fullmatch(r"prompt=\[1, 7, 3\] generated=(\[.*\])", text.strip())
        need(m and len(ast.literal_eval(m.group(1))) == 24, "not 24 tokens")
        return text.strip()
    raise ValueError(name)


def _reference_files(tmp: str) -> tuple:
    """The reference's model directory layout, the two files the card's
    machine can serve (no TensorFlow there) built under their names: the
    quantized MobileNet-v2 224 .tflite and the legacy TorchScript LeNet,
    with a seeded orange.png, 9.png and a 1001-line labels file."""
    from PIL import Image

    models, data = os.path.join(tmp, "models"), os.path.join(tmp, "data")
    os.makedirs(models)
    os.makedirs(data)
    rng = np.random.default_rng(25)
    write_mobilenet_v2_quant_tflite(
        os.path.join(models, "mobilenet_v2_1.0_224_quant.tflite"))
    Image.fromarray(rng.integers(0, 256, (224, 224, 3), dtype=np.uint8),
                    "RGB").save(os.path.join(data, "orange.png"))
    write_legacy_lenet(os.path.join(models, "pytorch_lenet5.pt"), seed=0)
    Image.fromarray(rng.integers(0, 256, (28, 28), dtype=np.uint8),
                    "L").save(os.path.join(data, "9.png"))
    labels = os.path.join(tmp, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"label{i}" for i in range(1001)))
    return models, data, labels


def _accumulator_loop(frames: list) -> list:
    """The repo accumulator loop on the card: ``appsrc → tensor_mux ←
    tensor_reposrc → tensor_filter (x + h) → tee → [queue → sink], [queue
    → tensor_reposink]``; returns the sink's first values."""
    from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.elements.repo import reset_repo
    from nnstreamer_tpu_torch.graph import Pipeline

    reset_repo()
    p = Pipeline("accumulator", device="cuda")
    src = p.add_new("appsrc", caps=Caps.tensors(TensorsConfig(
        TensorsInfo.from_strings("2", "float32"), 30)), data=frames, framerate=30)
    state = p.add_new("tensor_reposrc", slot_index=6, dims="2", types="float32")
    mux = p.add_new("tensor_mux", sync_mode="nosync")
    filt = p.add_new("tensor_filter", model=lambda x, h: x + h)
    tee = p.add_new("tee")
    q1, q2 = p.add_new("queue"), p.add_new("queue")
    rsink = p.add_new("tensor_reposink", slot_index=6)
    sink = p.add_new("tensor_sink", store=True)
    Pipeline.link(src, mux)
    Pipeline.link(state, mux)
    Pipeline.link(mux, filt, tee)
    Pipeline.link(tee, q1, sink)
    Pipeline.link(tee, q2, rsink)
    p.start()
    try:
        deadline = time.monotonic() + 60
        while sink.num_buffers < len(frames) and time.monotonic() < deadline:
            time.sleep(0.002)
    finally:
        p.stop()
    return [float(b.memories[0].host()[0]) for b in sink.buffers]


def _check_repairs() -> str:
    """The repaired N-input EOS order (the accumulator loop rerun
    EXAMPLES_LOOP_RUNS times, none may stall), ``tensor_batch``'s health
    probe and ``SingleShot(accelerator=)`` on the card, and
    ``core/data.py``'s casts there (in range equal to the CPU's, out of
    range printed); returns the summary line."""
    from nnstreamer_tpu_torch.core.data import typecast_array
    from nnstreamer_tpu_torch.core.types import TensorDType
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.obs import health
    from nnstreamer_tpu_torch.single import SingleShot

    frames = [np.full(2, 1, np.float32)] * 3
    stalls = 0
    for _ in range(EXAMPLES_LOOP_RUNS):
        got = _accumulator_loop(frames)
        if got != [1.0, 2.0, 3.0]:
            stalls += 1
            print(f"  accumulator loop: {got}", flush=True)
    if stalls:
        raise AssertionError(f"repaired repo loop: {stalls} of {EXAMPLES_LOOP_RUNS} "
                             "runs stalled or went wrong")

    was = health.registry().is_enabled
    health.enable(interval_s=60.0)
    try:
        p = Pipeline("batch-probe", device="cuda")
        src = p.add_new("videotestsrc", width=32, height=32, num_buffers=8)
        conv = p.add_new("tensor_converter")
        bat = p.add_new("tensor_batch", max_batch=4)
        filt = p.add_new("tensor_filter", model=lambda x: x.float().mean((1, 2, 3)))
        unb = p.add_new("tensor_unbatch")
        sink = p.add_new("tensor_sink", store=True)
        Pipeline.link(src, conv, bat, filt, unb, sink)
        p.run(timeout=120)
        comps = {c["name"]: c for c in health.snapshot()["components"]}
        probe = comps[f"element:{p.name}:{bat.name}"]["probe"]
    finally:
        if not was:
            health.disable()
    if bat.health_probe() != {"depth": 0, "bound": 16} or probe["bound"] != 16 \
            or sink.num_buffers != 8:
        raise AssertionError(f"tensor_batch probe {bat.health_probe()}, watchdog "
                             f"{probe}, {sink.num_buffers} frames")

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    with SingleShot(model=lambda t: t * 2 + 1, accelerator="true:gpu",
                    timeout_s=5.0) as single:
        y, = single.invoke(x)
    if single.device.type != "cuda" or y.device.type != "cuda" \
            or not np.array_equal(y.cpu().numpy(), x * 2 + 1):
        raise AssertionError(f"SingleShot(accelerator='true:gpu'): {single.device}, "
                             f"{y.device}")

    tame = torch.tensor([3.7, -3.7, 127.9, -128.0, 0.5, -0.0], dtype=torch.float64)
    for dt in ("int8", "int16", "int32", "int64", "float16", "bfloat16"):
        got = typecast_array(tame.cuda(), TensorDType(dt)).cpu()
        if not torch.equal(got, typecast_array(tame, TensorDType(dt))):
            raise AssertionError(f"typecast_array to {dt} on the card: {got.tolist()}")
    wild = torch.tensor([300.5, -1.0, 1e10, -1e10, float("nan"), 2.0 ** 32 + 5],
                        dtype=torch.float64)
    casts = {dt: (typecast_array(wild.cuda(), TensorDType(dt)).cpu().tolist(),
                  typecast_array(wild, TensorDType(dt)).tolist())
             for dt in ("uint8", "int8", "int32", "uint32")}
    print(f"  in-range casts equal the CPU's; out-of-range float64 casts "
          f"{wild.tolist()} (card, CPU; no defined C result): {casts}", flush=True)
    return (f"repaired repo loop {EXAMPLES_LOOP_RUNS} runs, 0 stalls; tensor_batch "
            f"probe {probe['depth']}/{probe['bound']}; SingleShot(accelerator="
            f"'true:gpu') on {single.device}")


def run_examples(counters) -> dict:
    """The examples phase: the nine ``examples/*_torch.py`` on the card at
    their defaults (serve_reference_models on the two files built here;
    its ``.pb`` block needs TensorFlow, which this machine lacks), then the
    repairs. Returns the kernels' launches over the nine scripts."""
    t0 = time.perf_counter()
    counters.reset()
    for name in EXAMPLES[:-1]:
        text, dt = _example(name)
        print(f"example {name}_torch: {dt:.3f} s; {_check_example(name, text)}",
              flush=True)
        _release()
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        models, data, labels = _reference_files(tmp)
        built = time.perf_counter() - t1
        ref = _example_module("serve_reference_models")
        blocks = ("tflite", "pytorch")
        kw = {"blocks": blocks, "models": models, "data": data, "labels": labels}
        t1 = time.perf_counter()
        found = ref.serve_reference(**kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        on_cpu = ref.serve_reference(device="cpu", **kw)
    if set(found) != set(blocks) or found != on_cpu:
        raise AssertionError(f"serve_reference_models_torch: card {found}, CPU {on_cpu}")
    print(f"example serve_reference_models_torch: {dt:.3f} s (files built in "
          f"{built:.3f} s); tflite {found['tflite']!r}, pytorch digit "
          f"{found['pytorch']}, equal to the CPU's; the framework=tensorflow "
          "block skipped: it needs the tensorflow package, which this machine "
          "lacks", flush=True)
    launches = counters.read()
    if not launches.get("dequant_gelu_requant"):
        raise AssertionError(f"examples: serve_lm's w8a8 engine launched no "
                             f"dequant_gelu_requant ({launches})")
    _release()
    t1 = time.perf_counter()
    print(f"repairs: {_check_repairs()}; {time.perf_counter() - t1:.3f} s", flush=True)
    _release()
    print(f"examples phase: {time.perf_counter() - t0:.3f} s; launches {launches}",
          flush=True)
    return launches


class _PhaseClock:
    """Seconds since the last mark, kept in PHASE_SECONDS under each
    mark's name and printed with the script's seconds so far."""

    def __init__(self) -> None:
        self.start = self.last = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        PHASE_SECONDS[name] = round(now - self.last, 3)
        print(f"phase seconds: {name} {now - self.last:.3f} s (script "
              f"{now - self.start:.3f} s)", flush=True)
        self.last = now


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

    clock = _PhaseClock()
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
    clock.mark("build and kernel checks")

    with tempfile.TemporaryDirectory() as tmp:
        launches = run_detection(ep, tmp)
        run_classification(tmp)
        by_phase = run_headline(tmp, counters)
    by_phase.update({"ssd": dict(launches),
                     "deeplab fused": {"segment_colorize": run_segmentation(ep)},
                     "deeplab batched": {"segment_colorize": run_batched_segmentation(ep)}})
    run_pose()
    by_phase["gpu_smoke"] = run_gpu_smoke(counters)
    clock.mark("vision pipelines")
    params = _lm_params()
    by_phase["lm serving float32"] = run_lm_serving(params, "float32", counters)
    by_phase["lm serving w8a8"] = run_lm_serving(quantize_lm_params(params), "w8a8",
                                                 counters)
    by_phase["lm paged float32"] = run_lm_paged(params, "float32", counters)
    by_phase["lm paged w8a8"] = run_lm_paged(quantize_lm_params(params), "w8a8", counters)
    clock.mark("lm serving and paged")
    with tempfile.TemporaryDirectory() as tmp:
        by_phase["multi-tenant"] = run_multitenant(params, counters, tmp)
    clock.mark("multi-tenant")
    qparams = quantize_lm_params(params)
    by_phase.update(run_obs(qparams, counters))
    clock.mark("obs")
    by_phase.update(run_obs_layers(qparams, counters))
    clock.mark("obs layers")
    del qparams
    _release()
    del params
    by_phase["lm flash prefill"] = run_flash_prefill(counters, torch.bfloat16)
    by_phase["lm flash prefill float32"] = run_flash_prefill(counters, torch.float32)
    run_filter_options()
    by_phase["repo_lstm"] = run_repo_lstm(counters)
    clock.mark("flash prefill, filter options, repo_lstm")
    by_phase.update(run_query(counters))
    clock.mark("query")
    by_phase.update(run_fleet(counters))
    clock.mark("fleet")
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
    clock.mark("crop, stream elements, media, interop, custom filters, train")
    _release()
    counters.reset()
    with tempfile.TemporaryDirectory() as tmp:
        run_convnets(tmp)
    run_stream_pipeline()
    by_phase["convnets, stream transformer pipeline"] = counters.read()
    _release()
    clock.mark("convnets, stream transformer pipeline")
    by_phase["model files: restored ssd"] = run_model_files(counters)
    tflite = run_tflite(counters)
    by_phase["tflite ssd"] = tflite["launches"]
    clock.mark("model files, tflite")
    by_phase.update(run_parallel(counters))
    clock.mark("parallel")
    by_phase["examples"] = run_examples(counters)
    clock.mark("examples")
    print(f"card, beside the numbers below: {_card()}", flush=True)
    print(f"launches by path: {json.dumps(by_phase)}", flush=True)
    print(f"graphs by path: {json.dumps(GRAPH_PATHS)}", flush=True)
    print(f"stream paths: {json.dumps(LOOP_STATS)}", flush=True)
    print(f"seconds by phase: {json.dumps(PHASE_SECONDS)}", flush=True)
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
