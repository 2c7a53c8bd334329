"""nns-launch — gst-launch-1.0 equivalent CLI, on the port.

    python -m nnstreamer_tpu_torch.cli "videotestsrc num-buffers=30 ! \
        tensor_converter ! tensor_filter framework=xla-tpu \
        model=zoo://mobilenet_v2 ! tensor_decoder mode=image_labeling \
        option1=labels.txt ! tensor_sink"

Port of nnstreamer_tpu/cli.py's pipeline runner. Options: -t/--timeout,
-v verbose bus messages, --list-elements, --list-models, --inspect ELEMENT
(gst-inspect-1.0 analog: pads + properties with their defaults, plus the
registered filter frameworks and decoder modes), --device {cuda,cpu}
(default cuda; without a card it raises): the device every element of the
pipeline runs on unless the string names its own, the counterpart of the
JAX package's ``JAX_PLATFORMS``, and --sched[=WIDTH]/--sched-tenants
(multi-tenant device scheduler: one ``sched.DeviceEngine`` coalescing
every pipeline's filter invokes, WIDTH the coalesce cap, default 8 when
bare; presets ``NAME:W[:PRIO][,...]``), and --kv-page-size/--kv-pages
(the paged KV cache of every ``LMEngine`` built during the run, through the
``NNS_LM_KV_PAGE_SIZE``/``NNS_LM_KV_PAGES`` environment; a per-engine KV
summary at exit). Observability as in the JAX CLI: --metrics-port PORT
(``/metrics``, ``/healthz``, ``/readyz`` and the ``/debug`` pages while the
pipeline runs; 0 = ephemeral), --trace (spans; the per-element span report
at exit), --watchdog[=SECS] (the health model and stall watchdog, with the
flight recorder), --events-dump PATH ('-' = stderr), --profile[=N] (the
device-time profiler with an N-record ring; implies --trace; its report at
exit) and --profile-dump PATH, and the layers on them: --slo
TENANT:p99=MS:goodput=R[,...] (per-tenant accounting and burn-rate
objectives; report at exit), --diag[=DIR] (critical-path attribution and
incident debug bundles; implies --trace; read bundles with nns-diag-torch),
--quality[=SPEC] (data-plane tensor stats, drift and LM confidence; report
at exit) with --quality-record PATH (a drift baseline at exit) and
--tune[=STORE] (the autotuner; its report at exit, the store saved).
Offload resilience as in the JAX CLI, applied to every
``tensor_query_client`` of the pipeline: --deadline-ms MS (a per-buffer
deadline budget; expired buffers are shed), --fallback SPEC (the degraded
route when the breaker opens: ``passthrough`` or a local element kind),
--backends HOST:PORT[,...] (routed dispatch over that backend set) and
--hedge-ms MS (hedged dispatch; needs --backends with >= 2 endpoints); a
JSON fault plan in ``NNS_TPU_CHAOS`` is installed for the run
(resilience/chaos.py). The fleet as in the JAX CLI: --obs-push URL|wire
(push this process's snapshots to an aggregator over HTTP or piggybacked
on the query wire), --obs-aggregate (serve the merged fleet on the
exporter; needs --metrics-port), --autoscale MIN:MAX[:policy] (a
reconcile-loop controller over the --backends set), --checkpoint-dir DIR
and --checkpoint-interval S (crash checkpoints of every DisaggWorker built
during the run, through ``NNS_FLEET_CKPT_*``), --role
{prefill,decode,unified} (every LMEngine's disaggregated-serving role,
through ``NNS_LM_ROLE``) and --disagg PREFILL_EPS;DECODE_EPS (the fleet
split, validated and exported as ``NNS_LM_DISAGG``).

Exit codes: 0 at EOS, 1 on a parse, negotiation or runtime error, 2 when
the timeout passes before EOS.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

#: flags taking an optional numeric value (nargs="?"): a bare form must not
#: swallow a following pipeline positional, which argparse would otherwise
#: consume before type conversion rejects it
_BARE_OK_FLAGS = ("--profile", "--watchdog", "--sched")


def _normalize_argv(argv):
    """Move a bare ``--profile``/``--watchdog``/``--sched`` to the end of
    argv when the token that would follow it at parse time is not its
    numeric value, so ``--sched '<pipeline>'`` parses the pipeline as the
    positional (argparse otherwise consumes it for the flag and dies on
    ``invalid int value``). Scans right-to-left so chained bare flags
    compose. A trailing flag with nothing after it takes its ``const``
    default. ``--tune``/``--diag``/``--quality`` take a PATH or SPEC: they
    defer only when the next token is unmistakably the pipeline (it holds
    a ``!``), as in the JAX CLI."""
    out, deferred = [], []
    for tok in reversed(argv):
        if tok in _BARE_OK_FLAGS and out and not out[0].startswith("-"):
            try:
                float(out[0])
            except ValueError:
                deferred.append(tok)
                continue
        if tok in ("--tune", "--diag", "--quality") and out \
                and not out[0].startswith("-") and "!" in out[0]:
            deferred.append(tok)
            continue
        out.insert(0, tok)
    return out + deferred


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nns-launch-torch",
                                 description="Run a textual tensor pipeline")
    ap.add_argument("pipeline", nargs="?", help="pipeline description")
    ap.add_argument("-t", "--timeout", type=float, default=None,
                    help="max seconds to run (default: until EOS)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print bus messages")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="enable metrics and serve /metrics + /healthz on "
                         "this port while the pipeline runs (0 = ephemeral)")
    ap.add_argument("--trace", action="store_true",
                    help="enable span tracing (obs.tracing) for the run and "
                         "print the per-element span report at exit; combine "
                         "with --metrics-port to browse /debug/traces live")
    ap.add_argument("--watchdog", type=float, nargs="?", const=5.0,
                    default=None, metavar="SECS",
                    help="enable the health model + stall watchdog "
                         "(obs.health) with this stall threshold in seconds "
                         "(default 5.0 when given bare); drives real "
                         "/healthz + /readyz verdicts on --metrics-port and "
                         "implies the flight recorder")
    ap.add_argument("--events-dump", metavar="PATH", default=None,
                    help="enable the flight recorder (obs.events) and dump "
                         "the event journal to PATH as JSON lines at exit "
                         "('-' dumps human-readable to stderr)")
    ap.add_argument("--profile", type=int, nargs="?", const=4096,
                    default=None, metavar="N",
                    help="enable the device-time profiler (obs.profile) "
                         "with an N-record ring (default 4096 when given "
                         "bare); implies --trace, serves the Perfetto "
                         "timeline at /debug/profile with --metrics-port, "
                         "and prints the profile report at exit")
    ap.add_argument("--profile-dump", metavar="PATH", default=None,
                    help="write the profiler's (shape, dtype, fusion, "
                         "device) -> cost samples to PATH as JSON at exit "
                         "(the autotuner's training substrate; needs "
                         "--profile)")
    ap.add_argument("--diag", metavar="DIR", nargs="?", const="",
                    default=None,
                    help="enable incident diagnostics (obs.diag): "
                         "critical-path latency attribution at "
                         "/debug/diag/critpath and automatic debug "
                         "bundles (SLO burn, watchdog DEGRADED, quality "
                         "anomaly, cost anomaly) at /debug/bundles, "
                         "written under DIR (default ./.nnstpu-diag); "
                         "implies --trace; inspect bundles offline with "
                         "nns-diag-torch")
    ap.add_argument("--quality", metavar="SPEC", nargs="?", const="",
                    default=None,
                    help="enable data-plane quality telemetry "
                         "(obs.quality): per-tap tensor stats of host-"
                         "resident buffers (a card-resident one counts as "
                         "skipped), PSI drift against a --quality-record "
                         "baseline, NaN-storm / dead-output rules, and LM "
                         "confidence; SPEC is comma-separated key=value "
                         "(taps=chain+filter+decoder+lm, every=N, psi=F, "
                         "fast=SEC, slow=SEC, nan_storm=N, dead_frames=N, "
                         "sample_cap=N, baseline=PATH)")
    ap.add_argument("--quality-record", metavar="PATH", default=None,
                    help="freeze the run's cumulative per-tap sketches to "
                         "PATH as a JSON drift baseline at exit (feed back "
                         "via --quality baseline=PATH; needs --quality)")
    ap.add_argument("--tune", metavar="STORE", nargs="?", const="",
                    default=None,
                    help="enable the autotuner (tune/): flash launch "
                         "configurations, LM chunk/page size and bucket "
                         "rungs resolve from tuned configs instead of "
                         "hand-set defaults; STORE is the JSON store path "
                         "(default $NNSTPU_TUNE_STORE or .nnstpu_tune.json)")
    ap.add_argument("--slo", metavar="TENANT:p99=MS:goodput=R[,...]",
                    default=None,
                    help="enable per-tenant SLO accounting (obs.slo) and "
                         "declare objectives: p99 latency in ms and/or "
                         "goodput ratio in (0,1) per tenant (e.g. "
                         "cam:p99=50:goodput=0.99,lm:goodput=0.9); burn-rate "
                         "breaches flip the tenant's slo:<name> component "
                         "DEGRADED in /healthz, show at /debug/slo, and the "
                         "per-tenant report prints at exit")
    ap.add_argument("--deadline-ms", type=float, default=None, metavar="MS",
                    help="stamp this per-buffer deadline budget on every "
                         "tensor_query_client in the pipeline; expired "
                         "buffers/requests are shed instead of processed "
                         "(resilience.policy)")
    ap.add_argument("--fallback", metavar="SPEC", default=None,
                    help="degraded-mode route for every tensor_query_client "
                         "when its circuit breaker opens: 'passthrough' or "
                         "a local element kind (e.g. tensor_filter)")
    ap.add_argument("--backends", metavar="HOST:PORT[,HOST:PORT...]",
                    default=None,
                    help="route every tensor_query_client across this "
                         "backend set instead of its single host/port: "
                         "per-backend circuit breakers, two-choice "
                         "placement, mid-stream failover (query.router)")
    ap.add_argument("--hedge-ms", type=float, default=None, metavar="MS",
                    help="hedged dispatch for routed clients: duplicate a "
                         "request to a second backend once the observed "
                         "P95 round trip (floored at MS) elapses without "
                         "a response; first result wins (needs --backends "
                         "with >= 2 endpoints)")
    ap.add_argument("--obs-push", metavar="URL", default=None,
                    help="push metric/health/span snapshots to a fleet "
                         "aggregator (obs.fleet): http://host:port for a "
                         "background HTTP pusher, or the literal 'wire' to "
                         "piggyback pushes on this pipeline's query-client "
                         "connection only (no extra thread)")
    ap.add_argument("--obs-aggregate", action="store_true",
                    help="act as the fleet aggregator: accept pushes "
                         "(OBS_PUSH frames + POST /fleet/push) and serve "
                         "the merged fleet /metrics, /healthz, /readyz and "
                         "/debug/fleet; requires --metrics-port")
    ap.add_argument("--autoscale", metavar="MIN:MAX[:policy]", default=None,
                    help="SLO-driven autoscaling over the routed backend "
                         "set (fleet/): a reconcile-loop controller "
                         "scales between MIN and MAX replicas, migrating "
                         "live sessions off drained backends with zero "
                         "stream loss; policy is 'default' or 'priced' "
                         "(needs --backends)")
    ap.add_argument("--checkpoint-dir", metavar="DIR", default=None,
                    help="crash-checkpoint every DisaggWorker built "
                         "during the run: a CheckpointDaemon snapshots "
                         "live sessions (token path + KV pages) into a "
                         "LocalDirStore at DIR, and a crash-restore "
                         "splices the freshest valid snapshot back in "
                         "(sets NNS_FLEET_CKPT_DIR)")
    ap.add_argument("--checkpoint-interval", type=float, default=None,
                    metavar="S",
                    help="seconds between checkpoint passes (default 5; "
                         "sets NNS_FLEET_CKPT_INTERVAL; needs "
                         "--checkpoint-dir)")
    ap.add_argument("--role", choices=("prefill", "decode", "unified"),
                    default=None,
                    help="disaggregated-serving role for every LMEngine "
                         "built during the run (sets NNS_LM_ROLE): "
                         "'prefill' runs prefill only and exports KV "
                         "pages, 'decode' splices imported pages; both "
                         "need --kv-page-size (the page pool is the "
                         "transfer substrate) — serving/disagg.py")
    ap.add_argument("--disagg", metavar="PREFILL_EPS;DECODE_EPS",
                    default=None,
                    help="declare the disaggregated fleet split: two "
                         "comma-separated host:port lists divided by ';' "
                         "(prefill backends, then decode backends); "
                         "validated here and exported as NNS_LM_DISAGG "
                         "for serving.disagg.DisaggClient construction")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device the pipeline runs on (default cuda)")
    ap.add_argument("--list-elements", action="store_true")
    ap.add_argument("--list-models", action="store_true",
                    help="zoo model names usable as model=zoo://<name>")
    ap.add_argument("--inspect", metavar="ELEMENT",
                    help="describe an element: pads, properties, defaults")
    ap.add_argument("--sched", type=int, nargs="?", const=8,
                    default=None, metavar="WIDTH",
                    help="route tensor_filter invokes through the "
                         "multi-tenant device scheduler (sched."
                         "DeviceEngine); WIDTH caps the coalesce "
                         "width per device batch (default 8 when bare)")
    ap.add_argument("--sched-tenants", metavar="NAME:W[:PRIO][,...]",
                    default=None,
                    help="per-tenant admission presets for --sched: "
                         "weight (relative share) and optional strict "
                         "priority class per tenant name; names match "
                         "the pipeline name and serving-engine labels "
                         "(e.g. cam:2,lm:1:1)")
    ap.add_argument("--kv-page-size", type=int, default=None, metavar="TOK",
                    help="enable the paged KV cache on every LMEngine built "
                         "during the run: tokens per page (must divide the "
                         "engine max_len; sets NNS_LM_KV_PAGE_SIZE)")
    ap.add_argument("--kv-pages", type=int, default=None, metavar="N",
                    help="KV page-pool size shared by all slots (sets "
                         "NNS_LM_KV_PAGES; needs --kv-page-size)")
    args = ap.parse_args(_normalize_argv(
        sys.argv[1:] if argv is None else list(argv)))

    if args.list_elements:
        from .graph.element import all_element_names

        for n in all_element_names():
            print(n)
        return 0
    if args.list_models:
        from .models.zoo import model_names

        for n in model_names():
            print(n)
        return 0
    if args.inspect:
        return inspect_element(args.inspect)
    if not args.pipeline:
        ap.error("pipeline description required")
    backend_eps = None
    if args.backends is not None:
        from .query.router import parse_endpoints

        try:
            backend_eps = parse_endpoints(args.backends)
        except ValueError as e:
            ap.error(f"--backends: {e}")
    if args.hedge_ms is not None:
        if backend_eps is None:
            ap.error("--hedge-ms needs --backends (hedging is a routed-"
                     "dispatch feature)")
        if args.hedge_ms <= 0:
            ap.error("--hedge-ms must be > 0")
        if len(backend_eps) < 2:
            ap.error("--hedge-ms needs --backends with >= 2 endpoints "
                     "(a hedge must land on a different backend)")
    autoscale_spec = None
    if args.autoscale is not None:
        if backend_eps is None:
            ap.error("--autoscale needs --backends (the routed backend "
                     "set is the membership the controller scales)")
        from .fleet import parse_autoscale_spec

        try:
            autoscale_spec = parse_autoscale_spec(args.autoscale)
        except ValueError as e:
            ap.error(f"--autoscale: {e}")
    if args.profile is not None and args.profile < 1:
        ap.error("--profile must be >= 1 (ring capacity in records)")
    if args.profile_dump is not None and args.profile is None:
        ap.error("--profile-dump needs --profile (no samples are "
                 "recorded without the profiler)")
    if args.sched is not None and args.sched < 1:
        ap.error("--sched must be >= 1 (max coalesce width)")
    sched_presets = []
    if args.sched_tenants is not None:
        if args.sched is None:
            ap.error("--sched-tenants needs --sched (presets configure "
                     "the device scheduler)")
        for spec in args.sched_tenants.split(","):
            parts = spec.strip().split(":")
            try:
                if len(parts) not in (2, 3) or not parts[0]:
                    raise ValueError
                w = float(parts[1])
                prio = int(parts[2]) if len(parts) == 3 else 0
                if w <= 0:
                    raise ValueError
            except ValueError:
                ap.error(f"--sched-tenants: bad spec {spec!r} "
                         "(want name:weight[:priority], weight > 0)")
            sched_presets.append((parts[0], w, prio))
    slo_objectives = None
    if args.slo is not None:
        from .obs import slo as _slo_mod

        try:
            slo_objectives = _slo_mod.parse_slo_spec(args.slo)
        except ValueError as e:
            ap.error(f"--slo: {e}")
    if args.quality_record is not None and args.quality is None:
        ap.error("--quality-record needs --quality (no stats are "
                 "recorded without the quality layer)")
    if args.quality:
        from .obs import quality as _quality_mod

        try:
            _quality_mod.parse_quality_spec(args.quality)
        except ValueError as e:
            ap.error(f"--quality: {e}")
    if args.kv_pages is not None and args.kv_page_size is None:
        ap.error("--kv-pages needs --kv-page-size (paging is off without "
                 "a page size)")
    if args.kv_page_size is not None:
        if args.kv_page_size < 1:
            ap.error("--kv-page-size must be >= 1")
        if args.kv_pages is not None and args.kv_pages < 1:
            ap.error("--kv-pages must be >= 1")
        # the environment carries them: engines are built deep inside the
        # pipeline's elements, and LMEngine reads NNS_LM_KV_* when it is
        # given no explicit kv_page_size/kv_pages
        os.environ["NNS_LM_KV_PAGE_SIZE"] = str(args.kv_page_size)
        if args.kv_pages is not None:
            os.environ["NNS_LM_KV_PAGES"] = str(args.kv_pages)
    if args.role is not None:
        if args.role != "unified" and args.kv_page_size is None:
            ap.error(f"--role {args.role} needs --kv-page-size (the "
                     "paged KV pool is the page-transfer substrate)")
        os.environ["NNS_LM_ROLE"] = args.role
    if args.disagg is not None:
        from .serving.disagg import parse_disagg_spec

        try:
            parse_disagg_spec(args.disagg)
        except ValueError as e:
            ap.error(f"--disagg: {e}")
        os.environ["NNS_LM_DISAGG"] = args.disagg
    if args.checkpoint_interval is not None:
        if args.checkpoint_dir is None:
            ap.error("--checkpoint-interval needs --checkpoint-dir "
                     "(no daemon runs without a store)")
        if args.checkpoint_interval <= 0:
            ap.error("--checkpoint-interval must be > 0")
    if args.checkpoint_dir is not None:
        # the environment carries them like NNS_LM_*: DisaggWorker reads
        # these at construction and starts its own daemon against a
        # LocalDirStore
        os.environ["NNS_FLEET_CKPT_DIR"] = args.checkpoint_dir
        if args.checkpoint_interval is not None:
            os.environ["NNS_FLEET_CKPT_INTERVAL"] = str(
                args.checkpoint_interval)

    from .core.hw import resolve_device
    from .graph import Pipeline
    from .graph.parse import parse_pipeline

    device = resolve_device(args.device)  # no card: raises for cuda
    try:
        p = parse_pipeline(args.pipeline, Pipeline(device=device))
    except Exception as e:  # noqa: BLE001 — CLI reports, never tracebacks
        print(f"ERROR: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    routed_clients = []
    if args.deadline_ms is not None or args.fallback is not None \
            or backend_eps is not None:
        from .query.client import TensorQueryClient

        clients = [el for el in p.elements.values()
                   if isinstance(el, TensorQueryClient)]
        if backend_eps is not None:
            routed_clients = clients
        if not clients:
            ap.error("--deadline-ms/--fallback/--backends need a "
                     "tensor_query_client in the pipeline")
        for el in clients:
            if args.deadline_ms is not None:
                el.deadline_ms = float(args.deadline_ms)
            if args.fallback is not None:
                el.fallback = args.fallback
            if backend_eps is not None:
                el.backends = [f"{h}:{pt}" for h, pt in backend_eps]
                if args.hedge_ms is not None:
                    el.hedge_ms = float(args.hedge_ms)
    exporter = None
    if args.metrics_port is not None:
        # started (and collection enabled) BEFORE p.start(): the element
        # chains only get instrumented if metrics are on at start time
        from .obs.exporter import start_exporter

        try:
            exporter = start_exporter(port=args.metrics_port)
        except (OSError, RuntimeError) as e:
            print(f"ERROR: metrics exporter: {e}", file=sys.stderr)
            return 1
        print(f"metrics: {exporter.url}", file=sys.stderr)
    if args.obs_aggregate:
        if exporter is None:
            ap.error("--obs-aggregate requires --metrics-port (the "
                     "aggregator serves the fleet on the exporter)")
        # fleet.* push/expiry/conflict events are the aggregator's audit
        # trail — turn the ring on with the role
        from .obs import events, fleet

        events.enable()
        agg = fleet.enable_aggregator()
        print(f"fleet: aggregating as {agg.instance} "
              f"(POST {exporter.url.rsplit('/', 1)[0]}/fleet/push)",
              file=sys.stderr)
    if args.tune is not None:
        # BEFORE --obs-push: the tuner's fleet hooks must be installed
        # when the pusher sends its first doc, so a fresh instance adopts
        # fleet-tuned configs on its first push-ack
        from . import tune as _tune_mod

        tn = _tune_mod.enable(store_path=args.tune or None)
        print(f"tune: autotuner on ({len(tn.store)} stored config(s), "
              f"store {tn.store.path})", file=sys.stderr)
    if args.obs_push is not None:
        from .obs import fleet

        url = None if args.obs_push == "wire" else args.obs_push
        try:
            psh = fleet.enable_push(url=url)
        except ValueError as e:
            print(f"ERROR: --obs-push: {e}", file=sys.stderr)
            if exporter is not None:
                fleet.disable_aggregator()
                exporter.close()
            return 1
        print(f"fleet: pushing as {psh.instance} "
              f"({'query-wire piggyback' if url is None else url})",
              file=sys.stderr)
    if args.trace or args.profile is not None or args.diag is not None:
        # like metrics: on BEFORE p.start() so the element chains get the
        # span-opening wrap (--profile implies tracing: the Perfetto host
        # lanes come from pipeline.element spans; --diag implies tracing:
        # the critical path is computed from spans)
        from .obs import tracing

        tracing.enable()
    if args.diag is not None:
        # AFTER --tune's enable (the trigger engine adopts the tuner's
        # cost model for dispatch-anomaly detection when present) and
        # BEFORE p.start() so the sched/serving taps cover warm-up; events
        # feed the bundle's flight-recorder stanza
        from .obs import diag as _diag_mod
        from .obs import events as _events_mod

        _events_mod.enable()
        deng = _diag_mod.enable(args.diag or None)
        print(f"diag: bundles -> {deng.bundles.directory} "
              "(critpath at /debug/diag/critpath)", file=sys.stderr)
    if args.profile is not None:
        from .obs import profile

        profile.enable(max_records=args.profile)
    sched_engine = None
    if args.sched is not None:
        # before p.start(): the install sets the pipeline scheduler hook,
        # and start() is where a pipeline enrolls its filters
        from . import sched

        sched_engine = sched.install(max_coalesce=args.sched)
        for name, w, prio in sched_presets:
            sched_engine.preset(name, weight=w, priority=prio)
        print(f"sched: {sched_engine.name} multiplexing "
              f"(coalesce<={args.sched})", file=sys.stderr)
    if args.watchdog is not None or args.events_dump is not None:
        # same start-time rule: health components and the event bridge
        # only attach to what is built/started AFTER enable()
        from .obs import events

        events.enable()
        if args.watchdog is not None:
            from .obs import health

            health.enable(stall_after_s=float(args.watchdog))
    if slo_objectives is not None:
        # after health.enable(): set_objective registers one slo:<tenant>
        # component per objective; hooks install process-wide before
        # p.start() so attribution covers warm-up
        from .obs import slo as _slo_mod

        _slo_mod.enable()
        for tenant, obj in slo_objectives.items():
            _slo_mod.set_objective(tenant, **obj)
        print(f"slo: tracking {len(slo_objectives)} objective "
              f"tenant(s): {', '.join(sorted(slo_objectives))}",
              file=sys.stderr)
    if args.quality is not None:
        # BEFORE p.start() so the first frames (and warm-up prefills) are
        # observed; events give the anomaly audit trail. Anomaly →
        # DEGRADED needs --watchdog, anomaly → debug bundle needs --diag
        from .obs import events as _events_mod
        from .obs import quality as _quality_mod

        _events_mod.enable()
        try:
            qeng = _quality_mod.enable(args.quality or None)
        except (OSError, ValueError) as e:
            print(f"ERROR: --quality: {e}", file=sys.stderr)
            return 1
        print(f"quality: data-plane telemetry on (taps: "
              f"{', '.join(sorted(qeng.taps_enabled))})"
              f"{' with drift baseline' if qeng.baseline is not None else ''}",
              file=sys.stderr)
    chaos_plan = None
    if os.environ.get("NNS_TPU_CHAOS"):
        from .resilience import chaos

        chaos_plan = chaos.plan_from_env()
        if chaos_plan is not None:
            chaos.install(chaos_plan)
            print(f"chaos: fault plan installed (seed={chaos_plan.seed}, "
                  f"{len(chaos_plan.faults)} faults)", file=sys.stderr)
    t0 = time.monotonic()
    try:
        p.start()
    except Exception as e:  # noqa: BLE001
        print(f"ERROR: {type(e).__name__}: {e}", file=sys.stderr)
        if chaos_plan is not None:
            chaos.uninstall()
        if sched_engine is not None:
            from . import sched

            sched.uninstall()
        if args.obs_push is not None or args.obs_aggregate:
            from .obs import fleet

            fleet.disable_push()
            fleet.disable_aggregator()
        if exporter is not None:
            exporter.close()
        return 1
    autoscale_ctl = None
    if autoscale_spec is not None:
        # AFTER p.start(): the routed clients build their QueryRouter (the
        # membership the controller scales) at start
        from . import fleet as _fleet_mod
        from .obs import fleet as _obs_fleet

        mn, mx, pol = autoscale_spec
        router = next((el.router for el in routed_clients
                       if el.router is not None), None)
        if router is None:
            print("ERROR: --autoscale: no routed query client came up",
                  file=sys.stderr)
            p.stop()
            if chaos_plan is not None:
                chaos.uninstall()
            return 1
        autoscale_ctl = _fleet_mod.enable(
            router, mn, mx, policy=pol,
            aggregator=_obs_fleet.aggregator(), start=True)
        print(f"fleet: autoscaling {mn}..{mx} replicas (policy {pol})",
              file=sys.stderr)
    try:
        ok = p.wait_eos(args.timeout)
        err = p.bus.error
        if args.verbose:
            while True:
                msg = p.bus.pop()
                if msg is None:
                    break
                print(f"[{msg.type.value}] {msg.source}: {msg.data}",
                      file=sys.stderr)
        if err is not None:
            print(f"ERROR: {err.source}: {err.data.get('text')}", file=sys.stderr)
            return 1
        if not ok:
            # distinct code: "ran but never reached EOS" is not success
            print(f"(stopped after {args.timeout}s timeout)", file=sys.stderr)
            return 2
    finally:
        if autoscale_ctl is not None:
            # BEFORE p.stop(): the controller's reconcile thread acts
            # through the router, which dies with the pipeline
            from . import fleet as _fleet_mod

            st = autoscale_ctl.stats
            print(f"fleet: {st['ticks']} reconcile tick(s), "
                  f"{st['scale_up']} up / {st['scale_in']} in, "
                  f"{st['migrations']} migration(s)", file=sys.stderr)
            _fleet_mod.disable()
        p.stop()
        if chaos_plan is not None:
            # the hooks back to None: main() may run again in-process
            chaos.uninstall()
        if sched_engine is not None:
            # AFTER p.stop(): chain threads must be gone before the
            # dispatch loop dies, or a chain could block on a future
            # nobody resolves until the join timeout
            from . import sched

            cs = sched_engine.coalesce_stats()
            print(f"sched: {sched_engine.stats['batches']} batches / "
                  f"{sched_engine.stats['items']} items, median width "
                  f"{cs['median']:.1f}, occupancy "
                  f"{sched_engine.occupancy():.3f}", file=sys.stderr)
            sched.uninstall()
        if args.kv_page_size is not None:
            # per-engine KV exit summary (prefix_hit_rate is the economic
            # number paging exists for); live_engines() is the weak
            # registry — engines are built deep inside filters and never
            # handed back to the CLI
            from .serving.lm_engine import live_engines

            for eng in live_engines():
                hr = eng.prefix_hit_rate
                kv = eng.kv_stats
                if hr is None or kv is None:
                    continue
                print(f"kv[{eng._engine_label}/{eng.role}]: "
                      f"prefix_hit_rate {hr:.3f} "
                      f"({kv['hit_tokens']}/{kv['prompt_tokens']} tokens), "
                      f"pages_peak {kv['pages_peak']}, "
                      f"imported {kv['imported_pages']}, "
                      f"exported {kv['exported_pages']}, "
                      f"spilled {kv['spilled_pages']}", file=sys.stderr)
        if args.obs_push is not None or args.obs_aggregate:
            from .obs import fleet

            fleet.disable_push()
            fleet.disable_aggregator()
        if exporter is not None:
            exporter.close()
        if args.trace:
            from .obs import tracing

            print(tracing.element_stats_report(), file=sys.stderr)
        if args.profile is not None:
            from .obs import profile

            print(profile.report(), file=sys.stderr)
            if args.profile_dump is not None:
                n = profile.dump_samples(args.profile_dump)
                print(f"profile: {n} cost samples -> "
                      f"{args.profile_dump}", file=sys.stderr)
        if slo_objectives is not None:
            from .obs import slo as _slo_mod

            print(_slo_mod.report(), file=sys.stderr)
            _slo_mod.disable()
        if args.tune is not None:
            from . import tune as _tune_mod

            print(_tune_mod.report(), file=sys.stderr)
            _tune_mod.disable()  # persists the store for the next run
        if args.quality is not None:
            from .obs import quality as _quality_mod

            print(_quality_mod.report(), file=sys.stderr)
            if args.quality_record is not None:
                try:
                    _quality_mod.save_baseline(args.quality_record)
                    print(f"quality: baseline -> {args.quality_record}",
                          file=sys.stderr)
                except OSError as e:
                    print(f"ERROR: --quality-record: {e}",
                          file=sys.stderr)
            _quality_mod.disable()
        if args.diag is not None:
            from .obs import diag as _diag_mod

            deng = _diag_mod.engine()
            if deng is not None:
                ts = deng.triggers.stats
                bundles = deng.bundles.list()
                print(f"diag: {ts['fired']} bundle(s) captured "
                      f"({ts['offered']} trigger(s) offered, "
                      f"{ts['rate_limited']} rate-limited, "
                      f"{ts['deduped']} deduped)", file=sys.stderr)
                for b in bundles[:4]:
                    cause = b.get("cause") or {}
                    print(f"diag:   {b['id']}  cause="
                          f"{cause.get('kind')}:{cause.get('key')}",
                          file=sys.stderr)
                if bundles:
                    print(f"diag: inspect with: nns-diag-torch "
                          f"{deng.bundles.directory}", file=sys.stderr)
            _diag_mod.disable()
        if args.events_dump is not None:
            from .obs import events

            if args.events_dump == "-":
                events.dump(sys.stderr)
            else:
                events.dump_jsonl(args.events_dump)
                print(f"events: {args.events_dump}", file=sys.stderr)
    if args.verbose:
        print(f"ran {time.monotonic() - t0:.2f}s", file=sys.stderr)
    return 0


def inspect_element(name: str) -> int:
    """gst-inspect-1.0 analog: instantiate the element and report its pads
    and settable properties with defaults (properties ARE instance
    attributes here, like GObject props are on the reference elements)."""
    from .graph.element import Element, element_class

    cls = element_class(name)
    if cls is None:
        print(f"unknown element {name!r}", file=sys.stderr)
        return 1
    print(f"{name}  ({cls.__module__}.{cls.__qualname__})")
    doc = (cls.__doc__ or "").strip().splitlines()
    if doc:
        print(f"  {doc[0]}")
    try:
        el = cls()
    except Exception as e:  # noqa: BLE001 — elements requiring props
        print(f"  (cannot instantiate without properties: {e})")
        return 0
    print("  pads:")
    for pad in el.sink_pads:
        print(f"    sink: {pad.name}")
    for pad in el.src_pads:
        print(f"    src:  {pad.name}")
    base = set(dir(Element(name="probe"))) | {"ELEMENT_NAME", "MAX_OPTIONS"}
    print("  properties:")
    for attr in sorted(vars(el)):
        if attr.startswith("_") or attr in base:
            continue
        val = getattr(el, attr)
        if callable(val):
            continue
        print(f"    {attr.replace('_', '-')} = {val!r}")
    from .core.registry import SubpluginType, get_all_subplugins

    if name == "tensor_filter":
        from .filters.base import find_filter

        find_filter("xla-tpu")  # force built-in registration
        print("  frameworks: "
              + ", ".join(sorted(get_all_subplugins(SubpluginType.FILTER))))
    if name == "tensor_decoder":
        from .decoders.base import find_decoder

        find_decoder("image_labeling")
        print("  modes: "
              + ", ".join(sorted(get_all_subplugins(SubpluginType.DECODER))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
