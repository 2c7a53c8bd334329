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
exit) and --profile-dump PATH. The JAX CLI's flags whose layers the port
has not reached are refused, naming the ROADMAP item that brings each:
--diag, --quality, --quality-record, --slo, --tune (§A7), --deadline-ms,
--fallback, --backends, --hedge-ms (§A8), --obs-push, --obs-aggregate,
--autoscale, --checkpoint-dir, --checkpoint-interval, --role, --disagg
(§A9).

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

#: the JAX CLI's flags whose layers the port has not reached yet, and the
#: ROADMAP item that brings each back; each is refused
_REFUSED_FLAGS = {
    "--diag": "obs/diag (ROADMAP §A7)",
    "--quality": "obs/quality (ROADMAP §A7)",
    "--quality-record": "obs/quality (ROADMAP §A7)",
    "--slo": "obs/slo.py (ROADMAP §A7)",
    "--tune": "tune/ (ROADMAP §A7)",
    "--deadline-ms": "resilience/ and query/ (ROADMAP §A8)",
    "--fallback": "resilience/ and query/ (ROADMAP §A8)",
    "--backends": "query/router.py (ROADMAP §A8)",
    "--hedge-ms": "query/router.py (ROADMAP §A8)",
    "--obs-push": "obs/fleet.py (ROADMAP §A9)",
    "--obs-aggregate": "obs/fleet.py (ROADMAP §A9)",
    "--autoscale": "fleet/ (ROADMAP §A9)",
    "--checkpoint-dir": "fleet/checkpoint.py (ROADMAP §A9)",
    "--checkpoint-interval": "fleet/checkpoint.py (ROADMAP §A9)",
    "--role": "serving/disagg.py (ROADMAP §A9)",
    "--disagg": "serving/disagg.py (ROADMAP §A9)",
}


def _normalize_argv(argv):
    """Move a bare ``--profile``/``--watchdog``/``--sched`` to the end of
    argv when the token that would follow it at parse time is not its
    numeric value, so ``--sched '<pipeline>'`` parses the pipeline as the
    positional (argparse otherwise consumes it for the flag and dies on
    ``invalid int value``). Scans right-to-left so chained bare flags
    compose. A trailing flag with nothing after it takes its ``const``
    default."""
    out, deferred = [], []
    for tok in reversed(argv):
        if tok in _BARE_OK_FLAGS and out and not out[0].startswith("-"):
            try:
                float(out[0])
            except ValueError:
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
                         "(needs --profile)")
    for flag in _REFUSED_FLAGS:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
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
    for flag, layer in _REFUSED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} waits for the port of {layer}")
    if not args.pipeline:
        ap.error("pipeline description required")
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

    from .core.hw import resolve_device
    from .graph import Pipeline
    from .graph.parse import parse_pipeline

    device = resolve_device(args.device)  # no card: raises for cuda
    try:
        p = parse_pipeline(args.pipeline, Pipeline(device=device))
    except Exception as e:  # noqa: BLE001 — CLI reports, never tracebacks
        print(f"ERROR: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
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
    if args.trace or args.profile is not None:
        # like metrics: on BEFORE p.start() so the element chains get the
        # span-opening wrap (--profile implies tracing: the Perfetto host
        # lanes come from pipeline.element spans)
        from .obs import tracing

        tracing.enable()
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
    t0 = time.monotonic()
    try:
        p.start()
    except Exception as e:  # noqa: BLE001
        print(f"ERROR: {type(e).__name__}: {e}", file=sys.stderr)
        if sched_engine is not None:
            from . import sched

            sched.uninstall()
        if exporter is not None:
            exporter.close()
        return 1
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
        p.stop()
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
                print(f"kv[{eng._engine_label}]: "
                      f"prefix_hit_rate {hr:.3f} "
                      f"({kv['hit_tokens']}/{kv['prompt_tokens']} tokens), "
                      f"pages_peak {kv['pages_peak']}, "
                      f"imported {kv['imported_pages']}, "
                      f"exported {kv['exported_pages']}, "
                      f"spilled {kv['spilled_pages']}", file=sys.stderr)
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
