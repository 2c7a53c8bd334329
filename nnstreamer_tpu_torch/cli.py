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
bare; presets ``NAME:W[:PRIO][,...]``). The JAX CLI's observability,
query, fleet, resilience and serving-role flags wait for their layers and
are refused.

Exit codes: 0 at EOS, 1 on a parse, negotiation or runtime error, 2 when
the timeout passes before EOS.
"""

from __future__ import annotations

import argparse
import sys
import time

#: flags taking an optional numeric value (nargs="?"): a bare form must not
#: swallow a following pipeline positional, which argparse would otherwise
#: consume before type conversion rejects it
_BARE_OK_FLAGS = ("--sched",)


def _normalize_argv(argv):
    """Move a bare ``--sched`` to the end of argv when the token that would
    follow it at parse time is not its numeric value, so ``--sched
    '<pipeline>'`` parses the pipeline as the positional (argparse
    otherwise consumes it for the flag and dies on ``invalid int value``).
    A trailing flag with nothing after it takes its ``const`` default."""
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

    from .core.hw import resolve_device
    from .graph import Pipeline
    from .graph.parse import parse_pipeline

    device = resolve_device(args.device)  # no card: raises for cuda
    try:
        p = parse_pipeline(args.pipeline, Pipeline(device=device))
    except Exception as e:  # noqa: BLE001 — CLI reports, never tracebacks
        print(f"ERROR: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
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
    t0 = time.monotonic()
    try:
        p.start()
    except Exception as e:  # noqa: BLE001
        print(f"ERROR: {type(e).__name__}: {e}", file=sys.stderr)
        if sched_engine is not None:
            from . import sched

            sched.uninstall()
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
