"""The operational CLI: the reference's ``ParallelWrapperMain`` (load a
model file, build a data iterator from a factory, train it under
ParallelWrapper with arg-controlled workers and averaging, save the
result, optionally post stats to a UI) and the observability tools.

Counterpart of ``deeplearning4j_tpu/main.py``, with its flags (the
reference's camelCase, ``--modelPath``, beside the kebab-case where it
has them)::

    python -m deeplearning4j_torch train \\
        --model-path model.zip --model-output-path trained.zip \\
        --data mnist --epochs 2 --averaging-frequency 1 --report-score

- ``--device`` (``train`` and ``cache``; default ``cuda``) is where the
  model is built and trained. Without a card, ``cuda`` raises as every
  entry point of the port does; ``--device cpu`` trains on a one-slot CPU
  mesh.
- ``--workers`` is advisory: the mesh spans every visible card (one slot
  on the CPU), and a different count only prints a note.
- ``--data`` names a built-in dataset (mnist/emnist/iris/cifar), or
  ``--data-factory module:callable`` imports a factory returning a
  DataSetIterator (the reference's ``dataSetIteratorFactoryClazz``).
- ``--coordinator host:port --num-processes N --process-id i`` forms the
  process group first (``parallel.initialize_distributed``: NCCL on the
  card, gloo on the CPU); only rank 0 writes the trained zip.
- ``--stats-file`` records a StatsListener's reports (JSON lines) that
  ``serve-ui`` serves; ``--ui-url`` posts them to a running UI server.
- ``monitor``, ``incident show`` and ``cache`` read this process's or a
  server's monitor planes, an incident bundle, and the kernel-library
  cache.
"""
from __future__ import annotations

import argparse
import sys


def _factory(spec: str):
    """``module:callable`` -> the callable's return value."""
    mod, _, fn = spec.partition(":")
    if not fn:
        raise SystemExit(f"--data-factory needs module:callable, got {spec!r}")
    import importlib
    return getattr(importlib.import_module(mod), fn)()


def _builtin_data(name: str, batch_size: int, num_examples=None, train: bool = True):
    from .datasets.impl import (CifarDataSetIterator, EmnistDataSetIterator,
                                IrisDataSetIterator, MnistDataSetIterator)
    name = name.lower()
    if name == "mnist":
        return MnistDataSetIterator(batch_size, num_examples, train=train)
    if name.startswith("emnist"):
        # emnist or emnist-<split> (balanced/byclass/bymerge/digits/letters)
        split = name.partition("-")[2] or "balanced"
        return EmnistDataSetIterator(split, batch_size, num_examples, train=train)
    if name == "iris":
        return IrisDataSetIterator(batch_size, num_examples or 150)
    if name == "cifar":
        return CifarDataSetIterator(batch_size, num_examples, train=train)
    raise SystemExit(f"unknown --data {name!r} (mnist/emnist/iris/cifar, "
                     f"or use --data-factory module:callable)")


def _add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="where the model is built: cuda (the default; raises without a "
                        "card) or cpu")


def _add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--model-path", "--modelPath", required=True,
                   help="model to train: DL4J zip, Keras .h5, or config JSON "
                        "(ModelGuesser sniffs the format)")
    p.add_argument("--model-output-path", "--modelOutputPath", required=True,
                   help="where the trained model zip is written")
    p.add_argument("--data", default=None, help="built-in dataset: mnist/emnist/iris/cifar")
    p.add_argument("--data-factory", "--dataSetIteratorFactory", default=None,
                   help="module:callable returning a DataSetIterator")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--num-examples", type=int, default=None,
                   help="cap the built-in dataset size")
    p.add_argument("--workers", type=int, default=None,
                   help="advisory; the mesh spans every visible card")
    p.add_argument("--prefetch-size", "--prefetchSize", type=int, default=16)
    p.add_argument("--averaging-frequency", "--averagingFrequency", type=int, default=1)
    p.add_argument("--report-score", "--reportScore", action="store_true")
    p.add_argument("--no-average-updaters", dest="average_updaters",
                   action="store_false", default=True)
    p.add_argument("--mode", choices=("averaging", "shared_gradients"), default="averaging")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3-style sharded parameter and updater storage")
    p.add_argument("--weight-update-sharding", action="store_true",
                   help="ZeRO-1-style sharded updater state")
    p.add_argument("--ui-url", "--uiUrl", default=None,
                   help="host:port of a UI server to post stats to")
    p.add_argument("--stats-file", default=None,
                   help="write training stats to this JSON-lines file (serve it later with "
                        "`serve-ui`)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    _add_device_arg(p)


def cmd_train(args) -> int:
    import torch

    from . import resolve_device
    from .optimize.listeners import ScoreIterationListener
    from .parallel import ParallelWrapper, TrainingMode, initialize_distributed, is_chief
    from .utils.model_guesser import ModelGuesser
    from .utils.model_serializer import ModelSerializer

    dev = resolve_device(args.device)
    if args.coordinator:
        initialize_distributed(args.coordinator, num_processes=args.num_processes,
                               process_id=args.process_id,
                               backend="gloo" if dev.type == "cpu" else None)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if args.workers and args.workers != n_dev:
        print(f"# --workers {args.workers} is advisory: the mesh has {n_dev} devices and "
              f"all of them train", file=sys.stderr)

    # the data first: a bad --data fails before the model loads
    if args.data and args.data_factory:
        raise SystemExit("--data and --data-factory are mutually exclusive "
                         "(the factory would silently win)")
    data = (_factory(args.data_factory) if args.data_factory
            else _builtin_data(args.data or "mnist", args.batch_size, args.num_examples))

    net = ModelGuesser.load_model_guess(args.model_path, device=dev)

    listeners = []
    if args.report_score:
        listeners.append(ScoreIterationListener(1))
    if args.ui_url or args.stats_file:
        from .ui import FileStatsStorage, RemoteUIStatsStorageRouter, StatsListener
        if args.ui_url:
            url = args.ui_url if "://" in args.ui_url else f"http://{args.ui_url}"
            listeners.append(StatsListener(RemoteUIStatsStorageRouter(url)))
        if args.stats_file:
            listeners.append(StatsListener(FileStatsStorage(args.stats_file)))
    if listeners:
        net.set_listeners(*listeners)

    if not args.average_updaters:
        # the reference's knob has no seam here: local SGD averages the
        # updater state with the parameters at every averaging round
        print("# --no-average-updaters has no effect: updater averaging is fused into the "
              "step", file=sys.stderr)
    mode = (TrainingMode.SHARED_GRADIENTS if args.mode == "shared_gradients"
            else TrainingMode.AVERAGING)
    b = (ParallelWrapper.Builder(net)
         .training_mode(mode)
         .averaging_frequency(args.averaging_frequency)
         .prefetch_buffer(args.prefetch_size))
    if args.device != "cuda":
        b = b.devices([dev])          # a one-slot mesh on the named device
    if args.report_score:
        b = b.report_score_after_averaging()
    if args.fsdp:
        b = b.fsdp()
    if args.weight_update_sharding:
        b = b.weight_update_sharding()
    pw = b.build()
    try:
        pw.fit(data, epochs=args.epochs)
    finally:
        for lst in listeners:
            close = getattr(getattr(lst, "storage", None), "close", None)
            if close is not None:
                close()
    if args.fsdp or args.weight_update_sharding:
        pw.gather_model()
    if is_chief():
        ModelSerializer.write_model(net, args.model_output_path, save_updater=True)
        print(f"model written to {args.model_output_path} (last score {pw.last_score})")
    return 0


def cmd_serve_ui(args, block: bool = True) -> int:
    """Serve the training UI over ``--stats-file`` (or an empty in-memory
    storage that ``/remote`` fills); ``block=False`` returns the bound
    port and leaves the server to the caller."""
    import time

    from .ui import FileStatsStorage, InMemoryStatsStorage, UIServer
    storage = FileStatsStorage(args.stats_file) if args.stats_file else InMemoryStatsStorage()
    server = UIServer.get_instance()
    server.attach(storage)
    host = getattr(args, "host", None) or "127.0.0.1"
    port = server.start(args.port, host=host)
    print(f"training UI on http://{host}:{port}", flush=True)
    if not block:
        return port
    try:
        while True:                   # serve_forever runs on the server's thread
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


def cmd_monitor(args) -> int:
    """A snapshot of the monitor planes: a server's (``--url``: its
    ``/metrics`` and ``/healthz``, or one route per flag) or this
    process's own. ``--trace-out`` writes the Chrome trace too;
    ``--fleet``, ``--events``, ``--profile``, ``--alerts``, ``--control``,
    ``--history``, ``--probes`` and ``--incidents`` print one plane each
    (text, or JSON with ``--format json``); ``--collect LABEL=URL[,...]``
    runs one scrape of those ``/telemetry`` targets into a private fleet
    table and prints the merged view (exit 1 when a scrape failed)."""
    import json
    import urllib.error
    import urllib.request

    def _fetch(base, path):
        try:
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.read().decode("utf-8")
        except urllib.error.HTTPError as e:
            # /healthz answers 503 WITH a body when unhealthy — still a dump
            return e.read().decode("utf-8")

    base = None
    if args.url:
        base = args.url if "://" in args.url else f"http://{args.url}"
        base = base.rstrip("/")

    if args.collect:
        # one scrape tick into a private fleet table (the daemon form is
        # TelemetryCollector.start in a serving process)
        from .monitor.collector import TelemetryCollector
        from .monitor.fleet import FleetState
        collector = TelemetryCollector(fleet=FleetState())
        for spec in args.collect.split(","):
            spec = spec.strip()
            if not spec:
                continue
            label, sep, url = spec.partition("=")
            if not sep:
                # bare URL: derive the label from host:port
                url = spec
                label = (url.split("://", 1)[-1].rstrip("/")
                         .replace("/", "_"))
            collector.add_target(label.strip(), url.strip())
        summary = collector.tick()
        for label, err in sorted(summary.get("errors", {}).items()):
            print(f"# scrape {label} FAILED: {err}", file=sys.stderr)
        if args.format == "json":
            print(json.dumps({"targets": collector.snapshot(),
                              "liveness": collector.fleet.liveness()},
                             indent=2, default=repr))
        else:
            from .monitor import render_prometheus_dump
            print(render_prometheus_dump(collector.fleet_dump()), end="")
        return 0 if not summary.get("errors") else 1

    if args.profile:
        # the step anatomy: first calls, device memory, step/ETL split
        if base:
            if args.format == "json":
                print(json.dumps(json.loads(_fetch(base, "/profile")),
                                 indent=2))
            else:
                print(_fetch(base, "/profile?format=text"), end="")
        else:
            from .monitor import profile_report, render_profile_text
            rep = profile_report()
            if args.format == "json":
                print(json.dumps(rep, indent=2))
            else:
                print(render_profile_text(rep), end="")
        return 0

    if args.alerts:
        # alert-rule states: one line per rule in text mode, the full
        # /alerts JSON with --format json; exit 0 either way (the alert
        # is the GAUGE's job — a monitoring dump must stay scriptable)
        if base:
            doc = json.loads(_fetch(base, "/alerts"))
        else:
            from .monitor import get_alert_engine
            engine = get_alert_engine()
            engine.evaluate(strict=False)
            doc = engine.snapshot()
        if args.format == "json":
            print(json.dumps(doc, indent=2))
        else:
            rows = doc.get("alerts", [])
            if not rows:
                print("# no alert rules registered")
            for r in rows:
                print(f"{r['state']:<8} {r['rule']:<36} "
                      f"value={r.get('value')} {r.get('detail', '')}"
                      + (f" exemplar={r['exemplar_trace_id']}"
                         if r.get("exemplar_trace_id") else ""))
            if doc.get("firing"):
                print(f"# FIRING: {', '.join(doc['firing'])}")
        return 0

    if args.control:
        # control-plane view: policy state machines + recent actuator
        # invocations (/control remotely — docs/CONTROL.md runbook)
        if base:
            doc = json.loads(_fetch(base, "/control"))
        else:
            from .control import get_control_plane
            doc = get_control_plane().snapshot()
        if args.format == "json":
            print(json.dumps(doc, indent=2))
        else:
            rows = doc.get("policies", [])
            if not rows:
                print("# no control policies registered")
            for r in rows:
                trig = ", ".join(r.get("rules") or []) or r.get("event")
                print(f"{r['state']:<10} {r['policy']:<28} "
                      f"on={trig} fired={r.get('fired_count', 0)} "
                      f"suppressed={r.get('suppressed_count', 0)} "
                      f"cooldown_remaining="
                      f"{round(r.get('cooldown_remaining_s', 0.0), 1)}s")
            for a in doc.get("actions", []):
                print(f"# action {a.get('policy')}/{a.get('action')} "
                      f"outcome={a.get('outcome')} rule={a.get('rule')}"
                      + (f" exemplar={a['exemplar_trace_id']}"
                         if a.get("exemplar_trace_id") else ""))
            if doc.get("cooldowns_active"):
                print("# COOLDOWN: "
                      + ", ".join(doc["cooldowns_active"]))
        return 0

    if args.probes:
        # probe-plane view: per-target last outcome / consecutive
        # failures / deadman age (/probes remotely —
        # docs/OBSERVABILITY.md "Probe plane")
        if base:
            doc = json.loads(_fetch(base, "/probes"))
        else:
            from .monitor import get_prober
            doc = get_prober().snapshot()
        if args.format == "json":
            print(json.dumps(doc, indent=2))
        else:
            rows = doc.get("targets", {})
            if not rows:
                print("# no probe targets configured")
            for label, r in sorted(rows.items()):
                age = r.get("last_success_age_s")
                print(f"{(r.get('last_outcome') or 'never'):<10} "
                      f"{label:<24} model={r.get('model')} "
                      f"golden={r.get('golden_version')} "
                      f"fails={r.get('consecutive_failures', 0)} "
                      f"last_success_age="
                      f"{round(age, 1) if age is not None else '-'}s"
                      + (f" trace={r['last_trace_id']}"
                         if r.get("last_trace_id") else ""))
            print(f"# running={doc.get('running')} "
                  f"interval={doc.get('interval_s')}s "
                  f"fail_threshold={doc.get('fail_threshold')}")
        return 0

    if args.incidents:
        # incident-plane view: one line per merged incident — status,
        # member rules, capture count, persisted bundle path
        # (/incidents remotely — docs/OBSERVABILITY.md "Incident plane")
        if base:
            doc = json.loads(_fetch(base, "/incidents"))
        else:
            from .monitor import get_incident_recorder
            doc = get_incident_recorder().snapshot()
        if args.format == "json":
            print(json.dumps(doc, indent=2))
        else:
            rows = doc.get("incidents", [])
            if not rows:
                print("# no incidents recorded")
            for r in rows:
                print(f"{r['status']:<9} {r['id']:<10} "
                      f"rules={','.join(r.get('rules') or []) or '-'} "
                      f"captures={r.get('captures', 0)} "
                      f"events={r.get('flight_events', 0)}"
                      + (f" bundle={r['path']}" if r.get("path") else ""))
            print(f"# open={','.join(doc.get('open') or []) or 'none'} "
                  f"evicted={doc.get('evicted', 0)} "
                  f"running={doc.get('running')}")
        return 0

    if args.history:
        # metric-history ring meta (the per-series view is the HTTP
        # endpoint's ?metric= job — a terminal wants the shape, not
        # thousands of points)
        if base:
            doc = json.loads(_fetch(base, "/history"))
        else:
            from .monitor import get_history
            doc = get_history().describe()
        print(json.dumps(doc, indent=2))
        return 0

    if args.events:
        # flight-recorder view: one JSON object per line (JSONL — the same
        # shape the on-disk halt/crash dumps use, so tooling reads both)
        if base:
            events = json.loads(_fetch(base, "/events"))["events"]
        else:
            from .monitor import get_flight_recorder
            events = get_flight_recorder().events()
        for rec in events:
            print(json.dumps(rec, default=repr))
        return 0

    if args.fleet:
        # aggregated per-worker view: only meaningful where OP_TELEMETRY
        # reports land (the paramserver-server process, or --url to it)
        if args.format == "json":
            payload = (_fetch(base, "/fleet?format=json") if base
                       else None)
            if payload is None:
                from .monitor import get_fleet
                doc = get_fleet().liveness()
            else:
                doc = json.loads(payload)
            print(json.dumps(doc, indent=2))
        else:
            if base:
                print(_fetch(base, "/fleet"), end="")
            else:
                from .monitor import get_fleet
                print(get_fleet().render_prometheus(), end="")
        return 0

    if base:
        metrics_text = _fetch(base, "/metrics")
        health = json.loads(_fetch(base, "/healthz"))
        trace = _fetch(base, "/trace") if args.trace_out else None
    else:
        from .monitor import get_registry, get_health, get_tracer
        metrics_text = get_registry().render_prometheus()
        health = get_health().snapshot()
        trace = (json.dumps(get_tracer().export())
                 if args.trace_out else None)

    if args.format == "json":
        from .monitor import get_registry
        out = {"health": health}
        if args.url:
            out["metrics_text"] = metrics_text
        else:
            out["metrics"] = get_registry().snapshot()
        print(json.dumps(out, indent=2))
    else:
        print(metrics_text, end="")
        print("# health " + json.dumps(health))
    if args.trace_out and trace is not None:
        with open(args.trace_out, "w") as fh:
            fh.write(trace)
        print(f"# trace written to {args.trace_out}", file=sys.stderr)
    return 0


def cmd_incident(args) -> int:
    """``incident show <path>``: load a persisted ``.dl4jinc`` bundle (its
    content address checked against the file name) and render its merged
    timeline, or print it as JSON."""
    import json

    from .monitor.incidents import load_bundle, render_incident_text
    try:
        bundle = load_bundle(args.path)
    except (OSError, ValueError) as e:
        print(f"incident show: cannot load {args.path}: {e}", file=sys.stderr)
        return 1
    if args.format == "json":
        print(json.dumps(bundle, indent=2, default=repr))
    else:
        print(render_incident_text(bundle))
    return 0


def cmd_cache(args) -> int:
    """The compile plane (``compilecache/``):

    - ``--stats`` (the default): the cache directory's census: kernel
      libraries, warmup artifacts, bytes, and this process's hits and
      misses;
    - ``--gc``: list the libraries built under another toolkit, flags or
      architecture and the artifacts whose runtime fingerprint differs or
      that cannot be read; ``--apply`` deletes them;
    - ``--export``: a warmup artifact of a model file (``--model-path``,
      ``--input-shape``, ``--out``; ``--buckets``, ``--precision``,
      ``--name``), built on ``--device``; a replica loads it with
      ``register(..., warmup_artifact=path)``.

    The directory is ``--dir``, else ``DL4J_TPU_COMPILE_CACHE_DIR``."""
    import json

    from .compilecache import cache_stats, gc_cache

    if args.export:
        if not (args.model_path and args.input_shape and args.out):
            raise SystemExit("cache --export needs --model-path, --input-shape and --out")
        from .serving.registry import ServedModel
        from .utils.model_guesser import ModelGuesser
        net = ModelGuesser.load_model_guess(args.model_path, device=args.device)
        shape = tuple(int(d) for d in args.input_shape.split(",") if d.strip())
        kw = {}
        if args.buckets:
            kw["batch_buckets"] = tuple(int(b) for b in args.buckets.split(",") if b.strip())
        served = ServedModel(args.name, net, device=args.device, input_shape=shape,
                             precision=args.precision, **kw)
        try:
            path = served.export_warmup(args.out)
        finally:
            served.close(drain=False)
        print(path)
        return 0
    if args.gc:
        print(json.dumps(gc_cache(args.dir, dry_run=not args.apply), indent=2))
        return 0
    print(json.dumps(cache_stats(args.dir), indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deeplearning4j_torch",
                                description="DL4J operational entry points on PyTorch/CUDA")
    sub = p.add_subparsers(dest="command", required=True)
    t = sub.add_parser("train", help="ParallelWrapperMain: train a model file over every card")
    _add_train_args(t)
    t.set_defaults(fn=cmd_train)
    s = sub.add_parser("serve-ui", help="serve the training UI")
    s.add_argument("--stats-file", default=None)
    s.add_argument("--port", type=int, default=9000)
    s.add_argument("--host", default="127.0.0.1",
                   help="bind address (0.0.0.0 to allow remote scrapes)")
    s.set_defaults(fn=cmd_serve_ui)
    m = sub.add_parser("monitor", help="dump a metrics/health snapshot (this process or a "
                                       "running server's routes)")
    m.add_argument("--url", default=None, metavar="HOST:PORT",
                   help="read a running server instead of this process")
    m.add_argument("--format", choices=("prometheus", "json"), default="prometheus")
    m.add_argument("--trace-out", default=None, metavar="PATH",
                   help="also write the Chrome trace-event JSON here")
    m.add_argument("--fleet", action="store_true",
                   help="the merged per-worker view (/fleet); the liveness table with "
                        "--format json")
    m.add_argument("--events", action="store_true",
                   help="the flight recorder's events as JSON lines")
    m.add_argument("--profile", action="store_true",
                   help="the step anatomy: first calls, device memory, step/ETL split")
    m.add_argument("--alerts", action="store_true",
                   help="alert-rule states (OK/PENDING/FIRING), one line a rule")
    m.add_argument("--control", action="store_true",
                   help="control-plane policy states and recent actions, one line a policy")
    m.add_argument("--history", action="store_true",
                   help="the metric-history ring's meta (/history)")
    m.add_argument("--probes", action="store_true",
                   help="the probe plane's targets, one line a target")
    m.add_argument("--incidents", action="store_true",
                   help="the incident recorder's table, one line an incident")
    m.add_argument("--collect", default=None, metavar="LABEL=URL[,...]",
                   help="one scrape of each target's /telemetry, printed merged; bare URLs "
                        "get host:port labels")
    m.set_defaults(fn=cmd_monitor)
    inc = sub.add_parser("incident", help="render a persisted .dl4jinc incident bundle")
    inc.add_argument("action", choices=("show",), help="show: render one bundle")
    inc.add_argument("path", help="path to a .dl4jinc bundle file")
    inc.add_argument("--format", choices=("text", "json"), default="text",
                     help="text: the timeline; json: the verified bundle")
    inc.set_defaults(fn=cmd_incident)
    c = sub.add_parser("cache", help="the kernel-library cache's stats and GC, and warmup "
                                     "artifact export")
    c.add_argument("--dir", default=None, metavar="PATH",
                   help="cache directory (default: DL4J_TPU_COMPILE_CACHE_DIR)")
    c.add_argument("--stats", action="store_true", help="directory census (the default)")
    c.add_argument("--gc", action="store_true",
                   help="list stale libraries and artifacts; delete them with --apply")
    c.add_argument("--apply", action="store_true", help="with --gc: delete")
    c.add_argument("--export", action="store_true",
                   help="export a warmup artifact of a model file (needs --model-path, "
                        "--input-shape, --out)")
    c.add_argument("--model-path", default=None,
                   help="model to export: DL4J zip, Keras .h5, or config JSON")
    c.add_argument("--name", default="model", help="served-model name in the artifact")
    c.add_argument("--input-shape", default=None, metavar="D0[,D1...]",
                   help="per-example trailing shape, e.g. 784 or 200,80")
    c.add_argument("--buckets", default=None, metavar="B0[,B1...]",
                   help="batch buckets (default: the serving default set)")
    c.add_argument("--precision", choices=("f32", "bf16"), default="f32")
    c.add_argument("--out", default=None, metavar="PATH",
                   help="a directory (content-addressed name) or a file path")
    _add_device_arg(c)
    c.set_defaults(fn=cmd_cache)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
