"""zlint of the port (``veles_torch/analysis/``) held against the
reference's (``veles/analysis/``).

Every fixture of the reference's rule tests (``tests/test_analysis.py``,
copied here, not imported) goes through both linters: on the rules both
packages share, the findings are equal as (rule, path, line, severity,
message). The two retargeted rules are held through twins:
``telemetry-hygiene``'s fixtures import ``veles_torch.telemetry`` where
the reference's import ``veles.telemetry``, and each ``tracer-purity``
fixture (an ``xla_run`` reading ``ctx.get(...)`` under ``znicz_tpu/ops``)
has a port twin (a unit body under ``znicz/ops``) that must fire on the
same lines; the port's own cases cover the host syncs of a CUDA-graph
capture. The CLI (exit codes, JSON and SARIF bytes, ``--select``,
``--list-rules``, ``--changed-only``, ``--cache``, ``--stats``) is held
against the reference's CLI on the same inputs, and the gate keeps
``veles_torch/`` and ``chip_smoke.py`` at zero findings. No device
needed: everything here is AST work, apart from the serving repair's
test, which serves a small archive on the CPU.
"""

import builtins
import json
import os
import re
import shutil
import subprocess
import threading

import pytest

from veles.analysis import core as ref_core
from veles.analysis.cli import lint_main as ref_lint_main
from veles_torch.analysis import core as port_core
from veles_torch.analysis import rules_purity
from veles_torch.analysis.cache import AnalysisCache
from veles_torch.analysis.cli import lint_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the 20 rule ids both packages register (pragmas carry over)
RULE_IDS = (
    "bare-except", "checkpoint-state", "lock-order",
    "loop-exception-safety", "probe-purity", "profiler-safety",
    "reactor-purity", "resource-leak", "stats-cadence",
    "telemetry-hygiene", "thread-lifecycle", "tracer-purity",
    "unbounded-cardinality", "unguarded-shared-state", "unsafe-deserialize",
    "untrusted-geometry", "untrusted-path", "unused-import",
    "unused-variable", "wire-schema")

#: the rules whose target the port renamed: their fixtures are twins
RETARGETED = ("tracer-purity", "telemetry-hygiene")

#: every fixture of the reference's rule tests (tests/test_analysis.py),
#: as (case id, selected rules or None for all, ((relpath, source), ...)),
#: in that file's order; the tracer-purity fixtures have their port
#: twins below instead
CASES = (
    ('lock_order_cycle_fires', ('lock-order',), (
        ('mod.py', """\
import threading


class A:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def m1(self):
        with self._a:
            with self._b:
                pass

    def m2(self):
        with self._b:
            with self._a:
                pass
"""),
    )),
    ('lock_order_quiet_on_consistent_order', ('lock-order',), (
        ('mod.py', """\
import threading


class A:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def m1(self):
        with self._a:
            with self._b:
                pass

    def m2(self):
        with self._a:
            with self._b:
                pass
"""),
    )),
    ('lock_order_interprocedural_reentry_1', ('lock-order',), (
        ('mod.py', """\
import threading


class A:
    def __init__(self):
        self._a = threading.Lock()

    def r1(self):
        with self._a:
            self.r2()

    def r2(self):
        with self._a:
            pass
"""),
    )),
    ('lock_order_interprocedural_reentry_2', ('lock-order',), (
        ('mod.py', """\
import threading


class A:
    def __init__(self):
        self._a = threading.RLock()

    def r1(self):
        with self._a:
            self.r2()

    def r2(self):
        with self._a:
            pass
"""),
    )),
    ('lock_order_sees_inside_except_handlers', ('lock-order',), (
        ('mod.py', """\
import threading


class A:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def m1(self):
        try:
            pass
        except Exception:
            with self._a:
                with self._b:
                    pass

    def m2(self):
        with self._b:
            with self._a:
                pass
"""),
    )),
    ('lock_order_multi_item_with_statement_1', ('lock-order',), (
        ('mod.py', """\
import threading


class A:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()

    def m1(self):
        with self.a, self.b:
            pass

    def m2(self):
        with self.b:
            with self.a:
                pass
"""),
    )),
    ('lock_order_multi_item_with_statement_2', ('lock-order',), (
        ('mod.py', """\
import threading


class A:
    def __init__(self):
        self.a = threading.Lock()

    def m1(self):
        with self.a, self.a:
            pass
"""),
    )),
    ('lock_order_resolves_inherited_locks', ('lock-order',), (
        ('mod.py', """\
import threading


class Base:
    def __init__(self):
        self._lock = threading.Lock()


class Child(Base):
    def work(self):
        with self._lock:
            self.helper()

    def helper(self):
        with self._lock:
            pass
"""),
    )),
    ('unguarded_shared_state_fires', ('unguarded-shared-state',), (
        ('mod.py', """\
import threading


class W:
    def __init__(self):
        self._lock = threading.Lock()
        threading.Thread(target=self._work, daemon=True).start()

    def _work(self):
        self.value = 1

    def set_value(self, v):
        self.value = v
"""),
    )),
    ('unguarded_shared_state_sees_except_handler_writes', ('unguarded-shared-state',), (
        ('mod.py', """\
import threading


class W:
    def __init__(self):
        self._lock = threading.Lock()
        threading.Thread(target=self._work, daemon=True).start()

    def _work(self):
        try:
            pass
        except Exception:
            self.value = 1

    def set_value(self, v):
        self.value = v
"""),
    )),
    ('unguarded_shared_state_positional_target', ('unguarded-shared-state',), (
        ('mod.py', """\
import threading


class W:
    def __init__(self):
        self._lock = threading.Lock()
        threading.Thread(None, self._work, daemon=True).start()

    def _work(self):
        self.value = 1

    def set_value(self, v):
        self.value = v
"""),
    )),
    ('unguarded_shared_state_quiet_when_locked', ('unguarded-shared-state',), (
        ('mod.py', """\
import threading


class W:
    def __init__(self):
        self._lock = threading.Lock()
        threading.Thread(target=self._work, daemon=True).start()

    def _work(self):
        with self._lock:
            self.value = 1

    def set_value(self, v):
        with self._lock:
            self.value = v
"""),
    )),
    ('unguarded_shared_state_across_inheritance', ('unguarded-shared-state',), (
        ('mod.py', """\
import threading


class Base:
    def __init__(self):
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        self.x = 1


class Api(Base):
    def set_x(self, v):
        self.x = v
"""),
    )),
    ('unguarded_shared_state_honours_inherited_lock', ('unguarded-shared-state',), (
        ('mod.py', """\
import threading


class Base:
    def __init__(self):
        self._lock = threading.Lock()


class W(Base):
    def __init__(self):
        super().__init__()
        threading.Thread(target=self._work, daemon=True).start()

    def _work(self):
        with self._lock:
            self.value = 1

    def push(self, v):
        with self._lock:
            self.value = v
"""),
    )),
    ('checkpoint_state_fires', ('checkpoint-state',), (
        ('mod.py', """\
class Counter(Unit):
    def run(self):
        self.count = getattr(self, "count", 0) + 1
"""),
    )),
    ('checkpoint_state_quiet_with_get_state_or_pragma_1', ('checkpoint-state',), (
        ('mod.py', """\
class Counter(Unit):
    def run(self):
        self.count = getattr(self, "count", 0) + 1

    def get_state(self):
        return {"count": self.count}
"""),
    )),
    ('checkpoint_state_quiet_with_get_state_or_pragma_2', ('checkpoint-state',), (
        ('mod.py', """\
class Counter(Unit):  # zlint: disable=checkpoint-state (ephemeral demo)
    def run(self):
        self.count = getattr(self, "count", 0) + 1
"""),
    )),
    ('checkpoint_state_inherited_get_state_counts', ('checkpoint-state',), (
        ('mod.py', """\
class Base(Unit):
    def get_state(self):
        return {}


class Derived(Base):
    def run(self):
        self.n = 1
"""),
    )),
    ('telemetry_hygiene_loop_creation_fires_1', ('telemetry-hygiene',), (
        ('mod.py', """\
from veles import telemetry


def hot(n):
    for i in range(n):
        telemetry.counter("veles_x_total", "help").inc()
"""),
    )),
    ('telemetry_hygiene_loop_creation_fires_2', ('telemetry-hygiene',), (
        ('mod.py', """\
from veles import telemetry


def hot(n):
    c = telemetry.counter("veles_x_total", "help")
    for i in range(n):
        c.inc()
"""),
    )),
    ('telemetry_hygiene_formatted_name_in_loop_fires', ('telemetry-hygiene',), (
        ('mod.py', """\
from veles import telemetry


def leak(names):
    for n in names:
        telemetry.counter("veles_%s_total" % n, "help").inc()
"""),
    )),
    ('telemetry_hygiene_sees_registry_handle_style', ('telemetry-hygiene',), (
        ('mod.py', """\
from veles import telemetry


def leak(names):
    reg = telemetry.get_registry()
    for n in names:
        reg.counter("veles_%s_total" % n, "help").inc()
"""),
    )),
    ('telemetry_hygiene_identity_label_fires_1', ('telemetry-hygiene',), (
        ('mod.py', """\
def label_it(fam, obj):
    fam.labels(id(obj)).inc()
"""),
    )),
    ('telemetry_hygiene_identity_label_fires_2', ('telemetry-hygiene',), (
        ('mod.py', """\
def label_it(fam, kind):
    fam.labels(kind).inc()
"""),
    )),
    ('telemetry_hygiene_identity_span_name_fires', ('telemetry-hygiene',), (
        ('mod.py', """\
from veles import telemetry


def serve(tracer, job_id, token):
    with telemetry.span("job-%s" % job_id):
        pass
    with tracer.span(f"req.{token}"):
        pass
    telemetry.tracer.add_complete("j.{}".format(job_id), 0.0, 1.0)
"""),
    )),
    ('telemetry_hygiene_span_identity_in_args_quiet', ('telemetry-hygiene',), (
        ('mod.py', """\
from veles import telemetry


def serve(tracer, job_id, kind):
    with telemetry.span("job.serve", job_id=job_id):
        pass
    telemetry.tracer.add_complete("xla.dispatch.%s" % kind, 0.0, 1.0)


class Unit:
    def run(self, tracer):
        tracer.add_complete("%s.run" % self.name, 0.0, 1.0)
"""),
    )),
    ('telemetry_hygiene_wire_label_fires', ('telemetry-hygiene',), (
        ('mod.py', """\
def count(fam, request):
    fam.labels(request.headers.get("x-veles-tenant")).inc()
    fam.labels(request.headers["x-api-key"]).inc()
    fam.labels("t-%s" % request.body).inc()
"""),
    )),
    ('telemetry_hygiene_wire_label_resolver_quiet', ('telemetry-hygiene',), (
        ('mod.py', """\
def count(fam, table, request):
    fam.labels(table.resolve(request.headers.get("x-tenant"))).inc()
    tenant = table.resolve(request.headers.get("x-tenant"))
    fam.labels(tenant).inc()
"""),
    )),
    ('telemetry_hygiene_wire_label_pragma', ('telemetry-hygiene',), (
        ('mod.py', """\
def count(fam, request):
    fam.labels(request.headers.get("x-t")).inc()  # zlint: disable=telemetry-hygiene (bounded by proxy upstream)
"""),
    )),
    ('telemetry_hygiene_span_rule_ignores_foreign_span', ('telemetry-hygiene',), (
        ('mod.py', """\
def shape(layout, col_id):
    return layout.span("cell-%s" % col_id)
"""),
    )),
    ('thread_lifecycle_fires_without_daemon_or_join', ('thread-lifecycle',), (
        ('mod.py', """\
import threading


def spawn(work):
    t = threading.Thread(target=work)
    t.start()
"""),
    )),
    ('thread_lifecycle_sees_aliased_threading_module_1', ('thread-lifecycle',), (
        ('mod.py', """\
import threading as th


def spawn(work):
    th.Thread(target=work).start()
"""),
    )),
    ('thread_lifecycle_sees_aliased_threading_module_2', ('thread-lifecycle',), (
        ('mod.py', """\
import notthreading


def spawn(work):
    notthreading.Thread(target=work).start()
"""),
    )),
    ('thread_lifecycle_quiet_on_daemon_or_join_1', ('thread-lifecycle',), (
        ('mod.py', """\
import threading


def spawn(work):
    threading.Thread(target=work, daemon=True).start()
"""),
    )),
    ('thread_lifecycle_quiet_on_daemon_or_join_2', ('thread-lifecycle',), (
        ('mod.py', """\
import threading


def spawn(work):
    t = threading.Thread(target=work)
    t.start()
    t.join()
"""),
    )),
    ('thread_lifecycle_quiet_on_daemon_or_join_3', ('thread-lifecycle',), (
        ('mod.py', """\
import threading


def spawn(work):
    t = threading.Thread(target=work)
    t.daemon = True
    t.start()
"""),
    )),
    ('probe_purity_fires_on_blocking_probe_branches', ('probe-purity',), (
        ('mod.py', """\
import urllib.request


class Handler:
    def do_GET(self):
        if self.path == "/healthz":
            with self.server.lock:
                doc = self.master.status()
            self._reply(200, doc)
        elif self.path.startswith("/readyz"):
            body = urllib.request.urlopen(
                "http://peer:8080/metrics").read()
            self._reply(200, body)
        else:
            self._reply(404, {})
"""),
    )),
    ('probe_purity_quiet_on_cached_reads_and_other_routes', ('probe-purity',), (
        ('mod.py', """\
class Handler:
    def do_GET(self):
        if self.path.startswith(("/healthz", "/readyz")):
            code, doc = monitor.probe(self.path)
            self._reply(code, doc)
        elif self.path.startswith("/metrics"):
            with self.lock:
                body = registry.render_prometheus()
            self._reply(200, body)
        else:
            self._reply(404, {})
"""),
    )),
    ('probe_purity_pragma_suppresses', ('probe-purity',), (
        ('mod.py', """\
class Handler:
    def do_GET(self):
        if self.path == "/healthz":
            with self.lock:  # zlint: disable=probe-purity (test rig)
                doc = dict(self.cache)
            self._reply(200, doc)
"""),
    )),
    ('reactor_purity_fires_on_blocking_callbacks', ('reactor-purity',), (
        ('mod.py', """\
import time
from urllib.request import urlopen


class Session:
    def on_frame(self, obj):
        time.sleep(0.1)                 # parks the whole loop
        return self.sock.recv(4096)     # raw-socket wait


class Plane:
    def __init__(self, loop):
        loop.call_soon(self._merge)
        loop.every(1.0, self._sweep)
        loop.call_later(0.5, lambda: self.done.wait())

    def _merge(self):
        self.worker.join()              # Thread.join shape
        return urlopen("http://127.0.0.1:1/metrics")

    def _sweep(self):
        self.sock.sendall(b"tick")
"""),
    )),
    ('reactor_purity_quiet_on_pure_callbacks', ('reactor-purity',), (
        ('mod.py', """\
class Session:
    def on_frame(self, obj):
        resp = self.handle(obj)
        with self.lock:                 # existing lock discipline: ok
            self.counter += 1
        self.send_obj(resp)
        return ", ".join(str(x) for x in resp)   # str.join, not Thread


class Plane:
    def __init__(self, loop):
        loop.call_soon(self._merge, 1)
        loop.every(1.0, self._sweep)

    def _merge(self, n):
        self.pending.append(n)

    def _sweep(self):
        for conn in self.connections():
            if conn.stale:
                conn.close()

    def off_loop_helper(self):
        # NOT a reactor callback: blocking here is the worker
        # thread's whole job
        self.done.wait(2.0)
"""),
    )),
    ('reactor_purity_pragma_suppresses', ('reactor-purity',), (
        ('mod.py', """\
import time


class S:
    def on_timer(self):
        time.sleep(0.01)  # zlint: disable=reactor-purity (test rig)
"""),
    )),
    ('profiler_safety_fires_on_inline_captures', ('profiler-safety',), (
        ('mod.py', """\
from veles import profiling


class Status:
    def _route(self, request):
        if request.path.startswith("/debug/profile"):
            code, body, ctype = profiling.profile_endpoint(
                request.path)
            request.reply(code, body, ctype)


class Wire:
    def on_frame(self, obj):
        self.profiler.start()
        prof = profiling.capture_profile(2.0)
        self.profiler.stop()
        return prof


class Plane:
    def __init__(self, loop, profiler):
        loop.every(1.0, self._tick)
        self._profiler = profiler

    def _tick(self):
        self._profiler.capture()
"""),
    )),
    ('profiler_safety_quiet_on_deferred_and_offloop', ('profiler-safety',), (
        ('mod.py', """\
from veles import profiling


class Status:
    def _route(self, request):
        if request.path.startswith("/debug/profile"):
            request.defer(self._serve_profile, request)
        elif request.path.startswith("/debug/"):
            request.reply_json(200, {})

    def _serve_profile(self, request):
        # worker thread: blocking here is the whole point
        code, body, ctype = profiling.profile_endpoint(request.path)
        request.reply(code, body, ctype)


def bench_row():
    # NOT a reactor callback or route: a bench/CLI capture is fine
    profiler = profiling.SamplingProfiler()
    profiler.start()
    profiler.stop()
    return profiler.profile()


class Wire:
    def on_frame(self, obj):
        # unrelated receivers named start/stop stay quiet
        self.timer.start()
        self.timer.stop()
"""),
    )),
    ('profiler_safety_pragma_suppresses', ('profiler-safety',), (
        ('mod.py', """\
class S:
    def on_timer(self):
        self.profiler.start()  # zlint: disable=profiler-safety (rig)
"""),
    )),
    ('wire_schema_arity_mismatch_fires', ('wire-schema',), (
        ('mod.py', """\
def recv_frame(sock):
    return sock


class Master:
    def handle(self, request):
        if request[0] == "job":
            return ("job", request, 1, 2, 3)
        return ("ok",)


def pump(sock):
    resp = recv_frame(sock)
    if resp[0] == "job":
        _, payload, job_id, epoch = resp
        return payload, job_id, epoch
"""),
    )),
    ('wire_schema_index_past_producer_fires', ('wire-schema',), (
        ('mod.py', """\
def recv_frame(sock):
    return sock


class Master:
    def handle(self, request):
        if request[0] == "job":
            return ("job", request, 1, 2, 3)
        return ("ok",)


def pump(sock):
    resp = recv_frame(sock)
    if resp[0] == "job":
        return resp[5]
"""),
    )),
    ('wire_schema_quiet_on_guarded_consumers', ('wire-schema',), (
        ('mod.py', """\
def recv_frame(sock):
    return sock


class Master:
    def handle(self, request):
        if request[0] == "job":
            return ("job", request, 1, 2, 3)
        return ("ok",)


def pump(sock):
    resp = recv_frame(sock)
    if resp[0] != "job" or len(resp) < 4:
        return None
    _, payload, job_id, epoch = resp[:4]
    trace = resp[4] if len(resp) > 4 else None
    return payload, job_id, epoch, trace


def pump_skew_tolerant(sock):
    resp = recv_frame(sock)
    if resp[0] == "job":
        try:
            _, payload, job_id = resp
        except ValueError:
            return None
        return payload, job_id
"""),
    )),
    ('wire_schema_directions_are_separate_namespaces', ('wire-schema',), (
        ('mod.py', """\
def send_frame(sock, obj):
    pass


def recv_frame(sock):
    return sock


class Master:
    def handle(self, request):
        if request[0] == "job":
            return ("job", request, 1, 2, 3)
        return ("ok",)


def pump(sock):
    send_frame(sock, ("job", 7, "lease"))
    resp = recv_frame(sock)
    if resp[0] != "job" or len(resp) < 4:
        return None
    _, payload, job_id, epoch = resp[:4]
    return payload, job_id, epoch
"""),
    )),
    ('wire_schema_no_producer_is_quiet', ('wire-schema',), (
        ('mod.py', """\
def route(argv):
    if argv[0] == "serve":
        return argv[1]
"""),
    )),
    ('wire_schema_floor_guard_excludes_short_producers', ('wire-schema',), (
        ('mod.py', """\
def recv_frame(sock):
    return sock


class Master:
    def handle(self, request):
        if len(request) < 3:
            return ("welcome", 1)
        return ("welcome", 1, 2, 3)


def connect(sock):
    resp = recv_frame(sock)
    if resp[0] != "welcome" or len(resp) < 4:
        return None
    _, a, b, c = resp
    return a, b, c
"""),
    )),
    ('wire_schema_pragma_suppresses', ('wire-schema',), (
        ('mod.py', """\
def recv_frame(sock):
    return sock


class Master:
    def handle(self, request):
        if request[0] == "job":
            return ("job", request, 1, 2, 3)
        return ("ok",)


def pump(sock):
    resp = recv_frame(sock)
    if resp[0] == "job":
        _, payload, job_id, epoch = resp  # zlint: disable=wire-schema (peer ships 4)
        return payload, job_id, epoch
"""),
    )),
    ('resource_leak_on_exception_path_fires', ('resource-leak',), (
        ('mod.py', """\
import socket


def build():
    return 1


def fetch(addr):
    sock = socket.create_connection(addr)
    meta = build()
    sock.close()
    return meta
"""),
    )),
    ('resource_leak_never_released_fires', ('resource-leak',), (
        ('mod.py', """\
import socket


def probe(addr):
    sock = socket.create_connection(addr)
    return sock.getpeername()[0]
"""),
    )),
    ('resource_leak_discarded_grant_fires', ('resource-leak',), (
        ('mod.py', """\
def admit(pool):
    pool.grant()
"""),
    )),
    ('resource_leak_quiet_on_safe_shapes', ('resource-leak',), (
        ('mod.py', """\
import socket


def build():
    return 1


def fetch(addr):
    sock = socket.create_connection(addr)
    try:
        meta = build()
    finally:
        sock.close()
    return meta


def fetch_handler(addr):
    sock = socket.create_connection(addr)
    try:
        meta = build()
    except OSError:
        sock.close()
        raise
    sock.close()
    return meta


def stored(self, addr):
    sock = socket.create_connection(addr)
    self.sock = sock
    return self


def handed_off(addr, conns):
    sock = socket.create_connection(addr)
    conns.append(sock)
"""),
    )),
    ('resource_leak_quiet_on_with_and_slot_store', ('resource-leak',), (
        ('mod.py', """\
def read(path, pool, active, req):
    with open(path) as f:
        data = f.read()
    req.slot = pool.grant()
    active[req.slot] = req
    return data
"""),
    )),
    ('resource_leak_sibling_branch_is_not_a_path', ('resource-leak',), (
        ('mod.py', """\
import socket


def make_other():
    return None


def connect(addr, fast):
    if fast:
        sock = socket.create_connection(addr)
    else:
        sock = make_other()
    try:
        data = sock.recv(1)
    finally:
        sock.close()
    return data
"""),
    )),
    ('resource_leak_pragma_suppresses', ('resource-leak',), (
        ('mod.py', """\
import socket


def build():
    return 1


def fetch(addr):
    sock = socket.create_connection(addr)  # zlint: disable=resource-leak (test rig)
    meta = build()
    sock.close()
    return meta
"""),
    )),
    ('loop_exception_uncaught_chain_fires', ('loop-exception-safety',), (
        ('mod.py', """\
class Session:
    def on_frame(self, obj):
        self.dispatch(obj)

    def dispatch(self, obj):
        if not obj:
            raise ValueError("empty frame")
        return obj
"""),
    )),
    ('loop_exception_scheduled_target_fires', ('loop-exception-safety',), (
        ('mod.py', """\
class Plane:
    def __init__(self, loop):
        loop.every(1.0, self._tick)

    def _tick(self):
        raise RuntimeError("wedged")
"""),
    )),
    ('loop_exception_quiet_on_caught_chains', ('loop-exception-safety',), (
        ('mod.py', """\
class Session:
    def on_frame(self, obj):
        try:
            self.dispatch(obj)
        except (ValueError, KeyError):
            self.reply_error()

    def dispatch(self, obj):
        if not obj:
            raise ValueError("empty frame")
        return obj

    def reply_error(self):
        pass


class Stub:
    def on_frame(self, obj):
        raise NotImplementedError


class Fenced(ConnectionError):
    pass


class Plane:
    def __init__(self, loop):
        loop.every(1.0, self._tick)

    def _tick(self):
        try:
            self.sync()
        except OSError:
            pass

    def sync(self):
        raise Fenced("lease revoked")
"""),
    )),
    ('loop_exception_handler_body_is_outside_its_try', ('loop-exception-safety',), (
        ('mod.py', """\
class Session:
    def on_frame(self, obj):
        try:
            self.dispatch(obj)
        except ValueError:
            raise RuntimeError("bad frame")

    def dispatch(self, obj):
        return obj
"""),
    )),
    ('loop_exception_pragma_suppresses', ('loop-exception-safety',), (
        ('mod.py', """\
class Session:
    def on_frame(self, obj):
        self.dispatch(obj)

    def dispatch(self, obj):
        if not obj:
            raise ValueError("empty frame")  # zlint: disable=loop-exception-safety (severing intended)
        return obj
"""),
    )),
    ('bare_except_fires_and_named_is_quiet_1', ('bare-except',), (
        ('mod.py', """\
try:
    pass
except:
    pass
"""),
    )),
    ('bare_except_fires_and_named_is_quiet_2', ('bare-except',), (
        ('mod.py', """\
try:
    pass
except Exception:
    pass
"""),
    )),
    ('unused_import_fires_and_noqa_is_quiet_1', ('unused-import',), (
        ('mod.py', """\
import os
import sys

print(sys.argv)
"""),
    )),
    ('unused_import_fires_and_noqa_is_quiet_2', ('unused-import',), (
        ('mod.py', """\
import os  # noqa: F401
import sys

print(sys.argv)
"""),
    )),
    ('unused_import_fires_and_noqa_is_quiet_3', ('unused-import',), (
        ('pkg/__init__.py', """\
import os
import sys

print(sys.argv)
"""),
    )),
    ('unused_variable_fires_and_exemptions_hold_1', ('unused-variable',), (
        ('mod.py', """\
def f(x):
    dead = x + 1
    return x
"""),
    )),
    ('unused_variable_fires_and_exemptions_hold_2', ('unused-variable',), (
        ('mod.py', """\
def f(x):
    _dead = x + 1
    kept = x + 2

    def g():
        return kept
    return g


def h(x):
    maybe_dead = x
    return locals()
"""),
    )),
    ('pragma_disable_all_and_multi_rule_1', ('bare-except',), (
        ('mod.py', """\
try:
    pass
except:  # zlint: disable=all (fixture)
    pass
"""),
    )),
    ('pragma_disable_all_and_multi_rule_2', ('bare-except',), (
        ('mod.py', """\
try:
    pass
except:  # zlint: disable=unused-import,bare-except
    pass
"""),
    )),
    ('pragma_inside_string_literal_is_not_a_pragma', ('bare-except',), (
        ('mod.py', """\
S = "# zlint: disable=bare-except"
try:
    pass
except:
    pass
"""),
    )),
    ('pragma_on_other_line_does_not_suppress', ('bare-except',), (
        ('mod.py', """\
# zlint: disable=bare-except
try:
    pass
except:
    pass
"""),
    )),
    ('stats_cadence_fires_on_ungated_materialization', ('stats-cadence',), (
        ('mod.py', """\
import numpy


class Step:
    def publish(self, outputs):
        stats = {k[5:]: v for k, v in outputs.items()
                 if k.startswith("stat/")}
        for layer, vec in stats.items():
            self.sink(layer, numpy.asarray(vec))   # per-step sync
            self.loss = float(vec[0])              # and another
"""),
    )),
    ('stats_cadence_quiet_when_gated_and_on_sink_1', ('stats-cadence',), (
        ('mod.py', """\
import numpy


class Step:
    def _stats_due(self):
        self._tick += 1
        return self._tick % self.stats_interval == 0

    def publish(self, outputs):
        stats = {k[5:]: v for k, v in outputs.items()
                 if k.startswith("stat/")}
        if not self._stats_due():
            return
        for layer, vec in stats.items():
            self.sink(layer, numpy.asarray(vec))
"""),
    )),
    ('stats_cadence_quiet_when_gated_and_on_sink_2', ('stats-cadence',), (
        ('mod.py', """\
import numpy


class Monitor:
    def observe_stats(self, layer_stats, step_index=None):
        for layer, vec in layer_stats.items():
            self.layers[layer] = float(numpy.asarray(vec)[0])
"""),
    )),
    ('stats_cadence_quiet_when_gated_and_on_sink_3', ('stats-cadence',), (
        ('mod.py', """\
STAT_KEY_PREFIX = "stat/"


def take_stats(outputs):
    stats, rest = {}, {}
    for key, value in outputs.items():
        if key.startswith(STAT_KEY_PREFIX):
            stats[key[len(STAT_KEY_PREFIX):]] = value
        else:
            rest[key] = value
    return stats, rest
"""),
    )),
    ('stats_cadence_fires_on_sink_caller_and_pragma_1', ('stats-cadence',), (
        ('mod.py', """\
import numpy


class Step:
    def flush(self, vecs):
        host = [numpy.asarray(v) for v in vecs]
        self.monitor.observe_stats(dict(enumerate(host)))
"""),
    )),
    ('stats_cadence_fires_on_sink_caller_and_pragma_2', ('stats-cadence',), (
        ('mod.py', """\
import numpy


class Step:
    def flush(self, vecs):
        host = [numpy.asarray(v) for v in vecs]  # zlint: disable=stats-cadence (one-shot postmortem dump, not a per-step path)
        self.monitor.observe_stats(dict(enumerate(host)))
"""),
    )),
    ('untrusted_geometry_fires_on_wire_shape_1', ('untrusted-geometry',), (
        ('mod.py', """\
import numpy


class Proto:
    def handle(self, kind, payload):
        self.buf = numpy.zeros(payload["shape"])
"""),
    )),
    ('untrusted_geometry_fires_on_wire_shape_2', ('untrusted-geometry',), (
        ('mod.py', """\
import numpy


class Proto:
    def handle(self, kind, payload):
        self.buf = numpy.zeros(
            self._validate_shape(payload["shape"]))

    def _validate_shape(self, shape):
        return [min(int(d), 64) for d in shape]
"""),
    )),
    ('untrusted_geometry_fires_on_wire_shape_3', ('untrusted-geometry',), (
        ('mod.py', """\
import numpy


class Proto:
    def handle(self, kind, payload):
        self.buf = numpy.zeros(payload["shape"])  # zlint: disable=untrusted-geometry (test fixture)
"""),
    )),
    ('untrusted_geometry_crosses_calls', ('untrusted-geometry',), (
        ('mod.py', """\
import numpy


class Proto:
    def handle(self, kind, payload):
        self._apply(payload)

    def _apply(self, doc):
        self.buf = numpy.zeros(doc["shape"])
"""),
    )),
    ('unbounded_cardinality_fires_on_wire_keyed_growth_1', ('unbounded-cardinality',), (
        ('mod.py', """\
class Server:
    def __init__(self):
        self.stats = {}

    def handle(self, kind, payload):
        self.stats[kind] = payload
"""),
    )),
    ('unbounded_cardinality_fires_on_wire_keyed_growth_2', ('unbounded-cardinality',), (
        ('mod.py', """\
class Server:
    def __init__(self):
        self.stats = {}

    def handle(self, kind, payload):
        self.stats[self._resolve_kind(kind)] = payload

    def _resolve_kind(self, kind):
        return kind if kind in ("job", "update") else "other"
"""),
    )),
    ('unbounded_cardinality_fires_on_wire_keyed_growth_3', ('unbounded-cardinality',), (
        ('mod.py', """\
class Server:
    def __init__(self):
        self.stats = {}

    def handle(self, kind, payload):
        self.stats[kind] = payload  # zlint: disable=unbounded-cardinality (test fixture)
"""),
    )),
    ('unbounded_cardinality_http_source_and_bounded_class_1', ('unbounded-cardinality',), (
        ('mod.py', """\
import json


class Frontend:
    def __init__(self):
        self.seen = {}

    def serve(self, request):
        doc = json.loads(request.body)
        self.seen[doc["name"]] = doc
"""),
    )),
    ('unbounded_cardinality_http_source_and_bounded_class_2', ('unbounded-cardinality',), (
        ('mod.py', """\
import json


class Frontend:
    def __init__(self):
        self.seen = BoundedDict(256)

    def serve(self, request):
        doc = json.loads(request.body)
        self.seen[doc["name"]] = doc
"""),
    )),
    ('unsafe_deserialize_fires_without_hmac_1', ('unsafe-deserialize',), (
        ('mod.py', """\
import pickle


class Proto:
    def handle(self, kind, payload):
        return pickle.loads(payload)
"""),
    )),
    ('unsafe_deserialize_fires_without_hmac_2', ('unsafe-deserialize',), (
        ('mod.py', """\
import hmac
import pickle


class Proto:
    def handle(self, kind, payload, tag):
        if not hmac.compare_digest(self._sign(payload), tag):
            raise ValueError("bad tag")
        return pickle.loads(payload)
"""),
    )),
    ('unsafe_deserialize_fires_without_hmac_3', ('unsafe-deserialize',), (
        ('mod.py', """\
import pickle


class Proto:
    def handle(self, kind, payload):
        return pickle.loads(payload)  # zlint: disable=unsafe-deserialize (test fixture)
"""),
    )),
    ('untrusted_path_fires_on_wire_filename_1', ('untrusted-path',), (
        ('mod.py', """\
class Store:
    def handle(self, kind, payload):
        with open(payload["path"]) as f:
            return f.read()
"""),
    )),
    ('untrusted_path_fires_on_wire_filename_2', ('untrusted-path',), (
        ('mod.py', """\
class Store:
    def handle(self, kind, payload):
        with open(self._resolve_path(payload["path"])) as f:
            return f.read()

    def _resolve_path(self, name):
        return self.root + "/" + name.rsplit("/", 1)[-1]
"""),
    )),
    ('untrusted_path_fires_on_wire_filename_3', ('untrusted-path',), (
        ('mod.py', """\
class Store:
    def handle(self, kind, payload):
        with open(payload["path"]) as f:  # zlint: disable=untrusted-path (test fixture)
            return f.read()
"""),
    )),
    ('sanitizer_annotation_kills_taint_1', ('untrusted-geometry',), (
        ('mod.py', """\
import numpy


def bounded_dims(doc):  # zlint: sanitizer (schema-checked upstream)
    return doc["rows"], doc["cols"]


class Proto:
    def handle(self, kind, payload):
        self.buf = numpy.zeros(bounded_dims(payload))
"""),
    )),
    ('sanitizer_annotation_kills_taint_2', ('untrusted-geometry',), (
        ('mod.py', """\
import numpy


def bounded_dims(doc):
    return doc["rows"], doc["cols"]


class Proto:
    def handle(self, kind, payload):
        self.buf = numpy.zeros(bounded_dims(payload))
"""),
    )),
    ('sanitizer_annotation_kills_taint_3', ('untrusted-geometry',), (
        ('mod.py', """\
import numpy

TABLE = {"small": (4, 4), "big": (64, 64)}


class Proto:
    def handle(self, kind, payload):
        self.buf = numpy.zeros(TABLE.get(payload["profile"],
                                         (4, 4)))
"""),
    )),
    ('range_guard_kills_taint', ('untrusted-geometry',), (
        ('mod.py', """\
import numpy


class Proto:
    def handle(self, kind, payload):
        n = payload["n"]
        if n > 4096:
            raise ValueError("too big")
        self.buf = numpy.zeros(n)
"""),
    )),
    ('cache_reuses_and_reanalyzes_only_dependents_1', None, (
        ('pkg/a.py', """\
import os

from pkg import b


def use():
    return b.helper()
"""),
        ('pkg/b.py', """\
def helper():
    return 1
"""),
        ('pkg/c.py', """\
X = 1
"""),
    )),
    ('cache_reuses_and_reanalyzes_only_dependents_2', None, (
        ('pkg/a.py', """\
import os

from pkg import b


def use():
    return b.helper()
"""),
        ('pkg/b.py', """\
def helper():
    return 2
"""),
        ('pkg/c.py', """\
X = 1
"""),
    )),
    ('cache_invalidates_on_import_graph_change_1', None, (
        ('pkg/a.py', """\
def use():
    return 1
"""),
        ('pkg/b.py', """\
def helper():
    return 1
"""),
    )),
    ('cache_invalidates_on_import_graph_change_2', None, (
        ('pkg/a.py', """\
def use():
    return 1
"""),
        ('pkg/b.py', """\
def helper():
    return 2
"""),
    )),
    ('cache_invalidates_on_import_graph_change_3', None, (
        ('pkg/a.py', """\
from pkg import b


def use():
    return b.helper()
"""),
        ('pkg/b.py', """\
def helper():
    return 2
"""),
    )),
    ('cache_invalidates_on_import_graph_change_4', None, (
        ('pkg/a.py', """\
from pkg import b


def use():
    return b.helper()
"""),
        ('pkg/b.py', """\
def helper():
    return 3
"""),
    )),
    ('cache_pragma_edit_rekeys_the_module_1', None, (
        ('pkg/a.py', """\
import os
"""),
    )),
    ('cache_pragma_edit_rekeys_the_module_2', None, (
        ('pkg/a.py', """\
import os  # zlint: disable=unused-import (test)
"""),
    )),
    ('gate_would_catch_a_regression', ('checkpoint-state',), (
        ('mod.py', """\
import threading


class Worker(Unit):
    def __init__(self):
        self._lock = threading.Lock()

    def run(self):
        self.epoch = getattr(self, "epoch", 0) + 1
"""),
    )),
)


def port_twin(source):
    """A reference fixture as the port's: the imports of the reference
    package name the port's (``from veles import telemetry`` ->
    ``from veles_torch import telemetry``); nothing else changes, so
    every line keeps its number."""
    source = re.sub(r"(?m)^(\s*)from veles import ",
                    r"\1from veles_torch import ", source)
    return re.sub(r"(?m)^(\s*)import veles\.", r"\1import veles_torch.",
                  source)


def write_tree(root, files):
    for rel, src in files:
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)


def lint_tree(core, root, files, select=None):
    """Write ``files`` under ``root`` and analyze them with ``core``
    (either package's), paths relative to ``root``."""
    write_tree(root, files)
    return core.analyze_paths([str(root)], base=str(root),
                              select=list(select) if select else None)


def rows(findings):
    return [(f.rule, f.file.replace(os.sep, "/"), f.line, f.severity,
             f.message) for f in findings]


# -- the shared rules: every reference fixture, both linters -----------


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fixture_findings_equal_the_reference(tmp_path, case):
    """The reference's fixture through both linters: the same findings,
    message for message (the retargeted telemetry-hygiene fixtures as
    their twins)."""
    _cid, select, files = case
    want = lint_tree(ref_core, tmp_path / "ref", files, select)
    got = lint_tree(port_core, tmp_path / "port",
                    [(rel, port_twin(src)) for rel, src in files], select)
    assert rows(got) == rows(want)


def test_fixtures_fire_every_shared_rule(tmp_path):
    """The table is no empty comparison: on the reference's fixtures the
    port fires every rule but tracer-purity (held by the twins below),
    and at least a third of the fixtures fire."""
    fired = set()
    firing = 0
    for i, (_cid, select, files) in enumerate(CASES):
        got = lint_tree(port_core, tmp_path / str(i),
                        [(rel, port_twin(src)) for rel, src in files],
                        select)
        fired.update(f.rule for f in got)
        firing += bool(got)
    assert fired == set(RULE_IDS) - {"tracer-purity"}
    assert firing >= len(CASES) // 3


def test_telemetry_hygiene_names_the_port_package(tmp_path):
    """The retargeted telemetry-hygiene: the module-alias style fires on
    ``veles_torch.telemetry`` and no longer on the reference's module."""
    src = ("from veles_torch import telemetry\n\n\n"
           "def f(names):\n"
           "    for n in names:\n"
           "        telemetry.counter(\"veles_x_total\", \"help\").inc()\n")
    got = lint_tree(port_core, tmp_path / "port", [("mod.py", src)],
                    ["telemetry-hygiene"])
    assert [f.line for f in got] == [6]
    ref_style = src.replace("veles_torch", "veles", 1)
    assert lint_tree(port_core, tmp_path / "ref",
                     [("mod.py", ref_style)], ["telemetry-hygiene"]) == []


# -- tracer-purity: the reference's fixtures and their port twins ------


#: (case id, reference files under znicz_tpu/ops, port twin files under
#: znicz/ops): each twin keeps the reference fixture's lines, a unit body
#: (``forward(self, x)`` of an nn.Module, or a unit's ``run``) where the
#: reference has an ``xla_run(self, ctx)`` reading ``ctx.get("x")``
PURITY_TWINS = (
    ("fires_on_all_impurities", (
        ("znicz_tpu/ops/fake.py", """\
import numpy
import time


class Op:
    def xla_run(self, ctx):
        x = ctx.get("x")
        numpy.random.rand(3)
        time.time()
        print("traced")
        bad = x.sum().item()
        worse = float(x)
        self.cache = bad + worse
        return self.helper(ctx)

    def helper(self, ctx):
        self.hidden = 1
"""),
    ), (
        ("znicz/ops/fake.py", """\
import numpy
import time
from torch import nn

class Op(nn.Module):
    def forward(self, x):
        x = x * 1
        numpy.random.rand(3)
        time.time()
        print("traced")
        bad = x.sum().item()
        worse = float(x)
        self.cache = bad + worse
        return self.helper(x)

    def helper(self, x):
        self.hidden = 1
"""),
    )),
    ("quiet_on_pure_op", (
        ("znicz_tpu/ops/fake.py", """\
import numpy


def _shape_prod(shape):
    return int(numpy.prod(shape))


class Op:
    def xla_run(self, ctx):
        x = ctx.get("x")
        n = _shape_prod((3, 4))
        return x.sum() / n
"""),
    ), (
        ("znicz/ops/fake.py", """\
import numpy
from torch import nn


def _shape_prod(shape):
    return int(numpy.prod(shape))


class Op(nn.Module):
    def forward(self, x):
        n = _shape_prod((3, 4))
        return x.sum() / n
"""),
    )),
    ("quiet_outside_ops", (
        ("host_unit.py", """\
import numpy
import time


class Op:
    def xla_run(self, ctx):
        x = ctx.get("x")
        numpy.random.rand(3)
        time.time()
        print("traced")
        bad = x.sum().item()
        worse = float(x)
        self.cache = bad + worse
        return self.helper(ctx)

    def helper(self, ctx):
        self.hidden = 1
"""),
    ), (
        ("host_unit.py", """\
import numpy
import time
from torch import nn

class Op(nn.Module):
    def forward(self, x):
        x = x * 1
        numpy.random.rand(3)
        time.time()
        print("traced")
        bad = x.sum().item()
        worse = float(x)
        self.cache = bad + worse
        return self.helper(x)

    def helper(self, x):
        self.hidden = 1
"""),
    )),
    ("catches_every_import_spelling", (
        ("znicz_tpu/ops/fake.py", """\
from numpy import random
from time import monotonic
import numpy.random
import time as clock


class Op:
    def xla_run(self, ctx):
        random.rand(3)
        monotonic()
        numpy.random.standard_normal(2)
        clock.sleep(0.1)
        return ctx.get("x")
"""),
    ), (
        ("znicz/ops/fake.py", """\
from numpy import random
from time import monotonic
import numpy.random
import time as clock
from torch import nn

class Op(nn.Module):
    def forward(self, x):
        random.rand(3)
        monotonic()
        numpy.random.standard_normal(2)
        clock.sleep(0.1)
        return x
"""),
    )),
    ("follows_module_alias_helpers", (
        ("znicz_tpu/ops/helpers.py", """\
import numpy


def noisy(x):
    return x + numpy.random.uniform()
"""),
        ("znicz_tpu/ops/op.py", """\
from znicz_tpu.ops import helpers as H
from znicz_tpu.ops.helpers import noisy


class Op:
    def xla_run(self, ctx):
        a = H.noisy(ctx.get("x"))
        return noisy(a)
"""),
    ), (
        ("znicz/ops/helpers.py", """\
import numpy


def noisy(x):
    return x + numpy.random.uniform()
"""),
        ("znicz/ops/op.py", """\
from znicz.ops import helpers as H
from znicz.ops.helpers import noisy


class Op:
    def run(self, x):
        a = H.noisy(x)
        return noisy(a)
"""),
    )),
    ("taint_propagates_through_locals", (
        ("znicz_tpu/ops/fake.py", """\
class Op:
    def xla_run(self, ctx):
        t = ctx.get("x")
        s = t * 2
        k = float(s)
        return k
"""),
    ), (
        ("znicz/ops/fake.py", """\
class Op:
    def run(self, x):
        t = x
        s = t * 2
        k = float(s)
        return k
"""),
    )),
    ("int_on_static_shapes_is_legitimate", (
        ("znicz_tpu/ops/fake.py", """\
import numpy


class Op:
    def xla_run(self, ctx):
        n = int(numpy.prod((2, 3)))
        return n
"""),
    ), (
        ("znicz/ops/fake.py", """\
import numpy


class Op:
    def run(self, x):
        n = int(numpy.prod((2, 3)))
        return n
"""),
    )),
)


@pytest.mark.parametrize("case", PURITY_TWINS, ids=[c[0] for c in PURITY_TWINS])
def test_tracer_purity_twin_fires_on_the_same_lines(tmp_path, case):
    """The reference's tracer-purity fixture and its port twin: the same
    (path, line) findings, and the port's messages speak of the captured
    scope."""
    _cid, ref_files, port_files = case
    want = lint_tree(ref_core, tmp_path / "ref", ref_files,
                     ["tracer-purity"])
    got = lint_tree(port_core, tmp_path / "port", port_files,
                    ["tracer-purity"])

    def lines(found):
        return [(f.file.replace(os.sep, "/").replace("znicz_tpu/", "znicz/"),
                 f.line) for f in found]

    assert lines(got) == lines(want)
    assert all("captured scope" in f.message for f in got)
    assert all("jax" not in f.hint for f in got)


#: (case id, port source under znicz/ops/op.py, lines that must fire)
PORT_PURITY = (
    ("cpu", "class Op:\n    def run(self, x):\n"
            "        return x.cpu()\n", [3]),
    ("numpy", "class Op:\n    def run(self, x):\n"
              "        return x.detach().numpy()\n", [3]),
    ("tolist", "class Op:\n    def run(self, x):\n"
               "        return x.tolist()\n", [3]),
    ("synchronize", "import torch\n\n\nclass Op:\n"
                    "    def run(self, x):\n"
                    "        torch.cuda.synchronize()\n"
                    "        return x\n", [6]),
    ("synchronize_aliased", "from torch import cuda\n\n\nclass Op:\n"
                            "    def run(self, x):\n"
                            "        cuda.synchronize()\n"
                            "        return x\n", [6]),
    ("bool_of_tensor", "class Op:\n    def run(self, x):\n"
                       "        if bool((x > 0).any()):\n"
                       "            return x\n", [3]),
    ("float_of_self_tensor",
     "import torch\n\n\nclass Op(torch.nn.Module):\n"
     "    def __init__(self):\n"
     "        self.weights = torch.zeros(3)\n\n"
     "    def forward(self, x):\n"
     "        return x * float(self.weights.sum())\n", [9]),
    ("host_random", "import random\n\n\nclass Op:\n"
                    "    def run(self, x):\n"
                    "        return x * random.random()\n", [6]),
    ("counter_on_self", "class Op:\n    def run(self, x):\n"
                        "        self.n += 1\n        return x\n", [3]),
    ("python_scalar_on_self", "class Op:\n    def run(self, x):\n"
                              "        self.n = self.n + 1\n"
                              "        self.rate = 0.5\n"
                              "        return x\n", [3, 4]),
    ("host_value_through_item", "class Op:\n    def run(self, x):\n"
                                "        self.loss = x.sum().item()\n"
                                "        return x\n", [3, 3]),
    ("tensor_on_self_is_legal",
     "import torch\n\n\nclass Op(torch.nn.Module):\n"
     "    def forward(self, x):\n"
     "        self.x = x * 2\n"
     "        self.mask = torch.rand_like(x) < 0.5\n"
     "        self.cache = {\"y\": x}\n"
     "        self.steps = self.count.sum()\n"
     "        self.acc += x\n"
     "        return x\n", []),
    ("shape_arithmetic_is_legal",
     "class Op:\n    def run(self, x, y, err):\n"
     "        n = int(x.shape[0]) * int(x.size(1)) + len(y)\n"
     "        scale = float(err.numel() * err.dim())\n"
     "        return x * scale / n\n", []),
    ("helper_parameters_carry_tensors_only_where_passed",
     "import numpy\n\n\ndef scale_for(dh):\n"
     "    return float(numpy.float32(1.0 / numpy.sqrt(dh)))\n\n\n"
     "def sync(t):\n    return float(t)\n\n\n"
     "class Op:\n    def run(self, x):\n"
     "        b, s = x.shape\n"
     "        return sync(x * scale_for(s))\n", [9]),
    ("autograd_function",
     "import torch\n\n\nclass F(torch.autograd.Function):\n"
     "    @staticmethod\n    def forward(ctx, x):\n"
     "        ctx.save_for_backward(x)\n        return x * 2\n\n"
     "    @staticmethod\n    def backward(ctx, g):\n"
     "        (x,) = ctx.saved_tensors\n"
     "        print(float(x))\n        return g * 2\n", [13, 13]),
    ("pragma", "class Op:\n    def run(self, x):\n"
               "        return x.item()  # zlint: disable=tracer-purity "
               "(read once at set-up)\n", []),
    ("not_a_unit_body", "class Op:\n    def stats(self, x):\n"
                        "        return x.item()\n", []),
)


@pytest.mark.parametrize("case", PORT_PURITY, ids=[c[0] for c in PORT_PURITY])
def test_tracer_purity_port_cases(tmp_path, case):
    """What a CUDA-graph capture cannot replay fires; tensor writes to
    self, shape arithmetic and what lies outside the unit bodies stay
    quiet."""
    _cid, src, lines = case
    got = lint_tree(port_core, tmp_path, [("znicz/ops/op.py", src)],
                    ["tracer-purity"])
    assert [f.line for f in got] == lines, [f.render() for f in got]
    assert lint_tree(port_core, tmp_path / "host",
                     [("host.py", src)], ["tracer-purity"]) == []


def test_traced_functions_is_the_scope_of_the_port():
    """``traced_functions`` exports the scope: the unit bodies of
    ``znicz/ops`` and the kernel wrappers they reach; the step's glue,
    the models and the serving code lie outside it."""
    project = port_core.build_project(
        [os.path.join(REPO, "veles_torch", "znicz")], base=REPO)
    scope = rules_purity.traced_functions(project)
    names = {(path, name) for path, _a, _b, name in scope}
    ops = "veles_torch/znicz/ops/"
    for path, name in (
            ("all2all.py", "All2AllBase.forward"), ("gd.py", "GDBase.run"),
            ("evaluator.py", "EvaluatorSoftmax.run"),
            ("attention.py", "MultiHeadAttention.forward"),
            ("flash_attention.py", "flash_attention_fwd"),
            ("flash_attention.py", "flash_attention_bwd"),
            ("bias_grad.py", "bias_grad")):
        assert (ops + path, name) in names, name
    assert all(path.startswith(ops) for path, _a, _b, _n in scope)
    assert all(a <= b for _p, a, b, _n in scope)
    assert scope == sorted(scope)


# -- pragmas -------------------------------------------------------------


def test_every_pragma_of_the_port_states_its_reason():
    """A pragma in the port names known rules and gives its reason in
    parentheses."""
    pragma = re.compile(r"#\s*zlint:\s*disable=([A-Za-z0-9_,-]+)(.*)")
    seen = 0
    for path in port_core.iter_py_files(
            [os.path.join(REPO, "veles_torch"),
             os.path.join(REPO, "chip_smoke.py")]):
        if os.sep + "analysis" + os.sep in path:
            continue        # the linter's docstrings show the syntax
        with open(path) as f:
            for no, line in enumerate(f, 1):
                m = pragma.search(line)
                if not m:
                    continue
                seen += 1
                where = "%s:%d" % (os.path.relpath(path, REPO), no)
                assert set(m.group(1).split(",")) <= set(RULE_IDS), where
                assert re.match(r"\s*\(\S.*\)", m.group(2)), where
    assert seen >= 4


# -- the CLI, against the reference's ------------------------------------


def both(capsys, argv, cwd=None):
    """-> ((rc, out, err) of the reference's CLI, the same of the
    port's) on ``argv``, run in ``cwd``."""
    here = os.getcwd()
    out = []
    if cwd is not None:
        os.chdir(cwd)
    try:
        for main in (ref_lint_main, lint_main):
            capsys.readouterr()
            rc = main(list(argv))
            got = capsys.readouterr()
            out.append((rc, got.out, got.err))
    finally:
        os.chdir(here)
    return out


DIRTY = "import os\n\ntry:\n    pass\nexcept:\n    pass\n"
BARE = "try:\n    pass\nexcept:\n    pass\n"


@pytest.mark.parametrize("argv, rc", [
    (["clean.py"], 0), (["dirty.py"], 1), (["missing.py"], 2),
    (["--select", "no-such-rule", "clean.py"], 2), (["broken.py"], 2),
    (["--json", "dirty.py", "bare.py"], 1),
    (["--format", "json", "dirty.py", "bare.py"], 1),
    (["--format", "sarif", "bare.py"], 1), (["--format", "sarif",
                                             "clean.py"], 0),
    (["--select", "unused-import", "dirty.py"], 1),
    (["--select", "bare-except,unused-import", "--format", "json",
      "dirty.py"], 1),
    (["--format", "xml", "clean.py"], 2)],
    ids=["clean", "findings", "missing", "unknown_rule", "unparseable",
         "json_alias", "json", "sarif", "sarif_clean", "select",
         "select_two", "bad_format"])
def test_cli_equals_the_reference(tmp_path, capsys, argv, rc):
    """Exit codes 0/1/2, text, JSON and SARIF output byte for byte the
    reference's on the same files (for the rules both share)."""
    for name, src in (("clean.py", "X = 1\n"), ("dirty.py", DIRTY),
                      ("bare.py", BARE), ("broken.py", "def f(:\n")):
        (tmp_path / name).write_text(src)
    ref, port = both(capsys, argv, cwd=tmp_path)
    assert port[0] == ref[0] == rc
    assert port[1] == ref[1]
    if rc == 2:         # the same error (the usage lines wrap apart)
        assert port[2].splitlines()[-1].replace(
            "python -m veles_torch lint", "velescli lint") \
            == ref[2].splitlines()[-1]


def test_cli_output_is_sorted_shaped_and_byte_stable(tmp_path, capsys):
    (tmp_path / "a.py").write_text(DIRTY)
    (tmp_path / "b.py").write_text(BARE)
    (ref, port), (_r2, port2) = (
        both(capsys, ["--json", "a.py", "b.py"], cwd=tmp_path),
        both(capsys, ["--json", "a.py", "b.py"], cwd=tmp_path))
    assert port == port2
    payload = json.loads(port[1])
    assert [sorted(f) for f in payload] == [
        ["file", "hint", "line", "message", "rule", "severity"]
    ] * len(payload) and len(payload) == 3
    keys = [(f["file"], f["line"], f["rule"]) for f in payload]
    assert keys == sorted(keys)
    assert all(not os.path.isabs(f["file"]) for f in payload)
    (_r, sarif), (_r2, sarif2) = (
        both(capsys, ["--format", "sarif", "b.py"], cwd=tmp_path),
        both(capsys, ["--format", "sarif", "b.py"], cwd=tmp_path))
    assert sarif == sarif2
    doc = json.loads(sarif[1])
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "zlint"
    result = run["results"][0]
    assert result["ruleId"] == "bare-except"
    loc = result["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "b.py"
    assert loc["region"]["startLine"] == 3


def test_cli_sarif_names_the_retargeted_rule(tmp_path, capsys):
    """The SARIF rule table carries the port's description of
    tracer-purity; its results are the twin's lines."""
    path = tmp_path / "znicz" / "ops" / "op.py"
    path.parent.mkdir(parents=True)
    path.write_text(PORT_PURITY[0][1])
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert lint_main(["--format", "sarif", "znicz"]) == 1
    finally:
        os.chdir(here)
    run = json.loads(capsys.readouterr().out)["runs"][0]
    (rule,) = run["tool"]["driver"]["rules"]
    assert rule["id"] == "tracer-purity"
    assert "CUDA graph" in rule["shortDescription"]["text"]
    assert [r["locations"][0]["physicalLocation"]["region"]["startLine"]
            for r in run["results"]] == [3]


def test_cli_unreadable_input_is_usage_error(tmp_path, monkeypatch,
                                             capsys):
    target = tmp_path / "locked.py"
    target.write_text("X = 1\n")
    real_open = builtins.open

    def deny(path, *args, **kwargs):
        if str(path) == str(target):
            raise PermissionError(13, "Permission denied", str(path))
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", deny)
    ref, port = both(capsys, [str(target)])
    assert port[0] == ref[0] == 2
    assert "cannot read" in port[2]


def test_cli_list_rules_names_all_twenty(capsys):
    ref, port = both(capsys, ["--list-rules"])
    assert port[0] == ref[0] == 0

    def table(text):
        return [line.split()[:2] for line in text.splitlines()]

    assert table(port[1]) == table(ref[1])
    assert [r for r, _sev in table(port[1])] == list(RULE_IDS)


def test_lint_is_a_subcommand_of_the_port(capsys):
    """``python -m veles_torch lint`` reaches the linter; with no paths
    it lints the veles_torch package."""
    from veles_torch.__main__ import main
    from veles_torch.analysis import cli
    assert main(["lint", "--list-rules"]) == 0
    assert "tracer-purity" in capsys.readouterr().out
    assert cli._default_paths() == [os.path.join(REPO, "veles_torch")]


def git(cwd, *argv):
    return subprocess.run(
        ["git", "-c", "user.email=t@t", "-c", "user.name=t"] + list(argv),
        cwd=cwd, check=True, capture_output=True)


def test_cli_changed_only_lints_only_changed_files(tmp_path, capsys):
    """--changed-only: the committed-but-unchanged violation is skipped,
    the modified and the untracked files are linted; a clean tree exits
    0; both CLIs agree."""
    git(tmp_path, "init", "-q")
    (tmp_path / "a.py").write_text(BARE)
    (tmp_path / "b.py").write_text("X = 1\n")
    git(tmp_path, "add", ".")
    git(tmp_path, "commit", "-qm", "seed")
    (tmp_path / "b.py").write_text(BARE)
    (tmp_path / "c.py").write_text(BARE)
    argv = [str(tmp_path), "--changed-only", "--select", "bare-except"]
    ref, port = both(capsys, argv, cwd=tmp_path)
    assert port[:2] == ref[:2]
    assert port[0] == 1
    assert "b.py" in port[1] and "c.py" in port[1] and "a.py" not in port[1]
    git(tmp_path, "add", ".")
    git(tmp_path, "commit", "-qm", "all dirty now clean")
    ref, port = both(capsys, argv, cwd=tmp_path)
    assert port[:2] == ref[:2]
    assert port[0] == 0 and "0 finding(s)" in port[1]


def test_cli_changed_only_bad_ref_is_usage_error(tmp_path, capsys):
    git(tmp_path, "init", "-q")
    (tmp_path / "a.py").write_text("X = 1\n")
    git(tmp_path, "add", ".")
    git(tmp_path, "commit", "-qm", "seed")
    ref, port = both(capsys, [str(tmp_path), "--changed-only",
                              "no-such-ref"], cwd=tmp_path)
    assert port[0] == ref[0] == 2
    assert "cannot resolve ref" in port[2]


def test_cli_changed_only_falls_back_without_git(tmp_path, monkeypatch,
                                                 capsys):
    """No git at all (the binary missing): the full tree, with a
    warning — the reference's documented fallback."""
    (tmp_path / "m.py").write_text(BARE)
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    ref, port = both(capsys, ["m.py", "--changed-only", "--select",
                              "bare-except"], cwd=tmp_path)
    assert port == ref
    assert port[0] == 1
    assert "full tree" in port[2] and "bare-except" in port[1]


def test_cli_cache_and_stats(tmp_path, capsys):
    """--cache + --stats: the text table reports fresh/cached module
    counts, --json wraps {findings, stats}, sarif keeps the table on
    standard error, and a warm --format json run is byte-identical to an
    uncached one."""
    p = tmp_path / "m.py"
    p.write_text(DIRTY)
    cache_dir = str(tmp_path / "zc")
    assert lint_main([str(p), "--cache", cache_dir, "--stats"]) == 1
    out_cold = capsys.readouterr().out
    assert "fresh" in out_cold and "cached" in out_cold
    assert lint_main([str(p), "--cache", cache_dir, "--stats",
                      "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in doc["findings"]} \
        == {"unused-import", "bare-except"}
    by_rule = {r["rule"]: r for r in doc["stats"]}
    assert sorted(by_rule) == list(RULE_IDS)
    assert by_rule["bare-except"]["cached_modules"] == 1
    assert by_rule["bare-except"]["fresh_modules"] == 0
    assert lint_main([str(p), "--cache", cache_dir, "--stats",
                      "--format", "sarif"]) == 1
    got = capsys.readouterr()
    assert json.loads(got.out)["version"] == "2.1.0"
    assert "cached" in got.err
    lint_main([str(p), "--format", "json"])
    plain = capsys.readouterr().out
    lint_main([str(p), "--cache", cache_dir, "--format", "json"])
    assert capsys.readouterr().out == plain


def test_cli_precommit_invocation(tmp_path, capsys):
    """The documented pre-commit line: ``--changed-only --cache
    .zlint-cache --format sarif``. With a cache the full tree is kept and
    the SARIF document is byte-identical to an uncached full run."""
    git(tmp_path, "init", "-q")
    (tmp_path / "a.py").write_text("X = 1\n")
    (tmp_path / "b.py").write_text("Y = 2\n")
    git(tmp_path, "add", ".")
    git(tmp_path, "commit", "-qm", "seed")
    (tmp_path / "b.py").write_text(BARE)
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = lint_main([str(tmp_path), "--changed-only", "--cache",
                        str(tmp_path / ".zlint-cache"), "--format",
                        "sarif", "--select", "bare-except"])
        warm = capsys.readouterr().out
        rc_full = lint_main([str(tmp_path), "--format", "sarif",
                             "--select", "bare-except"])
        full = capsys.readouterr().out
    finally:
        os.chdir(here)
    assert rc == rc_full == 1
    assert warm == full
    assert json.loads(warm)["runs"][0]["results"][0]["ruleId"] \
        == "bare-except"


# -- the incremental cache -------------------------------------------------


def run_cached(tmp_path, cache_dir):
    stats = []
    found = port_core.analyze_paths(
        [str(tmp_path / "pkg")], base=str(tmp_path),
        cache=AnalysisCache(str(cache_dir)), stats=stats)
    return found, {row["rule"]: row for row in stats}


def test_cache_reuses_and_reanalyzes_only_dependents(tmp_path):
    """A warm run is all-cached with byte-identical findings; editing one
    module re-analyzes only the modules whose import closure holds it,
    and the findings still match an uncached run byte for byte."""
    write_tree(tmp_path, (
        ("pkg/a.py", "import os\n\nfrom pkg import b\n\n\n"
                     "def use():\n    return b.helper()\n"),
        ("pkg/b.py", "def helper():\n    return 1\n"),
        ("pkg/c.py", "X = 1\n")))
    cache_dir = tmp_path / "zc"
    cold, stats_cold = run_cached(tmp_path, cache_dir)
    assert stats_cold["unused-import"]["fresh_modules"] == 3
    assert [f.rule for f in cold] == ["unused-import"]
    warm, stats_warm = run_cached(tmp_path, cache_dir)
    assert stats_warm["unused-import"]["fresh_modules"] == 0
    assert stats_warm["unused-import"]["cached_modules"] == 3
    assert stats_warm["tracer-purity"]["cached_modules"] == 3
    assert json.dumps([f.as_dict() for f in warm]) \
        == json.dumps([f.as_dict() for f in cold])
    (tmp_path / "pkg/b.py").write_text("def helper():\n    return 2\n")
    edited, stats_edit = run_cached(tmp_path, cache_dir)
    assert stats_edit["unused-import"]["fresh_modules"] == 2
    assert stats_edit["unused-import"]["cached_modules"] == 1
    assert stats_edit["untrusted-geometry"]["fresh_modules"] == 3
    uncached = port_core.analyze_paths([str(tmp_path / "pkg")],
                                       base=str(tmp_path))
    assert json.dumps([f.as_dict() for f in edited]) \
        == json.dumps([f.as_dict() for f in uncached])


def test_cache_invalidates_on_import_graph_change(tmp_path):
    write_tree(tmp_path, (("pkg/a.py", "def use():\n    return 1\n"),
                          ("pkg/b.py", "def helper():\n    return 1\n")))
    cache_dir = tmp_path / "zc"
    run_cached(tmp_path, cache_dir)
    (tmp_path / "pkg/b.py").write_text("def helper():\n    return 2\n")
    _, stats = run_cached(tmp_path, cache_dir)
    assert stats["unused-import"]["fresh_modules"] == 1
    (tmp_path / "pkg/a.py").write_text(
        "from pkg import b\n\n\ndef use():\n    return b.helper()\n")
    run_cached(tmp_path, cache_dir)
    (tmp_path / "pkg/b.py").write_text("def helper():\n    return 3\n")
    _, stats = run_cached(tmp_path, cache_dir)
    assert stats["unused-import"]["fresh_modules"] == 2


def test_cache_pragma_edit_rekeys_the_module(tmp_path):
    write_tree(tmp_path, (("pkg/a.py", "import os\n"),))
    cache_dir = tmp_path / "zc"
    cold, _ = run_cached(tmp_path, cache_dir)
    assert [f.rule for f in cold] == ["unused-import"]
    (tmp_path / "pkg/a.py").write_text(
        "import os  # zlint: disable=unused-import (test)\n")
    warm, _ = run_cached(tmp_path, cache_dir)
    assert warm == []


def test_cache_salt_is_the_ports_own_rule_sources():
    """The cache key's analyzer salt hashes ``veles_torch/analysis/*.py``
    (a rule edit orphans every entry), not the reference's sources."""
    import hashlib
    from veles_torch.analysis import cache
    h = hashlib.sha256(b"zlint-cache-format-%d" % cache._FORMAT)
    pkg = os.path.join(REPO, "veles_torch", "analysis")
    for name in sorted(os.listdir(pkg)):
        if name.endswith(".py"):
            with open(os.path.join(pkg, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read() + b"\0")
    assert cache.analyzer_salt() == h.hexdigest()


# -- the repairs the gate asked for ----------------------------------------


@pytest.fixture(scope="module")
def mnist_archive(tmp_path_factory):
    """A small MNIST inference archive of the port (untrained)."""
    from veles_torch.config import root
    from veles_torch.znicz.models import mnist
    saved = root.mnist.to_dict()
    path = tmp_path_factory.mktemp("lint_serve") / "mnist"
    try:
        root.mnist.loader.update({"minibatch_size": 10, "n_train": 20,
                                  "n_valid": 10})
        wf = mnist.create_workflow(name="LintServe")
        wf.initialize(device="cpu")
        wf.export_inference(str(path))
    finally:
        root.mnist.update(saved)
    return str(path)


class FailingThreading:
    """The ``threading`` module as ``serving/frontend.py`` sees it, with
    its ``fail_at``-th ``Event()`` raising."""

    def __init__(self, fail_at):
        self.fail_at = fail_at
        self.events = 0

    def __getattr__(self, name):
        return getattr(threading, name)

    def Event(self):
        self.events += 1
        if self.events == self.fail_at:
            raise RuntimeError("injected Event() failure")
        return threading.Event()


@pytest.mark.parametrize("fail_at", [1, 2],
                         ids=["before_the_loads", "after_the_loads"])
def test_serve_main_stops_the_registry_when_event_fails(
        mnist_archive, monkeypatch, fail_at):
    """An ``Event()`` failing in ``serve_main`` (the first, before the
    models load; the second, with the model's batcher running) leaves no
    registry unclosed and no batcher thread alive."""
    from veles_torch.serving import frontend, registry
    made = []

    class Registry(registry.ModelRegistry):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.closed = False
            made.append(self)

        def close(self):
            self.closed = True
            super().close()

    monkeypatch.setattr(registry, "ModelRegistry", Registry)
    monkeypatch.setattr(frontend, "threading", FailingThreading(fail_at))
    with pytest.raises(RuntimeError, match="injected"):
        frontend.serve_main(["--model", "lintm=" + mnist_archive,
                             "-d", "cpu", "--port", "0", "--no-warmup"])
    assert all(r.closed for r in made)
    assert len(made) == fail_at - 1
    alive = [t.name for t in threading.enumerate()
             if t.name == "batcher-lintm" and t.is_alive()]
    assert alive == []


# -- the permanent gate ----------------------------------------------------


@pytest.fixture(scope="module")
def gate():
    """One run of every rule over ``veles_torch/`` and ``chip_smoke.py``:
    -> (findings, per-rule stats)."""
    stats = []
    found = port_core.analyze_paths(
        [os.path.join(REPO, "veles_torch"),
         os.path.join(REPO, "chip_smoke.py")], base=REPO, stats=stats)
    return found, stats


def test_port_wide_zero_findings_gate(gate):
    """THE gate: the whole port and chip_smoke.py stay at zero findings.
    ``python -m veles_torch lint veles_torch chip_smoke.py`` reproduces a
    failure with file:line and a fix hint; fix the code, or pragma the
    line with ``# zlint: disable=RULE (reason)``."""
    found, stats = gate
    assert found == [], "zlint found %d violation(s):\n%s" % (
        len(found), "\n".join(f.render() for f in found))
    assert sorted(r["rule"] for r in stats) == list(RULE_IDS)
    assert all(r["fresh_modules"] > 100 for r in stats)


@pytest.mark.parametrize("plant", ["unit_body_sync", "unit_counter",
                                   "registry_outside_try"])
def test_gate_would_catch_a_regression(tmp_path, plant):
    """The gate is falsifiable: a violation planted in a copy of a real
    module of the port is caught (a host sync and a host counter in a
    GD unit's run; the serving registry built outside its try again)."""
    if plant == "registry_outside_try":
        rel = "veles_torch/serving/frontend.py"
        rule = "resource-leak"
        with open(os.path.join(REPO, rel)) as f:
            src = f.read()
        start = src.index("        registry = ModelRegistry(")
        end = src.index("device=args.device)\n", start) + len(
            "device=args.device)\n")
        ctor = src[start:end]
        src = src[:start] + src[end:]
        anchor = "    registry = front = status = None\n"
        src = src.replace(anchor, "\n".join(
            line[4:] for line in ctor.splitlines()) + "\n"
            + "    front = status = None\n")
    else:
        rel = "veles_torch/znicz/ops/gd.py"
        rule = "tracer-purity"
        with open(os.path.join(REPO, rel)) as f:
            src = f.read()
        anchor = "    def run(self, x, y, err):\n"
        planted = ("        print(float(err.sum()))\n"
                   if plant == "unit_body_sync"
                   else "        self.steps += 1\n")
        assert anchor in src
        src = src.replace(anchor, anchor + planted)
    path = tmp_path / rel
    path.parent.mkdir(parents=True)
    path.write_text(src)
    found = port_core.analyze_paths([str(path)], base=str(tmp_path),
                                    select=[rule])
    assert found, "planted violation must be caught"
    clean = port_core.analyze_paths([os.path.join(REPO, rel)], base=REPO,
                                    select=[rule])
    assert clean == []
