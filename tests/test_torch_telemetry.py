"""The port's telemetry core (veles_torch/telemetry.py) against the JAX
package's (veles/telemetry.py): the same observations into both
registries render the same Prometheus text, family for family; a
``traceparent`` minted by either package parses in the other; both
tracers' dumps and flight windows have the same Perfetto shape; the
debug routes answer the same, ``/debug/critical_path`` included, and
``/debug/profile`` is left to the frontends in both (its capture blocks,
so they defer it)."""

import json

import numpy
import pytest

from veles import telemetry as J
from veles_torch import telemetry as T


def _observe(tel, values):
    c = tel.counter("veles_serving_requests_total", "Requests submitted",
                    ("model",))
    g = tel.gauge("veles_serving_queue_rows", "Rows pending", ("model",))
    h = tel.histogram("veles_serving_latency_seconds", "Latency",
                      ("model",))
    plain = tel.counter("veles_checkpoint_bytes_total", "Bytes")
    for i, v in enumerate(values):
        model = "m%d" % (i % 3)
        c.labels(model).inc()
        g.labels(model).set(v * 10)
        h.labels(model).observe(v)
        plain.inc(int(v * 1000))
    tel.gauge("veles_serving_model_version", "Version",
              ("model",)).labels('we"ird\\name').set_function(lambda: 2)


#: the families _observe makes (a live reactor or health monitor of
#: another test may add its own to the active registry meanwhile)
OBSERVED = ("veles_serving_requests_total", "veles_serving_queue_rows",
            "veles_serving_latency_seconds", "veles_checkpoint_bytes_total",
            "veles_serving_model_version")


def _families(text):
    out, cur = {}, None
    for line in text.splitlines():
        if line.startswith("# HELP "):
            cur = line.split()[2]
            out[cur] = []
        out[cur].append(line)
    return {name: lines for name, lines in out.items() if name in OBSERVED}


@pytest.mark.parametrize("n", [1, 7, 300])
def test_prometheus_text_equal_family_for_family(n):
    values = numpy.random.default_rng(n).exponential(0.05, n).tolist()
    with J.scoped() as jr, T.scoped() as tr:
        _observe(J, values)
        _observe(T, values)
        jtext, ttext = jr.render_prometheus(), tr.render_prometheus()
        assert jr.CONTENT_TYPE == tr.CONTENT_TYPE
        jf, tf = _families(jtext), _families(ttext)
        assert sorted(jf) == sorted(tf) == sorted(OBSERVED)
        for name in jf:
            assert jf[name] == tf[name], name
        for q in (0.5, 0.99):
            assert J.histogram("veles_serving_latency_seconds", "",
                               ("model",)).labels("m0").percentile(q) \
                == T.histogram("veles_serving_latency_seconds", "",
                               ("model",)).labels("m0").percentile(q)
        assert jr.counter_total("veles_serving_requests_total") == \
            tr.counter_total("veles_serving_requests_total") == n


def test_lazy_child_follows_the_active_registry():
    child = T.LazyChild(lambda: T.counter("veles_x_total", "x"))
    with T.scoped() as first:
        child.get().inc(3)
        with T.scoped() as second:
            child.get().inc()
            assert second.counter_total("veles_x_total") == 1
        assert first.counter_total("veles_x_total") == 3


@pytest.mark.parametrize("mint,parse", [(J, T), (T, J)],
                         ids=["ref->port", "port->ref"])
def test_traceparent_round_trips_between_packages(mint, parse):
    ctx = mint.TraceContext.new().child()
    back = parse.TraceContext.from_traceparent(ctx.to_traceparent())
    assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
    assert back.to_traceparent() == ctx.to_traceparent()
    for bad in (None, "", "00-zz-yy-01", "00-%s-%s" % ("a" * 32, "b" * 16),
                "00-%s-%s-01" % ("g" * 32, "b" * 16)):
        assert parse.TraceContext.from_traceparent(bad) is None
        assert mint.TraceContext.from_traceparent(bad) is None


def _shape(ev):
    return (ev.get("ph"), sorted(ev), sorted(ev.get("args", {})))


def _spans(tel):
    tracer = tel.Tracer()
    tracer.set_process_name("serving")
    tracer.start()
    ctx = tel.TraceContext("ab" * 16, "cd" * 8)
    with tracer.span("serving.execute", model="m", **ctx.span_args()):
        pass
    tracer.add_complete("torch.dispatch.train", 0.0, 0.5, warm=True,
                        minibatches=4)
    tracer.record_event("checkpoint_written", name="a.ckpt", slot="best")
    tracer.stop()
    return tracer


def test_tracer_dumps_have_the_same_perfetto_shape(tmp_path):
    jt, tt = _spans(J), _spans(T)
    docs = []
    for tracer, name in ((jt, "j.json"), (tt, "t.json")):
        tracer.dump(str(tmp_path / name))
        docs.append(json.load(open(str(tmp_path / name))))
    assert sorted(docs[0]) == sorted(docs[1])
    assert [_shape(e) for e in docs[0]["traceEvents"]] == \
        [_shape(e) for e in docs[1]["traceEvents"]]
    fj, ft = jt.flight_doc(), tt.flight_doc()
    assert sorted(fj) == sorted(ft)
    assert [_shape(e) for e in fj["traceEvents"]] == \
        [_shape(e) for e in ft["traceEvents"]]
    ej, et = jt.recent_events(), tt.recent_events()
    assert [sorted(e) for e in ej] == [sorted(e) for e in et]


def test_debug_routes_answer_as_the_reference():
    for path in ("/debug/trace?window=5", "/debug/events?limit=3"):
        assert sorted(J.debug_endpoint(path)) == \
            sorted(T.debug_endpoint(path))
    assert T.debug_endpoint("/debug/nope") is None
    path = "/debug/critical_path?window=3"
    assert sorted(J.debug_endpoint(path)) == sorted(T.debug_endpoint(path))
    assert J.debug_endpoint("/debug/profile") is None
    assert T.debug_endpoint("/debug/profile") is None
