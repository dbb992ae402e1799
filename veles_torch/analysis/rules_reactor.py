"""reactor-purity: reactor callbacks must never block the loop.

The process runs ONE selector loop (``veles_torch/reactor.py``) under the
training wire plane, web-status and the serving frontend. Anything
that parks a callback parks EVERY connection, every probe and every
timer with it — the exact failure the thread-per-connection design
could hide (one stuck thread stalled one slave; one stuck callback
stalls the cluster's whole control surface).

This rule finds code that runs ON the loop — via the shared
:func:`veles_torch.analysis.engine.reactor_callbacks` enumeration (methods
named ``on_frame``/``on_timer`` and the function targets of
``call_soon``/``call_later``/``every``/``post``) — and flags blocking
primitives inside them:

* raw-socket waits: ``recv``/``recv_into``/``recvfrom``/``sendall``/
  ``accept``/``create_connection`` (loop callbacks hand bytes to the
  connection's bounded write queue instead);
* ``time.sleep`` (schedule a timer instead);
* thread parking: ``Event.wait``/``Condition.wait``/``Thread.join``
  (``join`` is flagged only in its no-positional-arg / ``timeout=``
  shapes, so ``", ".join(parts)`` stays quiet);
* network fetches: ``urlopen``/``urlretrieve``.

Taking the existing short-lived locks (the master's request lock) is
deliberately NOT flagged: that is the same serialization the
thread-per-connection design had, and the ``lock-order`` rule already
polices the discipline itself.
"""

from veles_torch.analysis import engine
from veles_torch.analysis.core import Finding, register

_BLOCKING = frozenset((
    "recv", "recv_into", "recvfrom", "sendall", "accept",
    "create_connection", "sleep", "wait", "urlopen", "urlretrieve",
))


def _blocking_name(node):
    """The banned primitive ``node`` calls, or None. ``join`` needs
    disambiguation: ``Thread.join()``/``Thread.join(timeout=2)`` have
    no positional args while ``str.join`` always takes exactly one —
    the 1-positional-arg spelling is left alone (documented gap:
    ``t.join(5)``)."""
    name = engine.call_name(node)
    if name in _BLOCKING:
        return name
    if name == "join" and not node.args:
        return name
    return None


def _scan_callback(mod, node, where, findings, seen):
    for sub, name in engine.novel_calls(mod, node, seen,
                                        _blocking_name):
        findings.append(Finding(
            mod.relpath, sub.lineno, "reactor-purity", "error",
            "blocking call %r inside reactor callback %s — one "
            "parked callback stalls every connection, probe and "
            "timer on the shared loop" % (name, where),
            "hand the wait to a worker thread (reply via call_soon) "
            "or reschedule with a reactor timer; the loop owns "
            "sockets, threads own waiting"))


@register("reactor-purity", "error",
          "reactor callbacks (on_frame/on_timer, call_soon/call_later"
          "/every targets) must not call blocking primitives — no "
          "raw-socket recv/sendall/accept, sleep, Event.wait/"
          "Thread.join, urlopen")
def check_reactor_purity(project):
    findings = []
    seen = set()
    for mod, _cls, func, where in engine.reactor_callbacks(project):
        _scan_callback(mod, func, where, findings, seen)
    return findings
