"""The slave client of the port: pulls jobs, runs them on its device,
pushes updates.

The port's own copy of ``veles/client.py``, on the same wire
(``server.py``): connect and handshake, then loop { request a job;
apply its per-unit payloads (the loader gets a minibatch index list, the
GD units get the master's weights, written in place into their device
tensors); run the one minibatch on the card (``TorchStep.run_job``);
push the per-unit updates (parameter deltas against the decoded basis,
through the negotiated codec) }. It works under a port master and under
a reference master alike.

Fault tolerance: the client holds a master-minted lease ``(slave_id,
lease_id)`` and tags every request with it. A ``("stale",)`` response
means the master revoked the lease (the slave was dropped and its work
requeued): the client abandons it and re-hellos. A socket failure,
timeout or protocol desync reconnects with exponential backoff and
jitter (capped retries), so :meth:`SlaveClient.run_forever` survives
master restarts and flaky networks; a run of successful work resets the
budget. A send-only heartbeat thread pings whenever the socket has been
idle for ``ping_interval`` (while parked on ``("wait",)`` and during a
long job), so the master's ``slave_timeout`` measures silence, not
compute time. Whole-frame sends are serialized by ``_io_lock`` and the
main thread is the only reader: ``_roundtrip`` drains the pongs owed to
heartbeat pings before taking its own response.
"""

import os
import random
import secrets
import socket
import threading
import time

from veles_torch import telemetry
from veles_torch.distributable import DistributionRegistry
from veles_torch.logger import Logger
from veles_torch.server import send_frame, recv_frame, require_secret_for

#: counter families a slave must NOT push to its master: the master
#: owns these names in its own registry (and in co-located test runs
#: both sides share one registry — echoing them back would manufacture
#: fake slave-labelled cluster series)
_NO_PUSH_PREFIXES = ("veles_cluster_", "veles_master_")

#: PER-PROCESS push token: the counter state a client pushes is the
#: process-wide registry, so the master's dedup baseline must be
#: per-process too — two SlaveClients threading in one process (chaos
#: tests) each push the shared totals, and a per-CLIENT token would
#: absorb them twice. Stable across reconnects/re-hellos by
#: construction. (Per-slave attribution is inherently approximate for
#: co-located clients — they share one registry — but sums stay
#: exact; separate-process slaves keep exact attribution.)
_PUSH_TOKEN = secrets.token_hex(8)


class StaleLease(ConnectionError):
    """Master fenced us: the lease is revoked — re-hello, don't retry
    the same identity."""


class ProtocolDesync(ConnectionError):
    """Response doesn't match the request in flight (e.g. a network
    middlebox duplicated a frame): the req/resp pairing is lost, the
    only safe move is a fresh connection."""


class SlaveClient(Logger):
    def __init__(self, workflow, address, name=None, io_timeout=30.0,
                 retry_base=0.05, retry_max=2.0, max_retries=8,
                 ping_interval=1.0, grad_codec="none",
                 grad_topk_percent=1.0):
        from veles_torch import compression
        self.name = name or "SlaveClient"
        self.workflow = workflow
        #: gradient wire codec OFFERED at hello (the master's config
        #: wins — see server.py's negotiation); validated here so
        #: a typo fails at construction, not at the first sync
        self.grad_codec = str(grad_codec or "none")
        if self.grad_codec not in compression.CODEC_NAMES:
            raise ValueError(
                "unknown grad codec %r (known: %s)"
                % (grad_codec, ", ".join(compression.CODEC_NAMES)))
        self.grad_topk_percent = float(grad_topk_percent)
        #: the codec actually negotiated (welcome's 4th element);
        #: tracked so a re-hello under the SAME codec keeps the
        #: error-feedback residuals instead of resetting them
        self._codec_active = None
        self.codec_fallbacks = 0
        #: True while talking to a pre-OOB master (detected per
        #: connection: a codec-aware hello always earns a 4-tuple
        #: welcome from a new master, so a 3-tuple back means OLD —
        #: pin our sends to legacy monolithic frames it can read)
        self._legacy_frames = False
        host, _, port = str(address).rpartition(":")
        self.address = (host or "127.0.0.1", int(port))
        require_secret_for(self.address[0], "slave master")
        self.registry = DistributionRegistry(workflow)
        #: called with each job's payload before it is applied, and with
        #: None when the loop ends (a slave of several ranks: rank 0
        #: relays every job to the others, ``parallel.relay_jobs``)
        self.relay = None
        self.sock = None
        self.slave_id = None
        self.lease_id = None
        self.jobs_done = 0
        #: serializes whole-frame SENDS (and the pending-pong count):
        #: the heartbeat thread can ping while the main thread
        #: computes — or even between the main thread's send and
        #: recv — without ever interleaving bytes mid-frame. Reads
        #: are unserialized because the main thread is the ONLY
        #: reader (see the module docstring).
        self._io_lock = threading.Lock()
        self._hb_stop = None
        self._last_io = 0.0
        #: pings sent whose pongs the main reader has not yet drained
        #: (guarded by _io_lock; reset per connection)
        self._pending_pongs = 0
        #: per-request socket deadline — a silent master (or a dropped
        #: frame) unblocks here instead of hanging the slave forever
        self.io_timeout = float(io_timeout)
        #: reconnect policy: sleep retry_base·2^k (capped at
        #: retry_max, +0..25 % jitter so a restarted master isn't
        #: stampeded) for up to max_retries consecutive failures.
        #: ``None`` retries FOREVER — the right setting under a
        #: preemptible master (k8s reschedule takes minutes; a slave
        #: that gives up turns every master restart into lost capacity)
        self.retry_base = float(retry_base)
        self.retry_max = float(retry_max)
        self.max_retries = None if max_retries is None \
            else int(max_retries)
        #: heartbeat period while the master says ("wait",)
        self.ping_interval = float(ping_interval)
        #: preemption stop: request_stop() makes run_forever return
        #: after the in-flight job instead of requesting another
        self._stop = threading.Event()
        #: robustness counters (mirrors MasterServer.faults)
        self.reconnects = 0
        self.stale_resyncs = 0
        self.pings_sent = 0
        # telemetry: local mirrors of the attribute counters, plus the
        # last counter state acknowledged by the master (deltas against
        # it ride each update frame — see _telemetry_delta)
        self._tele = {
            key: telemetry.LazyChild(
                lambda name=name, help=help: telemetry.counter(
                    name, help))
            for key, name, help in (
                ("jobs", "veles_slave_jobs_done_total",
                 "Jobs completed and acknowledged by the master"),
                ("reconnects", "veles_slave_reconnects_total",
                 "Reconnect/re-hello cycles"),
                ("stale", "veles_slave_stale_resyncs_total",
                 "Lease revocations noticed (fenced responses)"),
                ("codec_fallback", "veles_slave_codec_fallbacks_total",
                 "Hellos where the master declined this slave's grad "
                 "codec and the sync fell back to 'none'"),
            )}
        #: stable token identifying this PROCESS's counter stream
        #: across re-hellos: the master diffs pushed absolute state
        #: per token, so a lost ok-ack (state absorbed, ack dropped,
        #: slave re-pushes under a fresh slave_id) or co-located
        #: clients pushing the same shared registry can never double-
        #: count — see MasterServer._absorb_telemetry
        self._push_token = _PUSH_TOKEN

    def connect(self):
        self.sock = socket.create_connection(self.address,
                                             timeout=self.io_timeout)
        self.sock.settimeout(self.io_timeout)
        send_frame(self.sock, ("hello", self.name, self.grad_codec))
        welcome = recv_frame(self.sock)
        # no asserts: they vanish under ``python -O`` and a bad
        # handshake must fail LOUDLY either way
        if welcome is None:
            raise ConnectionError(
                "master %s:%d closed the connection during handshake"
                % self.address)
        if not isinstance(welcome, tuple) or len(welcome) < 3 \
                or welcome[0] != "welcome":
            raise ConnectionError(
                "bad handshake from master %s:%d: expected "
                "('welcome', slave_id, lease_id), got %r"
                % (self.address + (welcome,)))
        self.slave_id, self.lease_id = welcome[1], welcome[2]
        self._legacy_frames = len(welcome) < 4
        self._adopt_codec(
            welcome[3] if len(welcome) > 3 else "none",
            welcome[4] if len(welcome) > 4 else None)
        # under the io lock: a previous connection's heartbeat thread
        # may still be mid-send and writes _last_io on exit — both
        # writers hold the lock, so the fresher timestamp wins
        # deterministically instead of racing
        with self._io_lock:
            self._last_io = time.monotonic()
            self._pending_pongs = 0
        self._start_heartbeat()
        return self

    def _adopt_codec(self, chosen, topk_percent=None):
        """Install the codec the master chose for this lease. A
        fallback (master config wins — old master, different config)
        is warned and counted, never fatal: the slave keeps training,
        uncompressed. The master's ``topk_percent`` rides the welcome
        and wins too — a locally-configured K would silently change
        how much of each delta ships. A re-hello under the SAME
        (codec, K) keeps the encoder instance, so the error-feedback
        residuals survive reconnects; a change discards them (they
        compensate a quantizer that no longer exists)."""
        from veles_torch import compression
        if chosen != self.grad_codec:
            self.codec_fallbacks += 1
            self._tele["codec_fallback"].get().inc()
            self.warning(
                "master negotiated grad codec %r (this slave asked "
                "for %r) — syncing uncompressed", chosen,
                self.grad_codec)
        k = self.grad_topk_percent if topk_percent is None \
            else float(topk_percent)
        if k != self.grad_topk_percent:
            self.info("master imposed topk_percent %g (this slave "
                      "was configured with %g)", k,
                      self.grad_topk_percent)
        if (chosen, k) != self._codec_active:
            self.workflow.grad_codec = compression.get_codec(
                chosen, k)
            self._codec_active = (chosen, k)

    def _start_heartbeat(self):
        """Best-effort liveness pings whenever the socket has been
        idle for ``ping_interval`` — covers both ("wait",) parking and
        LONG LOCAL ITERATIONS, so the master's slave_timeout measures
        silence, not compute time. The thread is pinned to THIS
        connection's socket and is SEND-ONLY: it emits the whole ping
        frame under the io lock (never interleaving bytes mid-frame
        with an in-flight update send) and NEVER reads — the main
        thread is the sole reader and drains the owed pongs before
        its own responses (see ``_roundtrip``). Errors just stop the
        beat: the main loop's next round-trip surfaces them with full
        reconnect handling."""
        if self.ping_interval <= 0:
            return
        self._hb_stop = stop = threading.Event()
        sock = self.sock

        def beat():
            while not stop.wait(self.ping_interval):
                try:
                    if time.monotonic() - self._last_io \
                            < self.ping_interval:
                        continue
                    with self._io_lock:
                        if self.sock is not sock or stop.is_set():
                            return
                        send_frame(sock, ("ping", self.slave_id,
                                          self.lease_id))
                        self._pending_pongs += 1
                        self._last_io = time.monotonic()
                    self.pings_sent += 1
                except Exception:
                    return
        threading.Thread(target=beat, daemon=True,
                         name="%s-heartbeat" % self.name).start()

    def _check_mode(self):
        """A slave serves the minibatch the MASTER assigns per job
        through its step's one-job entry (``TorchStep.run_job``), so the
        workflow must be initialized before the first job."""
        if getattr(self.workflow, "step", None) is None:
            raise ValueError(
                "slave workflow %r is not initialized (no step): "
                "initialize it before run_forever()"
                % getattr(self.workflow, "name", self.workflow))

    def _roundtrip(self, request):
        sock = self.sock
        with self._io_lock:
            send_frame(sock, request, legacy=self._legacy_frames)
            self._last_io = time.monotonic()
        # reads are lock-free: this thread is the ONLY reader.
        # Responses arrive in request order, so any pongs owed to
        # heartbeat pings sent BEFORE our request drain first; a pong
        # we never paid for is a genuine desync.
        while True:
            resp = recv_frame(sock)
            with self._io_lock:
                self._last_io = time.monotonic()
                if resp is not None and isinstance(resp, tuple) \
                        and resp and resp[0] == "pong":
                    if self._pending_pongs > 0:
                        self._pending_pongs -= 1
                        continue
                    raise ProtocolDesync(
                        "unsolicited pong (no heartbeat ping "
                        "outstanding)")
            break
        if resp is None:
            raise ConnectionError("master closed the connection")
        if resp == ("stale",):
            self.stale_resyncs += 1
            self._tele["stale"].get().inc()
            telemetry.record_event(
                "lease_stale", request=str(request[0]),
                slave=self.slave_id)
            raise StaleLease(
                "master fenced %r for slave %s — lease %s revoked"
                % (request[0], self.slave_id, self.lease_id))
        return resp

    def run_one(self):
        """Request + run one job; False when the master says stop."""
        self._check_mode()
        resp = self._roundtrip(("job", self.slave_id, self.lease_id))
        if resp[0] == "bye":
            return False
        if resp[0] == "wait":
            time.sleep(0.02)
            return True
        if resp[0] != "job" or len(resp) < 4:
            raise ProtocolDesync(
                "expected a job, got %r" % (resp[:1],))
        _, payload, job_id, epoch = resp[:4]
        # the master-minted trace context (5th element; absent from a
        # master without job traces): every phase span below joins
        # that trace
        ctx = telemetry.TraceContext.from_wire(resp[4]) \
            if len(resp) > 4 else None
        spans = []
        # bind the job's trace for the whole local iteration: log
        # lines emitted while computing on its behalf carry the ids
        # and join /debug/trace spans
        with telemetry.context(ctx):
            t0 = time.perf_counter()
            if self.relay is not None:
                self.relay(payload)
            self.registry.apply_job(payload)
            t1 = time.perf_counter()
            self._job_span(spans, ctx, "slave.apply", t0, t1 - t0,
                           job_id)
            self._run_iteration()
            t2 = time.perf_counter()
            self._job_span(spans, ctx, "slave.compute", t1, t2 - t1,
                           job_id)
        # count the job BEFORE building the pushed state: the state
        # rides the update that completes this very job, so the master
        # sees N jobs after N accepted updates (post-ack counting
        # would lag by one forever — the final job's increment has no
        # later update to ride). If THIS update is fenced/lost the
        # master doesn't absorb, and the next accepted push carries
        # the cumulative value — at-least-once on the fault path,
        # exact on the fault-free one.
        self._tele["jobs"].get().inc()
        update = self.registry.generate_update()
        t3 = time.perf_counter()
        self._job_span(spans, ctx, "slave.update_build", t2, t3 - t2,
                       job_id)
        tele = self._telemetry_state() or {"token": self._push_token}
        # total job wall time: what the master subtracts from its
        # serve→update round-trip to attribute the WIRE portion
        tele["job_seconds"] = t3 - t0
        # model-health summary: compact per-layer stats +
        # verdict ride the same __telemetry__ side channel, so the
        # master republishes them slave-labelled and ONE scrape sees
        # cluster-wide training health. Skipped while this process
        # has no observations yet (nothing to ship).
        from veles_torch import model_health
        summary = model_health.get_model_monitor().push_summary()
        if summary["layers"] or summary["loss"] is not None:
            tele["model"] = summary
        if spans:
            tele["spans"] = spans
        update["__telemetry__"] = tele
        ok = self._roundtrip(
            ("update", self.slave_id, self.lease_id, job_id, epoch,
             update))
        if ok[0] != "ok":
            raise ProtocolDesync("expected ok, got %r" % (ok[:1],))
        self.jobs_done += 1
        return True

    def _job_span(self, spans, ctx, name, start, duration, job_id):
        """Append one completed job-phase span to the SHIPPED list
        (wall-clock anchored so the master can merge it into its own
        timeline). Not recorded into the local tracer: the master's
        absorb is the single recording point, so a co-located
        master+slave pair (shared tracer) never sees duplicates."""
        args = {"job_id": job_id, "slave": self.slave_id}
        if ctx is not None:
            args.update(ctx.child().span_args())
        spans.append({
            "name": name,
            "wall": time.time() - (time.perf_counter() - start),
            "dur": duration, "pid": os.getpid(),
            "tid": threading.get_ident(), "args": args})

    def _telemetry_state(self):
        """The ABSOLUTE counter state pushed on each update — what
        makes one scrape of the master show the whole cluster. Absolute
        values + the stable token make the push idempotent: the master
        increments by the per-token diff, so retransmits after a lost
        ack (or a re-hello) are no-ops rather than double counts."""
        state = telemetry.get_registry().counter_state(
            exclude_prefixes=_NO_PUSH_PREFIXES,
            exclude_label_keys=("slave",))
        if not state:
            return None
        return {"token": self._push_token, "state": state}

    def _run_iteration(self):
        """One forward/backward/update pass over the minibatch the
        master assigned (already applied into the loader), on the step's
        device; the master's weights were written into the device
        tensors in place by the GD units' ``apply_data_from_master``,
        and the step leaves one host copy of the trained parameters for
        ``generate_data_for_master``."""
        self.workflow.step.run_job()

    def _close_sock(self):
        if self._hb_stop is not None:
            self._hb_stop.set()
            self._hb_stop = None
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def _backoff(self, attempt):
        # clamp the exponent: with max_retries=None attempt grows
        # without bound, and 2**1030 no longer converts to float —
        # retry_max caps the delay long before 2**32 anyway
        delay = min(self.retry_max,
                    self.retry_base * (2.0 ** min(32, max(0, attempt - 1))))
        return delay * (1.0 + 0.25 * random.random())

    def run_forever(self):
        """Pump jobs until the master says ``bye``, surviving master
        restarts, revoked leases and connection hiccups: reconnect +
        re-hello with exponential backoff, giving up only after
        ``max_retries`` consecutive failures without progress.
        :meth:`request_stop` (the Launcher's SIGTERM relay) breaks the
        loop at the next job boundary — a preempted slave exits
        cleanly instead of pulling jobs for the whole grace period."""
        attempt = 0
        while not self._stop.is_set():
            try:
                if self.sock is None:
                    self.connect()
                if not self.run_one():
                    break
                attempt = 0           # progress resets the budget
            except (ConnectionError, OSError) as exc:
                # socket.timeout is an OSError; StaleLease and
                # ProtocolDesync are ConnectionErrors. A StaleLease is
                # the normal zombie outcome (the master already
                # requeued our in-flight work when it dropped us), the
                # rest are network trouble — either way the old
                # identity is abandoned cleanly (id/lease zeroed so no
                # further frame can reuse them) and we re-hello, with
                # the same consecutive-failure budget guarding against
                # a master that fences or drops us forever.
                attempt += 1
                if self.max_retries is not None \
                        and attempt > self.max_retries:
                    self._close_sock()
                    raise ConnectionError(
                        "giving up on master %s:%d after %d failed "
                        "attempts (last: %s)"
                        % (self.address + (attempt - 1, exc)))
                self.warning(
                    "%s: %s; re-sync %d/%s", type(exc).__name__, exc,
                    attempt, "inf" if self.max_retries is None
                    else self.max_retries)
                self._resync(attempt)
        self._close_sock()
        self.info("slave done after %d jobs (%d reconnects, %d stale "
                  "re-syncs)", self.jobs_done, self.reconnects,
                  self.stale_resyncs)
        return self.jobs_done

    def request_stop(self):
        """Preemption (Launcher SIGTERM): finish the in-flight job,
        then return from run_forever instead of requesting another —
        the master requeues anything unmerged when the connection
        drops. Signal-safe: one Event.set, no locks, no I/O."""
        self._stop.set()

    def _resync(self, attempt):
        self._close_sock()
        self.slave_id = self.lease_id = None
        self.reconnects += 1
        self._tele["reconnects"].get().inc()
        telemetry.record_event("reconnect", name=self.name,
                               attempt=attempt)
        # interruptible backoff: a preempted slave must exit now, not
        # after its reconnect sleep runs out
        self._stop.wait(self._backoff(attempt))
