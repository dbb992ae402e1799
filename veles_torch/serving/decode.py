"""Generative decode serving of the port: KV pool + continuous batching.

Counterpart of ``veles/serving/decode.py``:

* **KV pool** (:class:`KVPool`) — every attention layer's K and V for up
  to ``n_slots`` concurrent sequences live in ONE preallocated f32
  tensor each, ``(n_slots, H, max_len, dh)``, on the engine's device. A
  sequence is admitted by granting a slot index; prefill writes the
  slot's whole K/V row, each decode step writes one position per slot,
  in place (the pool is never reallocated), and a finished sequence
  returns its index to the free list.

* **Engine** (:class:`GenerativeEngine`) — a prefill per power-of-two
  PROMPT bucket (the causal forward over the right-padded prompt, the
  first token sampled at the true last position, the slot's K/V row
  written) and ONE shared decode step over the whole pool (every slot
  advances one position: the per-sequence position vector of
  ``model.attn_decode``, which ``veles_torch/znicz/generate.py`` decodes
  with too). Eager PyTorch in f32, on
  the same formulas as ``model.py`` and ``generate.py``; a CUDA graph of
  the step waits for ROADMAP Queue 1 item 1.

  Right padding is sound under causal attention: a pad position can only
  reach positions after the prompt, and those are overwritten (K/V
  written at ``pos``) or masked (``arange > pos``) before a query reads
  them.

* **Continuous batcher** (:class:`ContinuousBatcher`) — the decode loop:
  requests join the in-flight decode batch at step boundaries, EOS /
  ``max_tokens`` / cancelled sequences free their slots mid-flight, the
  queue is bounded (:class:`QueueFull`) and requests that expire while
  queued never reach prefill. All device work happens on its one worker
  thread, under ``torch.no_grad()``; request threads only enqueue.

  KV slots are granted least virtual finish tag first (a sequence's
  cost is prompt + token budget over its tenant's weight,
  ``tenants.py``), so one tenant's burst cannot take the whole decode
  batch; with one tenant, or no tenant table, grants are first in first
  out. A :class:`GenRequest` streams through ``set_on_token`` /
  ``set_on_done`` callbacks (the HTTP frontend's chunked ndjson).

Instruments (labelled by model, on the port's telemetry registry):
``veles_serving_decode_*``, ``veles_serving_kv_pool_slots`` /
``veles_serving_kv_slots_in_use``, ``veles_serving_generated_tokens_total``,
``veles_serving_first_token_seconds`` and
``veles_serving_tenant_tokens_total{tenant}``; a ``serving.decode`` span
per finished sequence in the caller's trace. :meth:`ContinuousBatcher.
metrics` is the batcher's own JSON view (``counts``).
"""

import collections
import logging
import threading
import time

import numpy
import torch

from veles_torch import telemetry
from veles_torch.backends import bind_thread, torch_device
from veles_torch.serving.batcher import (
    DeadlineExceeded, QueueFull, timeout_seconds)
from veles_torch.serving.engine import bucket_sizes
from veles_torch.serving.model import (
    FORWARD_OPS, attention_kv, attn_decode, block_decode, stack_kv)
from veles_torch.serving import tenants
from veles_torch.serving.quant import dense_params, gather_rows

log = logging.getLogger("veles_torch.serving")

#: decoded tokens by resolved tenant (label values are resolver output)
_T_TOKENS = telemetry.LazyChild(
    lambda: telemetry.counter(
        "veles_serving_tenant_tokens_total",
        "Tokens decoded by resolved tenant", ("tenant",)))

#: unit types that are sequence-free at decode time
_TOKEN_TYPES = frozenset({
    "layernorm", "token_dense", "token_dense_relu", "transformer_ffn",
    "moe_ffn", "activation_tanh", "activation_relu", "activation_str",
    "activation_sigmoid",
})

#: default per-request decode budget when the client sends none
DEFAULT_MAX_TOKENS = 16

#: seconds without a completed step, while sequences are active, before
#: healthy() reports the loop wedged
WEDGE_AFTER_S = 60.0


class DecodePlan:
    """Ordered decode walk over an :class:`ArchiveModel`'s unit specs:
    ``steps`` is ``(kind, spec, cache_index)`` with kinds ``embed`` /
    ``attn`` / ``stack`` (a stacked block: one cache per inner layer, from
    ``cache_index`` on) / ``token``. Raises ValueError for archives that
    cannot generate (no leading embedding, non-causal attention, other
    unit types)."""

    def __init__(self, steps, cache_specs, dim, vocab):
        self.steps = steps
        #: (heads, head_dim) of each attention layer (a stack's inner
        #: layers each count)
        self.cache_specs = cache_specs
        self.dim = dim
        self.vocab = vocab

    @property
    def n_caches(self):
        return len(self.cache_specs)

    @classmethod
    def from_archive(cls, model):
        specs = model.units
        if not specs or specs[0]["type"] != "embedding":
            raise ValueError(
                "not a generative archive: the first unit must be an "
                "embedding (got %s)"
                % (specs[0]["type"] if specs else "no units"))
        emb = specs[0]
        dim = int(emb["config"]["dim"])
        vocab = int(emb["config"]["vocab_size"])
        steps = [("embed", emb, None)]
        cache_specs = []
        for spec in specs[1:]:
            t = spec["type"]
            cfg = spec.get("config", {})
            if t == "attention":
                if not cfg.get("causal"):
                    raise ValueError("%s: generation needs causal "
                                     "attention" % spec["name"])
                steps.append(("attn", spec, len(cache_specs)))
                cache_specs.append((int(cfg["heads"]),
                                    dim // int(cfg["heads"])))
            elif t == "transformer_stack":
                if not cfg.get("causal"):
                    raise ValueError("%s: generation needs causal "
                                     "attention" % spec["name"])
                steps.append(("stack", spec, len(cache_specs)))
                heads = int(cfg["heads"])
                cache_specs.extend([(heads, dim // heads)]
                                   * int(cfg["layers"]))
            elif t == "dropout":
                continue            # identity at inference
            elif t in _TOKEN_TYPES:
                steps.append(("token", spec, None))
            else:
                raise ValueError("cannot decode through unit %s (type %r)"
                                 % (spec.get("name"), t))
        return cls(steps, cache_specs, dim, vocab)

    @classmethod
    def probe(cls, model):
        """True iff the archive can generate."""
        try:
            cls.from_archive(model)
            return True
        except ValueError:
            return False

    def positions_limit(self, params):
        """Longest sequence the exported positions table supports (None:
        no positional embedding)."""
        pos = params.get(self.steps[0][1]["name"], {}).get("positions")
        return None if pos is None else int(pos.shape[0])


class KVPool:
    """One preallocated (n_slots, H, max_len, dh) f32 K and V tensor per
    attention layer on ``device``; slots are granted and released by
    index. Stale K/V in a released slot is harmless: the next prefill
    writes the whole row and the position mask hides the rest. Not
    thread-safe by itself: the continuous batcher serializes grants and
    releases under its lock."""

    def __init__(self, cache_specs, n_slots, max_len, device):
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.K = [torch.zeros((self.n_slots, h, self.max_len, dh),
                              dtype=torch.float32, device=device)
                  for h, dh in cache_specs]
        self.V = [torch.zeros_like(k) for k in self.K]
        self._free = list(range(self.n_slots - 1, -1, -1))

    def grant(self):
        return self._free.pop() if self._free else None

    def release(self, slot):
        self._free.append(slot)

    @property
    def free_slots(self):
        return len(self._free)

    @property
    def in_use(self):
        return self.n_slots - len(self._free)

    def nbytes(self):
        """Bytes of the preallocated pool (K and V of every layer)."""
        return sum(k.numel() * 4 for k in self.K) * 2


def _sample_tokens(logits, temp, generator):
    """Per-row sampling with a per-sequence temperature (``temp``, a host
    vector): rows at temperature 0 take the argmax, the others draw from
    the softmax at their own temperature."""
    greedy = torch.argmax(logits, dim=-1)
    temp = numpy.asarray(temp, numpy.float32)
    if not (temp > 0).any():
        return greedy
    t = torch.from_numpy(temp).to(logits.device)
    sampled = torch.multinomial(
        torch.softmax(logits / t.clamp_min(1e-6)[:, None], dim=-1), 1,
        generator=generator)[:, 0]
    return torch.where(t > 0, sampled, greedy)


class GenerativeEngine:
    """Prefill/decode executor + KV pool for ONE generative
    :class:`ArchiveModel`, on ``device`` (``cuda`` unless ``cpu`` is
    asked for). Its device work runs on the continuous batcher's worker
    thread; only :meth:`set_params` (hot reload) may be called from
    elsewhere, and it swaps the params in one attribute store."""

    def __init__(self, model, n_slots=8, max_len=256, device="cuda",
                 seed=0):
        self.device = torch_device(device)
        self.plan = DecodePlan.from_archive(model)
        limit = self.plan.positions_limit(model.params)
        if limit is not None and limit < max_len:
            # past the exported positions table there is no position
            # embedding to look up
            log.info("clamping max_len %d -> %d (exported positions "
                     "table)", max_len, limit)
            max_len = limit
        self.max_len = int(max_len)
        self.pool = KVPool(self.plan.cache_specs, n_slots, self.max_len,
                           self.device)
        self.compile_seconds = {}      # prompt bucket / "step" -> first run
        self.set_params(model)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def set_params(self, model):
        """(Re-)upload the model's params, one tree per plan step (the
        hot-reload path)."""
        self._params = [{k: v.to(self.device) for k, v in
                         model.params.get(spec["name"], {}).items()}
                        for _, spec, _ in self.plan.steps]

    # -- bucket math ---------------------------------------------------

    def prompt_bucket(self, n):
        """Smallest power-of-two prompt bucket >= n (capped at
        max_len)."""
        if n > self.max_len:
            raise ValueError("prompt of %d exceeds max_len %d"
                             % (n, self.max_len))
        b = 1
        while b < n:
            b <<= 1
        return min(b, self.max_len)

    @property
    def compiled_buckets(self):
        return sorted(b for b in self.compile_seconds if b != "step")

    def _timed(self, key, fn):
        """Run ``fn``; its first run per ``key`` is timed into
        ``compile_seconds`` (the reference's compile)."""
        if key in self.compile_seconds:
            return fn()
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.compile_seconds[key] = time.perf_counter() - t0
        return out

    def warmup(self, buckets=None):
        """Run a prefill of every prompt bucket and one decode step, so
        that first requests find them warm; only while no slot is in use
        (a warm run writes scratch K/V); -> compile_seconds."""
        if self.pool.in_use:
            raise RuntimeError("warmup needs an idle pool (%d slots in "
                               "use)" % self.pool.in_use)
        bind_thread(self.device)
        for b in buckets or bucket_sizes(self.max_len):
            self.prefill_into(0, [0] * int(b), 0.0)
        zeros = numpy.zeros(self.pool.n_slots, numpy.int32)
        self.step(zeros, zeros, numpy.zeros(self.pool.n_slots,
                                            numpy.float32))
        return dict(self.compile_seconds)

    # -- execution (worker thread only) --------------------------------

    def _embed(self, ids, positions):
        emb = self._params[0]
        x = gather_rows(emb["weights"], ids)
        table = emb.get("positions")
        if table is not None:
            x = x + gather_rows(table, positions)
        return x

    def prefill_into(self, slot, prompt, temperature):
        """The prompt's bucket prefill: write the slot's K/V row and
        sample the first token; -> int token."""
        n = len(prompt)
        bucket = self.prompt_bucket(n)
        return self._timed(bucket, lambda: self._prefill(
            slot, prompt, n, bucket, temperature))

    @torch.no_grad()
    def _prefill(self, slot, prompt, n, bucket, temperature):
        ids = torch.zeros((1, bucket), dtype=torch.long)
        ids[0, :n] = torch.as_tensor(prompt, dtype=torch.long)
        x = self._embed(ids.to(self.device), slice(None, bucket))
        for (kind, spec, ci), p in zip(self.plan.steps[1:],
                                       self._params[1:]):
            p = dense_params(p)
            if kind in ("attn", "stack"):
                if kind == "attn":
                    x, k, v = attention_kv(x, p, spec["config"])
                    kv = [(k, v)]
                else:
                    x, kv = stack_kv(x, p, spec["config"])
                for i, (k, v) in enumerate(kv):
                    for pool, new in ((self.pool.K[ci + i], k),
                                      (self.pool.V[ci + i], v)):
                        pool[slot, :, :bucket] = new[0]
                        pool[slot, :, bucket:] = 0.0
            else:
                x = FORWARD_OPS[spec["type"]](x, p, spec)
        return int(_sample_tokens(x[:, n - 1, :], [temperature],
                                  self.generator)[0])

    def step(self, tokens, pos, temp):
        """One decode step over the WHOLE pool: ``tokens``, ``pos`` and
        ``temp`` are (n_slots,) host vectors (inactive slots at position
        0, token 0, temperature 0); -> (n_slots,) next tokens on the
        host."""
        return self._timed("step", lambda: _sample_tokens(
            self.logits(tokens, pos), temp, self.generator).cpu().numpy())

    @torch.no_grad()
    def logits(self, tokens, pos):
        """The decode step's (n_slots, vocab) f32 logits on the device,
        each slot's K/V written at its position (:meth:`step` without the
        sampling)."""
        dev = self.device
        tok = torch.as_tensor(numpy.asarray(tokens)).to(dev).long()
        pos = torch.as_tensor(numpy.asarray(pos)).to(dev).long()
        x = self._embed(tok, pos)[:, None, :]
        for (kind, spec, ci), p in zip(self.plan.steps[1:],
                                       self._params[1:]):
            p = dense_params(p)
            cfg = spec["config"]
            if kind == "attn":
                x = attn_decode(x, pos, (self.pool.K[ci], self.pool.V[ci]),
                                p, int(cfg["heads"]),
                                p.get("bias") is not None,
                                bool(cfg.get("residual")))
            elif kind == "stack":
                for i in range(int(cfg["layers"])):
                    x = block_decode(
                        x, pos, (self.pool.K[ci + i], self.pool.V[ci + i]),
                        {k: t[i] for k, t in p.items()}, int(cfg["heads"]),
                        float(cfg["eps"]))
            else:
                x = FORWARD_OPS[spec["type"]](x, p, spec)
        return x[:, 0, :]


class GenRequest:
    """One generation: prompt in, tokens out (collected in :attr:`tokens`
    as they decode)."""

    def __init__(self, prompt, max_tokens, temperature, eos, deadline,
                 trace=None, tenant=None):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.eos = eos
        self.deadline = deadline
        self.trace = trace
        #: the resolved tenant and the virtual finish tag of its grant
        self.tenant = tenant
        self.vft = 0.0
        self.t_submit = time.perf_counter()
        self.t_first = None         # perf_counter of the first token
        self.tokens = []
        self.finish_reason = None
        self.error = None
        self.done = threading.Event()
        self.slot = None
        self.cancelled = None       # reason string once cancelled
        self._lock = threading.Lock()
        self._on_token = None
        self._on_done = None
        self._notify = None         # batcher wake hook

    # -- client side ---------------------------------------------------

    def cancel(self, reason="cancelled"):
        """Stop decoding at the next step boundary and free the KV slot;
        safe from any thread; a finished request is untouched."""
        with self._lock:
            if self.done.is_set() or self.cancelled is not None:
                return
            self.cancelled = str(reason)
            notify = self._notify
        if notify is not None:
            notify()

    def set_on_token(self, fn):
        """Attach the per-token callback; tokens already decoded are
        replayed first, in order, under the emission lock."""
        with self._lock:
            for tok in self.tokens:
                fn(tok)
            self._on_token = fn

    def set_on_done(self, fn):
        """Attach the completion callback (called at once when the
        request already finished)."""
        with self._lock:
            if not self.done.is_set():
                self._on_done = fn
                return
        fn(self)

    def wait(self, timeout=None):
        """Block until done; -> the token list (raises the failure)."""
        if not self.done.wait(timeout):
            raise DeadlineExceeded("generation still running after %.1fs"
                                   % (timeout or 0))
        if self.error is not None:
            raise self.error
        return list(self.tokens)

    # -- worker side ---------------------------------------------------

    def _emit(self, tok):
        with self._lock:
            if self.t_first is None:
                self.t_first = time.perf_counter()
            self.tokens.append(tok)
            cb = self._on_token
            if cb is not None:
                try:
                    cb(tok)
                except Exception:
                    # a consumer's callback never kills the shared loop
                    pass

    def _finish(self, reason=None, error=None):
        with self._lock:
            self.finish_reason = reason
            self.error = error
            cb = self._on_done
            self._on_done = None
            self.done.set()
        if cb is not None:
            try:
                cb(self)
            except Exception:
                pass


class ContinuousBatcher:
    """The decode loop: admission at step boundaries, one shared decode
    batch, slots recycled mid-flight, a bounded queue. One worker thread
    owns every device dispatch; the public methods only touch the queue
    and the bookkeeping under the lock."""

    #: the counters :meth:`metrics` reports
    COUNTERS = ("requests_total", "shed_total", "expired_total",
                "generated_tokens_total", "steps_total")

    def __init__(self, engine, max_queue=64, default_timeout_ms=30000.0,
                 name="decode", model=None):
        self.name = name
        #: the ``model`` label of this batcher's series
        self.model = model or name
        self.engine = engine
        self.max_queue = int(max_queue)
        self.default_timeout = float(default_timeout_ms) / 1000.0
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue = collections.deque()
        self._active = {}           # slot -> GenRequest
        # weighted-fair slot grants: virtual time, last finish tag per
        # tenant
        self._vtime = 0.0
        self._vfinish = {}
        self._running = True
        self.last_step = time.monotonic()
        n_slots = engine.pool.n_slots
        # host-side carry of the whole pool (inactive slots ride along
        # at position 0, token 0, temperature 0)
        self._tokens = numpy.zeros(n_slots, numpy.int32)
        self._pos = numpy.zeros(n_slots, numpy.int32)
        self._temp = numpy.zeros(n_slots, numpy.float32)
        self.counts = dict.fromkeys(self.COUNTERS, 0)
        label = (self.model,)

        def counter(name, help):
            return telemetry.LazyChild(lambda: telemetry.counter(
                name, help, ("model",)).labels(*label))

        def gauge(name, help):
            return telemetry.LazyChild(lambda: telemetry.gauge(
                name, help, ("model",)).labels(*label))

        #: counts key -> its registry series
        self._c = {
            "requests_total": counter(
                "veles_serving_decode_requests_total",
                "Generation requests admitted to the decode queue"),
            "shed_total": counter(
                "veles_serving_decode_shed_total",
                "Generation requests shed on a full decode queue (503)"),
            "expired_total": counter(
                "veles_serving_decode_expired_total",
                "Generation requests expired before a KV slot grant "
                "(504)"),
            "generated_tokens_total": counter(
                "veles_serving_generated_tokens_total",
                "Tokens decoded across all sequences"),
            "steps_total": counter(
                "veles_serving_decode_steps_total",
                "Shared decode steps executed (each advances every "
                "active sequence one token)"),
        }
        self._c_finished = telemetry.LazyChild(
            lambda: telemetry.counter(
                "veles_serving_decode_finished_total",
                "Finished generations by reason", ("model", "reason")))
        self._g_queue = gauge("veles_serving_decode_queue_depth",
                              "Generation requests waiting for a KV slot")
        self._g_slots = gauge(
            "veles_serving_kv_slots_in_use",
            "KV pool slots occupied by in-flight sequences")
        self._g_pool = gauge(
            "veles_serving_kv_pool_slots",
            "Preallocated KV pool slots (decode batch width)")
        self._h_first = telemetry.LazyChild(
            lambda: telemetry.histogram(
                "veles_serving_first_token_seconds",
                "Submit -> first streamed token",
                ("model",)).labels(*label))
        self._g_pool.get().set(n_slots)
        #: (monotonic time, sequences advanced) per completed step
        self._step_log = collections.deque(maxlen=4096)
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="%s-worker" % name)
        self._thread.start()

    # -- client side ---------------------------------------------------

    def _count(self, key, n=1):
        """One counter: the batcher's view and the registry series."""
        self.counts[key] += n
        self._c[key].get().inc(n)

    def submit(self, prompt, max_tokens=None, temperature=0.0, eos=None,
               timeout_ms=None, trace=None, tenant=None):
        """Enqueue one generation; -> :class:`GenRequest`. Raises
        :class:`QueueFull` (admission backpressure) or ValueError (prompt
        or budget outside the pool's geometry). ``timeout_ms`` bounds the
        wait for a KV slot, not the decode; ``tenant`` (resolver output)
        keys the weighted-fair slot grants."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must have at least one token")
        try:
            max_tokens = (DEFAULT_MAX_TOKENS if max_tokens is None
                          else int(max_tokens))
        except OverflowError:
            raise ValueError("max_tokens must be a finite integer, got %r"
                             % (max_tokens,))
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if len(prompt) + max_tokens > self.engine.max_len:
            raise ValueError(
                "prompt %d + max_tokens %d exceeds the KV slot length %d"
                % (len(prompt), max_tokens, self.engine.max_len))
        timeout = timeout_seconds(timeout_ms, self.default_timeout)
        req = GenRequest(prompt, max_tokens, float(temperature),
                         None if eos is None else int(eos),
                         time.monotonic() + timeout, trace=trace,
                         tenant=tenant)
        with self._lock:
            if not self._running:
                raise RuntimeError("decode batcher is closed")
            if len(self._queue) >= self.max_queue:
                self._count("shed_total")
                raise QueueFull("decode queue full (%d waiting, max %d)"
                                % (len(self._queue), self.max_queue))
            self._count("requests_total")
            # the fair-share tag: a sequence's whole KV claim over its
            # tenant's weight
            start = max(self._vtime, self._vfinish.get(tenant, 0.0))
            req.vft = start + (len(prompt) + max_tokens) \
                / tenants.weight(tenant)
            self._vfinish[tenant] = req.vft
            req._notify = self._notify
            self._queue.append(req)
            self._g_queue.get().set(len(self._queue))
            self._wake.notify()
        return req

    def generate(self, prompt, max_tokens=None, temperature=0.0, eos=None,
                 timeout_ms=None, wait_s=120.0):
        """submit + wait: -> the generated token list."""
        return self.submit(prompt, max_tokens=max_tokens,
                           temperature=temperature, eos=eos,
                           timeout_ms=timeout_ms).wait(wait_s)

    def _notify(self):
        with self._lock:
            self._wake.notify()

    # -- worker --------------------------------------------------------

    def _admit_locked(self):
        """Sweep the queue: cancelled and expired requests finish without
        a prefill (even while the pool is full), live ones take free
        slots least virtual finish tag first (arrival order with one
        tenant), the rest keep their arrival order; -> the requests to
        prefill. Lock held."""
        live = []
        now = time.monotonic()
        while self._queue:
            req = self._queue.popleft()
            if req.cancelled is not None:
                self._finish_locked(req, req.cancelled)
            elif req.deadline < now:
                self._count("expired_total")
                req._finish(error=DeadlineExceeded(
                    "no KV slot before deadline"))
                self._count_finish("expired")
            else:
                live.append(req)
        admitted = []
        if live and self.engine.pool.free_slots:
            for req in sorted(live, key=lambda r: (r.vft, r.tenant or "")):
                if not self.engine.pool.free_slots:
                    break
                req.slot = self.engine.pool.grant()
                self._active[req.slot] = req
                self._vtime = max(self._vtime, req.vft)
                admitted.append(req)
            granted = {id(r) for r in admitted}
            live = [r for r in live if id(r) not in granted]
        self._queue.extend(live)    # arrival order kept
        self._g_queue.get().set(len(self._queue))
        self._g_slots.get().set(self.engine.pool.in_use)
        return admitted

    def _count_finish(self, reason):
        self._c_finished.get().labels(self.model, reason).inc()

    def _finish_locked(self, req, reason, error=None):
        """Free the slot (if granted) and complete the request. Lock
        held."""
        if req.slot is not None:
            self._active.pop(req.slot, None)
            self.engine.pool.release(req.slot)
            self._temp[req.slot] = 0.0
            self._pos[req.slot] = 0
            self._tokens[req.slot] = 0
            req.slot = None
            self._g_slots.get().set(self.engine.pool.in_use)
        self._count_finish(reason if error is None else "error")
        req._finish(reason=reason, error=error)
        if telemetry.tracer.active:
            args = {"model": self.model, "tokens": len(req.tokens),
                    "reason": reason or "error"}
            if req.trace is not None:
                args.update(req.trace.child().span_args())
            telemetry.tracer.add_complete(
                "serving.decode", req.t_submit,
                time.perf_counter() - req.t_submit, **args)

    def _deliver(self, req, tok):
        """Emit one token; -> the finish reason, or None to go on."""
        req._emit(tok)
        with self._lock:
            self._count("generated_tokens_total")
        if req.tenant is not None:
            _T_TOKENS.get().labels(req.tenant).inc()
        if req.cancelled is not None:
            return req.cancelled
        if req.eos is not None and tok == req.eos:
            return "eos"
        if len(req.tokens) >= req.max_tokens:
            return "length"
        return None

    def _worker(self):
        bind_thread(self.engine.device)
        with torch.no_grad():
            self._loop()

    def _loop(self):
        while True:
            with self._lock:
                while self._running and not self._queue \
                        and not self._active:
                    self._wake.wait()
                if not self._running:
                    self._drain_locked()
                    return
                admitted = self._admit_locked()
            for req in admitted:
                try:
                    tok = self.engine.prefill_into(req.slot, req.prompt,
                                                   req.temperature)
                except Exception as exc:
                    log.warning("%s: prefill failed: %s: %s", self.name,
                                type(exc).__name__, exc)
                    with self._lock:
                        self._finish_locked(req, None, error=exc)
                    continue
                self._h_first.get().observe(
                    time.perf_counter() - req.t_submit)
                reason = self._deliver(req, tok)
                if reason is not None:
                    with self._lock:
                        self._finish_locked(req, reason)
                    continue
                # the sequence joins the shared decode batch: its first
                # token is the next step's input at position len(prompt)
                self._tokens[req.slot] = tok
                self._pos[req.slot] = len(req.prompt)
                self._temp[req.slot] = req.temperature
            with self._lock:
                active = dict(self._active)
            self.last_step = time.monotonic()
            if not active:
                continue
            try:
                nxt = self.engine.step(self._tokens, self._pos, self._temp)
            except Exception as exc:
                log.warning("%s: decode step failed: %s: %s", self.name,
                            type(exc).__name__, exc)
                with self._lock:
                    for req in list(self._active.values()):
                        self._finish_locked(req, None, error=exc)
                continue
            self.last_step = time.monotonic()
            with self._lock:
                self._count("steps_total")
                self._step_log.append((self.last_step, len(active)))
            for slot, req in active.items():
                tok = int(nxt[slot])
                self._pos[slot] += 1
                reason = self._deliver(req, tok)
                if reason is not None:
                    with self._lock:
                        self._finish_locked(req, reason)
                else:
                    self._tokens[slot] = tok

    def _drain_locked(self):
        closed = RuntimeError("decode batcher closed")
        while self._queue:
            self._finish_locked(self._queue.popleft(), None, error=closed)
        for req in list(self._active.values()):
            self._finish_locked(req, None, error=closed)
        self._g_queue.get().set(0)

    # -- operational surface -------------------------------------------

    def healthy(self):
        """(ok, reason): the worker must be alive, and while sequences are
        active the loop must keep completing steps."""
        if not self._thread.is_alive():
            if self._running:
                return False, "decode worker dead"
            return True, None           # closed deliberately
        with self._lock:
            busy = bool(self._active or self._queue)
        if busy and time.monotonic() - self.last_step > WEDGE_AFTER_S:
            return False, ("decode loop wedged (%.0fs since last step)"
                           % (time.monotonic() - self.last_step))
        return True, None

    def metrics(self, rate_window=10.0):
        """Queue depth, KV occupancy, counters, tokens/s over the window
        and the first-token latency percentiles (of the model's
        histogram)."""
        now = time.monotonic()
        first = self._h_first.get()
        with self._lock:
            c = dict(self.counts)
            queued = len(self._queue)
            in_use = self.engine.pool.in_use
            recent = sum(n for t, n in self._step_log
                         if t > now - rate_window)
        out = {
            "queue_depth": queued,
            "kv_slots_in_use": in_use,
            "kv_pool_slots": self.engine.pool.n_slots,
            "kv_pool_bytes": self.engine.pool.nbytes(),
            "max_len": self.engine.max_len,
            "requests_total": c["requests_total"],
            "shed_total": c["shed_total"],
            "expired_total": c["expired_total"],
            "generated_tokens_total": c["generated_tokens_total"],
            "steps_total": c["steps_total"],
            "tokens_per_sec": round(recent / rate_window, 2),
        }
        p50 = first.percentile(0.5)
        if p50 is not None:
            out["first_token_ms_p50"] = round(p50 * 1000, 3)
            out["first_token_ms_p99"] = round(first.percentile(0.99) * 1000,
                                              3)
        return out

    def close(self):
        """Stop the worker; queued and in-flight requests fail with a
        closed error (their slots are released)."""
        with self._lock:
            self._running = False
            self._wake.notify_all()
        self._thread.join(timeout=10)
        with self._lock:
            if self._thread.is_alive():
                return              # wedged in a step; daemon thread
            self._drain_locked()
