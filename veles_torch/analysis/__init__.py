"""zlint — framework-aware static analysis for the veles_torch tree.

The port's own copy of the reference's ``veles/analysis`` (same rule
ids, pragmas, flags, exit codes and formats; it imports nothing of
the reference). The runtime is a threaded, fault-tolerant, checkpointed system
(master/slave leases, persist + heartbeat threads, micro-batcher,
durable snapshotter) whose correctness rests on invariants no test
exercises exhaustively: lock acquisition order, the purity of the
unit bodies a CUDA graph captures, and the ``get_state``/``checkpoint_state``
protocol that silently drops any unit which forgets to implement it.
This package machine-checks those invariants over the AST:

========================  =============================================
rule id                   checks
========================  =============================================
``tracer-purity``         unit bodies under ``znicz/ops`` (each
                          ``nn.Module``'s ``forward``, the GD and
                          evaluator units' ``run``, an autograd
                          Function's ``forward``/``backward``) and
                          what they reach must not call
                          ``numpy.random``/``random``/``time.*``/
                          ``print``, sync with the host
                          (``.item()``/``.tolist()``/``.cpu()``/
                          ``.numpy()``, ``torch.cuda.synchronize``,
                          ``float()``/``int()``/``bool()`` on a
                          tensor) or write a host value to ``self``
                          — the guard for CUDA-graph capture
``lock-order``            inter-procedural lock-acquisition graph;
                          cycles = potential deadlocks, nested
                          re-acquisition of a non-reentrant ``Lock``
``unguarded-shared-state``  instance attributes written both from a
                          ``threading.Thread`` target and from
                          unlocked public methods
``checkpoint-state``      Unit subclasses whose ``run()`` mutates
                          instance state must implement ``get_state``/
                          ``checkpoint_state`` (or carry a pragma
                          explaining why the state is ephemeral)
``telemetry-hygiene``     instrument families created inside loops;
                          unbounded label values minted from ids
``probe-purity``          ``/healthz``/``/readyz`` handler branches
                          read cached state only — no locks, no
                          network, no live state pulls
``reactor-purity``        reactor callbacks (``on_frame``/
                          ``on_timer``, ``call_soon``/``call_later``/
                          ``every`` targets) must not call blocking
                          primitives — raw-socket ``recv``/
                          ``sendall``/``accept``, ``time.sleep``,
                          ``Event.wait``/``Thread.join``, ``urlopen``
``profiler-safety``       ``/debug/profile`` route branches must
                          ``request.defer`` their capture; profiler
                          ``start``/``stop``/``capture_profile`` are
                          banned inside reactor callbacks (a capture
                          blocks for its whole window)
``wire-schema``           producers and consumers of one wire-frame
                          (direction, kind) must agree on arity:
                          unguarded tuple unpacks, ``resp[:N]``
                          slices and ``V[i]`` reads are checked
                          against every tuple the other side ships
                          (mixed-version ``len()`` guards count as
                          safe)
``resource-leak``         acquired resources (sockets, registries,
                          KV slot grants, ``start_background``
                          servers) must be released on every path,
                          exception edges included
``loop-exception-safety``  call chains reachable from reactor
                          callbacks must not raise exception types
                          no frame on the chain catches
``stats-cadence``         in-graph model-stat outputs (the
                          model-health plane's per-layer vectors)
                          materialize on the host only behind the
                          ``stats_due`` cadence gate — never per step
``thread-lifecycle``      threads must be daemons or have a join path
``untrusted-geometry``    wire/HTTP-tainted values must not size
                          allocations (``zeros``/``bytearray``/
                          ``range`` args, ``shape=``/``maxlen=``
                          keywords, ``[0] * n``)
``unbounded-cardinality``  tainted values must not key growth of
                          persistent containers — route the key
                          through a bounded resolver
``unsafe-deserialize``    ``pickle.loads``/``marshal.loads`` on a
                          tainted payload not dominated by an
                          ``hmac.compare_digest`` verification
``untrusted-path``        tainted values must not reach filesystem/
                          store targets without an admission
                          resolver
``bare-except``           ``except:`` swallows ``KeyboardInterrupt``
``unused-import``         dead module-level imports
``unused-variable``       locals assigned and never read
========================  =============================================

All rules resolve calls through ONE shared whole-program engine
(``veles_torch/analysis/engine.py``): an interprocedural call graph over
the parsed project (``self.method``, attribute type bindings,
module-alias and symbol-import resolution) plus a generic
forward-dataflow fixpoint (``ForwardDataflow``) and the shared
reactor-callback enumeration. Writing a new rule against the graph
is ~50 lines: resolve calls with ``CallGraph.resolve``, or subclass
``ForwardDataflow`` when a fact must flow caller→callee.

The four taint rules share one interprocedural taint pass
(``engine.taint_hits``): wire handler parameters, HTTP request
reads and env lookups are sources; sanitizer-named calls
(``*resolve*``/``*validate*``/``*clamp*``/``*sanitize*``), defs and
classes annotated ``# zlint: sanitizer (reason)``, and explicit
comparison guards kill taint; sinks are allocation geometry,
persistent-container growth, un-verified deserialization and
filesystem targets.

Findings carry file:line, rule id, severity and a one-line fix hint.
A finding is suppressed by a pragma comment on its line::

    self.reached = True   # zlint: disable=checkpoint-state (per-run)

``# zlint: disable=all`` silences every rule on that line. Run it as
``python -m veles_torch lint [--format text|json|sarif]
[--changed-only [REF]]
[--cache DIR] [--stats] [paths...]`` (exit 0 clean / 1 findings / 2
usage error). ``--cache DIR`` is the incremental mode
(``veles_torch/analysis/cache.py``): per-rule results keyed by content
hashes over each module's import closure, so warm full-tree runs
re-analyze only what changed with byte-identical output — the
documented pre-commit line is ``python -m veles_torch lint
--changed-only --cache .zlint-cache --format sarif``. The tier-1 gate
``tests/test_torch_analysis.py`` keeps the whole ``veles_torch/``
package (plus ``chip_smoke.py``) at zero findings.
"""

from veles_torch.analysis.core import (          # noqa: F401  (public API)
    Finding, Project, RULES, analyze_paths, iter_py_files)
