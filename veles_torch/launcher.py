"""Run orchestration of the PyTorch port: the reference's ``Launcher``
(``veles/launcher.py``) in its three modes.

    launcher = Launcher(device="cuda", snapshot="auto",
                        checkpoint_every=600, profile_dir="prof",
                        model_stats=True, stats_interval=8,
                        rollback_on_divergence=False,
                        graphics_dir="plots", web_status_port=0,
                        slo_config="slos.json", stats=True,
                        continual=None)
    launcher.initialize(workflow)
    launcher.run()

:meth:`Launcher.initialize` places the workflow on its device, turns
``checkpoint_every`` into the snapshotter's wall-clock interval (warning
when no snapshotter is linked: nothing would be written) and applies
``snapshot``: a checkpoint file, ``auto`` (the newest checkpoint that
verifies in the snapshotter's store, of this workflow's prefixes) or
``auto:DIR``, then wires the model-health plane (``model_health.py``) as
the reference does: ``model_stats=False`` (``--model-stats off``) turns
the whole plane off, so checkpoints are stamped ``unknown``;
``stats_interval`` sets the step's stats stride; ``rollback_on_divergence``
arms the workflow's rollback (a workflow without one gets a warning);
``graphics_dir`` starts a :class:`GraphicsServer` (``graphics.py``) whose
renderer process writes the workflow's plots there, and attaches it as
``workflow.graphics``; ``web_status_port`` starts a :class:`WebStatus`
dashboard (``web_status.py``) with the run registered
(``workflow_status``); ``slo_config`` loads SLO objectives into the
health monitor (``health.py``); ``stats`` prints the workflow's per-unit
timing table (``print_stats``) to standard error when a run ends. With
the model-health plane on, the
monitor's ``model:divergence`` check joins ``/readyz`` and the divergence
SLOs (``model_health.MODEL_SLOS``) the health plane, as the reference's
launcher wires them.
:meth:`Launcher.run` trains: SIGINT stops the run; SIGTERM
(preemption) stops it before the next minibatch, then, outside the
signal handler, writes a final ``current`` checkpoint and exits with
:data:`EXIT_PREEMPTED`. A parallel run's spawner forwards its SIGTERM to
every rank; the ranks agree on the minibatch they stop before
(``TorchStep.stop_agreed``), write the one checkpoint together (rank 0
writes, the sharded tensors gathered) and each exits with
:data:`EXIT_PREEMPTED`, as does the spawner. ``profile_dir`` wraps the run in
``torch.profiler`` (CPU, and CUDA on the card) and writes its Chrome
trace into the directory, the twin of the reference's
``jax.profiler.trace``. The graphics server and the dashboard are closed
when :meth:`Launcher.run` ends, on every path out of it (a SIGTERM's exit
included), or by :meth:`Launcher.close`.

The distributed role, as the reference's:

* **standalone** — everything in process (the default);
* **master** (``listen_address="HOST:PORT"``) — a
  :class:`~veles_torch.server.MasterServer` owns the canonical weights
  and the job queue and serves slaves over the wire. It never computes:
  the workflow is initialized on the host (``cpu``) without a step, so
  the master does not initialize CUDA. ``slave_timeout`` bounds a silent
  slave, ``grad_codec`` / ``grad_topk_percent`` pick the wire codec the
  master wants, ``rollback_on_divergence`` arms a
  :class:`~veles_torch.model_health.WeightGuard` ticked after every
  merge (a stash every ``stash_interval`` merges), and
  ``checkpoint_every`` persists the master tree (the ``"master"`` and
  ``"workflow"`` keys) into the snapshotter's store (or
  ``snapshot="auto:DIR"``'s), which ``snapshot`` resumes; either
  package reads the other's master tree. The dashboard gets the
  master's ``cluster`` row;
* **slave** (``master_address="HOST:PORT"``) — a
  :class:`~veles_torch.client.SlaveClient` pulls minibatch jobs, runs
  each on the launcher's device (``cuda`` unless told otherwise) through
  ``TorchStep.run_job`` and pushes deltas; ``slave_options`` are its
  fault-tolerance knobs (``max_retries``, ``io_timeout``...). A slave
  writes no checkpoint.
"""

import logging
import os
import signal
import sys

import torch

from veles_torch import health, model_health, telemetry
from veles_torch.graphics import GraphicsServer
from veles_torch.snapshotter import load_snapshot, resolve_auto

logger = logging.getLogger("veles_torch.launcher")

#: exit code after a SIGTERM preemption: "checkpointed, reschedule me"
#: (BSD EX_TEMPFAIL), apart from success and crash
EXIT_PREEMPTED = 75

#: the trace file ``profile_dir`` receives
TRACE_NAME = "trace.json"


class Launcher:
    """Drives one standalone workflow run."""

    def __init__(self, device="cuda", snapshot=None, checkpoint_every=None,
                 profile_dir=None, model_stats=True, stats_interval=None,
                 rollback_on_divergence=False, graphics_dir=None,
                 web_status_port=None, slo_config=None, stats=True,
                 continual=None, listen_address=None, master_address=None,
                 slave_timeout=None, slave_options=None, grad_codec=None,
                 grad_topk_percent=None, stash_interval=None):
        self.device = device
        self.snapshot = snapshot
        self.checkpoint_every = checkpoint_every
        self.profile_dir = profile_dir
        self.model_stats = bool(model_stats)
        self.stats_interval = stats_interval
        self.rollback_on_divergence = bool(rollback_on_divergence)
        self.graphics_dir = graphics_dir
        self.web_status_port = web_status_port
        self.slo_config = slo_config
        self.stats = bool(stats)
        #: None: one run; else continual rounds (0: until interrupted)
        self.continual = continual
        #: the GraphicsServer of ``graphics_dir`` while the run lasts
        self.graphics = None
        #: the WebStatus dashboard of ``web_status_port`` while the run
        #: lasts
        self.web_status = None
        self.workflow = None
        self.interrupted = False
        #: SIGTERM asked for a preemption shutdown
        self.preempted = False
        #: the distributed role's settings (see the module docstring)
        self.listen_address = listen_address
        self.master_address = master_address
        self.slave_timeout = slave_timeout
        self.slave_options = dict(slave_options or {})
        self.grad_codec = grad_codec or "none"
        self.grad_topk_percent = 1.0 if grad_topk_percent is None \
            else float(grad_topk_percent)
        self.stash_interval = stash_interval
        #: the MasterServer / SlaveClient of the run's role
        self.master_server = None
        self.slave_client = None
        #: the ``"master"`` section of a resumed master tree
        self._master_resume = None

    @property
    def mode(self):
        if self.listen_address:
            return "master"
        if self.master_address:
            return "slave"
        return "standalone"

    def initialize(self, workflow):
        self.workflow = workflow
        # a merged cluster trace reads as roles, not pids
        telemetry.tracer.set_process_name(
            self.mode if self.mode != "standalone" else workflow.name)
        if self.mode == "master":
            # the master holds the weights and never computes: host
            # tensors, no step, no CUDA (the reference's numpy master)
            workflow.initialize(device="cpu", with_step=False)
            logger.info("master: canonical weights on the host; no step "
                        "is built and CUDA is not initialized (the "
                        "master never computes)")
        else:
            workflow.initialize(device=self.device)
        snap = workflow.snapshotter
        if snap is not None and self.checkpoint_every and not snap.interval:
            snap.interval = float(self.checkpoint_every)
        elif snap is None and self.checkpoint_every \
                and self.mode == "standalone":
            logger.warning(
                "--checkpoint-every %.6g has no snapshotter to drive (pass "
                "--snapshots DIR or link one) — NO interval checkpoints "
                "will be written", self.checkpoint_every)
        if self.snapshot:
            self._restore_snapshot(workflow)
        if self.graphics_dir and self.mode != "slave":
            self.graphics = GraphicsServer(self.graphics_dir)
            workflow.graphics = self.graphics
        if self.web_status_port is not None:
            from veles_torch.web_status import WebStatus, workflow_status
            self.web_status = WebStatus(port=self.web_status_port)
            self.web_status.register(workflow.name,
                                     workflow_status(workflow, self.mode))
        if self.slo_config:
            n = health.get_monitor().load_slo_file(self.slo_config)
            logger.info("%d SLO objective(s) loaded from %s", n,
                        self.slo_config)
        self._wire_model_health(workflow)
        return workflow

    def close(self):
        """Stop the graphics server (its renderer draws what it received
        and exits), the dashboard and the workflow's threads
        (``NNWorkflow.close``)."""
        if self.workflow is not None:
            self.workflow.close()
        if self.graphics is not None:
            self.graphics.close()
            self.workflow.graphics = self.graphics = None
        if self.web_status is not None:
            self.web_status.close()
            self.web_status = None

    def _wire_model_health(self, workflow):
        """The model-health plane's options on the monitor, the step and
        the rollback."""
        step = workflow.step
        if not self.model_stats:
            # the whole plane stands down, not only the stats: the loss
            # feed must not stamp checkpoints diverged either
            model_health.get_model_monitor().enabled = False
            if step is not None:
                step.set_stats_enabled(False)
        if self.stats_interval and step is not None:
            step.stats_interval = max(1, int(self.stats_interval))
        if not self.model_stats:
            return
        model_health.get_model_monitor().register_health()
        model_health.install_model_slos()
        if not self.rollback_on_divergence or self.mode != "standalone":
            # the master's actuator is its WeightGuard (_run_master)
            return
        if workflow.rollback is not None:
            workflow.rollback.rollback_on_divergence = True
        else:
            logger.warning(
                "--rollback-on-divergence: workflow has no rollback unit "
                "(link_rollback) — divergence is judged but nothing "
                "restores weights")

    def _restore_snapshot(self, workflow):
        target = self.snapshot
        if target != "auto" and not target.startswith("auto:"):
            self._apply_state(workflow, load_snapshot(target), target)
            return
        snap = workflow.snapshotter
        if target.startswith("auto:"):
            base = target[len("auto:"):]
        elif snap is not None:
            base = snap.directory
        else:
            raise ValueError(
                "--snapshot auto needs a checkpoint location: pass "
                "--snapshots DIR (or --snapshot auto:DIR) or link a "
                "snapshotter")
        # only this run's names: a shared store holds other workflows'
        prefixes = {workflow.name}
        if snap is not None:
            prefixes.add(snap.prefix)
        resolved = resolve_auto(base, prefixes=prefixes)
        if resolved is None:
            logger.info("--snapshot auto: no verifiable checkpoint in the "
                        "store — starting fresh")
            return
        state, name, corrupt = resolved
        if corrupt:
            logger.warning("--snapshot auto: the store holds %d corrupt "
                           "checkpoint(s); resuming %s", corrupt, name)
        self._apply_state(workflow, state, name)

    def _apply_state(self, workflow, state, origin):
        """A master tree (``"master"`` + ``"workflow"``, either
        package's) restores its workflow part here; its job queue and
        journal wait for the master server."""
        if "master" in state and "workflow" in state:
            self._master_resume = state["master"]
            workflow.restore_state(state["workflow"])
        else:
            workflow.restore_state(state)
        logger.info("resumed from %s", origin)

    def _checkpoint_store(self):
        """The master's persist store: ``auto:DIR``'s, else the
        workflow snapshotter's, else None."""
        from veles_torch.snapshotter import store_for_base
        if self.snapshot and self.snapshot.startswith("auto:"):
            return store_for_base(self.snapshot[len("auto:"):],
                                  create=False)
        snap = self.workflow.snapshotter
        return snap.store if snap is not None else None

    def _profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.workflow.device.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def run(self):
        """Train; -> the workflow. After SIGTERM: a final checkpoint,
        then ``SystemExit(EXIT_PREEMPTED)``."""
        wf = self.workflow
        previous = signal.getsignal(signal.SIGINT)
        previous_term = signal.getsignal(signal.SIGTERM)

        def on_sigint(sig, frame):
            self.interrupted = True
            logger.warning("interrupt: stopping the workflow")
            wf.stop()
            signal.signal(signal.SIGINT, previous)

        def on_sigterm(sig, frame):
            # never checkpoint here: the run stops before its next
            # minibatch and the checkpoint follows once it has unwound
            self.preempted = True
            logger.warning("SIGTERM: preemption shutdown — stopping before "
                           "the next minibatch")
            wf.stop(preempt=True)
            if self.master_server is not None:
                # signal-safe: the serving thread persists on its way out
                self.master_server.request_stop()
            if self.slave_client is not None:
                self.slave_client.request_stop()

        try:
            signal.signal(signal.SIGINT, on_sigint)
            signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:          # not on the main thread
            previous = previous_term = None
        try:
            try:
                self._train()
            finally:
                if previous is not None:
                    signal.signal(signal.SIGINT, previous)
                if previous_term is not None:
                    signal.signal(signal.SIGTERM, previous_term)
            if getattr(wf.step, "preempt_requested", False):
                # on a mesh: another rank's SIGTERM, agreed on
                self.preempted = True
            if self.preempted:
                self._preemption_exit()
        finally:
            self.close()
        if self.stats:
            wf.print_stats(sys.stderr)
        return wf

    def _train(self):
        wf = self.workflow
        if self.continual is not None and self.mode != "standalone":
            logger.warning("--continual is standalone-only: running one "
                           "ordinary %s session", self.mode)
        if self.mode == "master":
            if self.profile_dir:
                logger.warning("--profile-dir ignored in master mode (the "
                               "master never computes)")
            self._run_master()
            return
        if self.profile_dir:
            os.makedirs(self.profile_dir, exist_ok=True)
            with self._profiler() as prof:
                self._run_workflow()
                if wf.device.device.type == "cuda":
                    torch.cuda.synchronize()
            path = os.path.join(self.profile_dir, TRACE_NAME)
            prof.export_chrome_trace(path)
            logger.info("profiler trace -> %s", path)
        else:
            self._run_workflow()

    def _run_workflow(self):
        if self.mode == "slave":
            self._run_slave()
            return
        if self.continual is None:
            self.workflow.run()
            return
        from veles_torch.continual import continual_loop
        continual_loop(self.workflow, rounds=self.continual or None,
                       launcher=self)

    def _run_master(self):
        from veles_torch.server import MasterServer
        kwargs = {} if self.slave_timeout is None \
            else {"slave_timeout": self.slave_timeout}
        store = self._checkpoint_store()
        if store is None and self.checkpoint_every:
            logger.warning(
                "--checkpoint-every %.6g: no checkpoint store resolves (pass "
                "--snapshots DIR) — the master state will NOT be persisted",
                self.checkpoint_every)
        server = MasterServer(
            self.workflow, self.listen_address, checkpoint_store=store,
            checkpoint_every=self.checkpoint_every,
            resume_state=self._master_resume, grad_codec=self.grad_codec,
            grad_topk_percent=self.grad_topk_percent,
            rollback_on_divergence=(self.rollback_on_divergence
                                    and self.model_stats),
            stash_interval=self.stash_interval or 1, **kwargs)
        self.master_server = server
        if self.preempted:
            # SIGTERM landed before the server existed
            server.request_stop()
        if self.web_status is not None:
            self.web_status.register("cluster", server.status)
        server.register_health()
        server.serve_forever()

    def _run_slave(self):
        from veles_torch.client import SlaveClient
        from veles_torch.znicz import parallel
        mesh = getattr(self.workflow, "mesh", None)
        if mesh is not None and mesh.rank != 0:
            # the other ranks of a slave: each job rank 0 relays
            parallel.follow_jobs(self.workflow)
            return
        client = SlaveClient(self.workflow, self.master_address,
                             grad_codec=self.grad_codec,
                             grad_topk_percent=self.grad_topk_percent,
                             **self.slave_options)
        self.slave_client = client
        if mesh is not None:
            client.relay = lambda payload: parallel.relay_job(
                self.workflow, payload)
        if self.preempted:
            client.request_stop()
        try:
            client.run_forever()
        finally:
            if mesh is not None:
                parallel.relay_job(self.workflow, None)

    def _preemption_exit(self):
        snap = self.workflow.snapshotter
        if self.mode == "standalone" and snap is not None:
            # on a mesh every rank is here, stopped before the same
            # minibatch: each takes its part in the checkpoint's gathers,
            # rank 0 writes it
            path = snap.preempt_snapshot()
            if path:
                logger.info("preemption checkpoint -> %s", path)
        logger.warning("preempted: exiting with code %d", EXIT_PREEMPTED)
        raise SystemExit(EXIT_PREEMPTED)


def rank_main(argv):
    """One spawned rank of a parallel run: the CLI (``python -m
    veles_torch``) with ``argv`` under its rank's environment."""
    import torch.distributed as dist
    from veles_torch.__main__ import main
    try:
        main(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
