"""Run orchestration of the PyTorch port: the reference's ``Launcher``
(``veles/launcher.py``) in its standalone mode.

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
:data:`EXIT_PREEMPTED`. ``profile_dir`` wraps the run in
``torch.profiler`` (CPU, and CUDA on the card) and writes its Chrome
trace into the directory, the twin of the reference's
``jax.profiler.trace``. The graphics server and the dashboard are closed
when :meth:`Launcher.run` ends, on every path out of it (a SIGTERM's exit
included), or by :meth:`Launcher.close`. The master and slave modes are not ported yet
(ROADMAP Queue 1 item 10).
"""

import logging
import os
import signal
import sys

import torch

from veles_torch import health, model_health
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
                 continual=None):
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

    def initialize(self, workflow):
        self.workflow = workflow
        workflow.initialize(device=self.device)
        snap = workflow.snapshotter
        if snap is not None and self.checkpoint_every and not snap.interval:
            snap.interval = float(self.checkpoint_every)
        elif snap is None and self.checkpoint_every:
            logger.warning(
                "--checkpoint-every %.6g has no snapshotter to drive (pass "
                "--snapshots DIR or link one) — NO interval checkpoints "
                "will be written", self.checkpoint_every)
        if self.snapshot:
            self._restore_snapshot(workflow)
        if self.graphics_dir:
            self.graphics = GraphicsServer(self.graphics_dir)
            workflow.graphics = self.graphics
        if self.web_status_port is not None:
            from veles_torch.web_status import WebStatus, workflow_status
            self.web_status = WebStatus(port=self.web_status_port)
            self.web_status.register(workflow.name,
                                     workflow_status(workflow))
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
            step.set_stats_enabled(False)
        if self.stats_interval:
            step.stats_interval = max(1, int(self.stats_interval))
        if not self.model_stats:
            return
        model_health.get_model_monitor().register_health()
        model_health.install_model_slos()
        if not self.rollback_on_divergence:
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
            workflow.restore_state(load_snapshot(target))
            logger.info("resumed from %s", target)
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
        workflow.restore_state(state)
        logger.info("resumed from %s", name)

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
            wf.stop()

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
            if self.preempted:
                self._preemption_exit()
        finally:
            self.close()
        if self.stats:
            wf.print_stats(sys.stderr)
        return wf

    def _train(self):
        wf = self.workflow
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
        if self.continual is None:
            self.workflow.run()
            return
        from veles_torch.continual import continual_loop
        continual_loop(self.workflow, rounds=self.continual or None,
                       launcher=self)

    def _preemption_exit(self):
        snap = self.workflow.snapshotter
        if snap is not None:
            path = snap.preempt_snapshot()
            if path:
                logger.info("preemption checkpoint -> %s", path)
        logger.warning("preempted: exiting with code %d", EXIT_PREEMPTED)
        raise SystemExit(EXIT_PREEMPTED)
