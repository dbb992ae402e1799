"""The interactive shell unit of the port: poke a live workflow between
epochs.

Counterpart of ``veles/interaction.py``. Link it with
:meth:`StandardWorkflow.link_shell` (``znicz/standard_workflow.py``):
the workflow runs it at each epoch's end, after the decision, with the
workflow in scope. On a TTY it opens the stdlib ``code.interact``:

    >>> wf.decision.history[-1]
    >>> wf.forwards[0].weights.std()
    >>> stop()          # end the run before its next minibatch
    >>> (Ctrl-D)        # resume training

Without a TTY it does nothing, unless ``commands`` (python statements,
run at every activation) are given: each runs with ``wf``, ``workflow``,
``numpy``, ``stop`` and the workflow's units by name in scope, and its
outcome is recorded in ``results``; a failing command is recorded and
warned, and never ends training.
"""

import code
import sys

from veles_torch.logger import Logger


class Shell(Logger):
    """Runs ``commands`` (or an interactive console on a TTY) against a
    workflow."""

    def __init__(self, workflow, commands=None, name="shell"):
        self.workflow = workflow
        self.name = name
        #: statements run in place of a prompt (headless)
        self.commands = list(commands or [])
        #: (command, exception or None) of every command run
        self.results = []
        self.activations = 0

    def _units(self):
        wf = self.workflow
        units = [wf.loader, *wf.forwards, wf.evaluator, wf.decision,
                 *wf.gds, wf.snapshotter, wf.rollback, wf.image_saver,
                 *wf.plotters, self]
        return [u for u in units if u is not None]

    def _namespace(self):
        import numpy
        ns = {"wf": self.workflow, "workflow": self.workflow,
              "numpy": numpy, "stop": self.workflow.stop}
        for u in self._units():
            name = str(getattr(u, "name", "")).replace(" ", "_")
            if name.isidentifier():
                ns.setdefault(name, u)
        return ns

    def run(self):
        self.activations += 1
        ns = self._namespace()
        if self.commands:
            # exec, not InteractiveConsole: the console swallows
            # exceptions, and results must record them
            for cmd in self.commands:
                try:
                    exec(compile(cmd, "<shell>", "exec"), ns, ns)
                    self.results.append((cmd, None))
                except Exception as exc:   # never ends training
                    self.results.append((cmd, exc))
                    self.warning("shell command %r failed: %s", cmd, exc)
            return
        if not sys.stdin.isatty():
            return
        code.interact(
            banner="veles_torch shell: workflow %r in scope as `wf`; Ctrl-D "
                   "resumes training, stop() ends the run"
                   % self.workflow.name, local=ns, exitmsg="resuming")
