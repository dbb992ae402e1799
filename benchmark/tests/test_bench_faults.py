"""A run whose timed path is broken underneath comes out not correct.

Each test skips the look for a card and drives a whole run of a tiny
cell on the CPU, held to the real cell's limits, with one fault planted
in the program: a step that leaves the state unchanged (from the first
step, or only once set-up's steps are done, which the second check after
the window has to catch), half of each minibatch left out with the mean
taken over the rest, and a loss altered where the evaluator produces
it. (The cells run on one card, so no
exchange between cards can be left out.)"""

import pytest


def unchanged_state(monkeypatch, wf):
    from veles_torch.znicz.nn_units import GradientDescentBase
    monkeypatch.setattr(GradientDescentBase, "apply_update",
                        staticmethod(lambda w, vel, *a: (w, vel)))


def unchanged_after_setup(monkeypatch, wf):
    """The state unchanged from the fourth train step on: set-up's check
    passes, the window's and the second check's steps do nothing."""
    from veles_torch.znicz.nn_units import GradientDescentBase
    step = wf.step
    train = step.train_minibatch

    def train_minibatch(data, target, valid):
        if step.train_steps < 3:
            return train(data, target, valid)
        with monkeypatch.context() as m:
            m.setattr(GradientDescentBase, "apply_update",
                      staticmethod(lambda w, vel, *a: (w, vel)))
            return train(data, target, valid)
    monkeypatch.setattr(step, "train_minibatch", train_minibatch)


def half_batch(monkeypatch, wf):
    ev = wf.evaluator
    run = ev.run

    def halved(out, target, valid, act_dtype, total=None):
        return run(out, target, valid // 2, act_dtype, total)
    monkeypatch.setattr(ev, "run", halved)


def altered_loss(monkeypatch, wf):
    ev = wf.evaluator
    run = ev.run

    def altered(*a, **kw):
        err, metrics = run(*a, **kw)
        return err, metrics * metrics.new_tensor([1.01, 1.0, 1.0, 1.0])
    monkeypatch.setattr(ev, "run", altered)


@pytest.mark.parametrize("family", ["lm", "alexnet"])
@pytest.mark.parametrize("fault", [unchanged_state, unchanged_after_setup,
                                   half_batch, altered_loss])
def test_fault_comes_out_not_correct(family, fault, request, monkeypatch):
    import harness
    cell = request.getfixturevalue("tiny_" + family)
    result = harness.run_cell(
        cell, 7 + len(family), 0.2, 0, device="cpu",
        fault=lambda wf: fault(monkeypatch, wf))
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["check"].values())
