"""Picklable probes for the port's worker-process tests: a spawned worker
imports this light module (not the test module, which imports the JAX
package) to find them."""


def torch_threads(_):
    """The calling process's torch CPU thread count."""
    import torch
    return torch.get_num_threads()


def die(_):
    """End the calling worker process at once, as a signal or the OOM
    killer would."""
    import os
    os._exit(3)


def quad_fitness(values):
    """A deterministic fitness of the GA-over-slaves tests."""
    return (values["a/lr"] - 0.37) ** 2


def slow_quad_fitness(values):
    """The same, evaluated slower than the timeout-drop test's
    ``slave_timeout`` (the master drops the slave mid-evaluation)."""
    import time
    time.sleep(0.6)
    return quad_fitness(values)
