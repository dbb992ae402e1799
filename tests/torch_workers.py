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
