"""Genetic hyperparameter search over ``Tune`` config leaves, in the port.

Counterpart of ``veles/genetics.py`` (its local part): config values
wrapped in ``Tune(default, min, max)`` (``config.py``) define the search
space; each individual is one short training run; its fitness is the
run's best validation metric (lower is better).

* :func:`find_tunables` finds the Tune leaves through Config nodes and
  the plain dicts and lists inside them (a layer's ``"<-"`` kwargs),
  by ``/``-separated paths; :func:`apply_values` writes values back
  there.
* :class:`GeneticOptimizer` is the reference's search (tournament
  selection, blend crossover, gaussian mutation, elitism), drawing from
  ``numpy.random.Generator(PCG64(seed))`` in the reference's order: the
  same fitness function and seed give the same search bit for bit.
* :func:`optimize_config` searches every Tune under a config node with a
  caller's ``run_one()``.
* :class:`ProcessPoolMap` evaluates a generation in ``spawn``-ed worker
  processes, and :class:`SubprocessTrainer` is the picklable fitness they
  run: one training of a workflow module on a device (``cuda`` unless
  told otherwise). Workers on one card share it, each with a CUDA
  context of its own, and load the kernel libraries the parent built.
  A worker's failure (no card, a kernel that fails) fails its
  individual in the open: :class:`_SafeEval` scores it ``inf`` with the
  error's text, the search logs it, and nothing falls back to the CPU.

The reference's ``GATaskServer`` and ``ga_slave_loop`` (individuals over
registered slaves) ride the master/slave wire and are not ported yet
(ROADMAP Queue 1 item 10).
"""

import gc
import os

import numpy

from veles_torch.config import Config, Tune
from veles_torch.logger import Logger


def find_tunables(node, prefix=""):
    """{path: Tune} of every Tune leaf under ``node``, through Config
    nodes and plain dict and list values; paths are ``/``-separated,
    list positions numeric segments."""
    if isinstance(node, (Config, dict)):
        it = node.items()
    elif isinstance(node, (list, tuple)):
        it = enumerate(node)
    else:
        return {}
    out = {}
    for key, value in it:
        path = "%s/%s" % (prefix, key) if prefix else str(key)
        if isinstance(value, Tune):
            out[path] = value
        else:
            out.update(find_tunables(value, path))
    return out


class _SafeEval:
    """Picklable wrapper of the fitness callable: a failed individual
    scores inf instead of ending the search. -> ``(fitness, error text or
    None)``; the text rides back through a cross-process map so the
    search can say why an individual failed."""

    def __init__(self, evaluate):
        self.evaluate = evaluate

    def __call__(self, values):
        try:
            return float(self.evaluate(values)), None
        except Exception as exc:
            return float("inf"), "%s: %s" % (type(exc).__name__, exc)


def _share_host_cores(n_workers):
    """Pool initializer: a worker's torch CPU threads are its share of
    the host's cores. Each would otherwise start as many as the host has,
    and the workers' thread pools spin against each other (two workers of
    a full-width MNIST search on 8 cores: 17 s an individual, against 0.4
    s with 4 threads each)."""
    import torch
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else os.cpu_count() or 1
    torch.set_num_threads(max(1, cores // n_workers))


class ProcessPoolMap:
    """``map_fn`` evaluating a population in ``n_workers`` worker
    processes of the ``spawn`` context (each a fresh interpreter: its own
    torch and CUDA state, and its share of the host's cores for torch's
    CPU threads). The callable must be picklable
    (:class:`SubprocessTrainer` is). Results come back in population
    order, and every individual carries its own seed, so a parallel
    generation scores as a sequential one does. An exception inside an
    individual is its own (``_SafeEval`` scores it inf); a worker that
    dies (a signal, the OOM killer) ends the search with
    ``BrokenProcessPool`` rather than leaving it waiting forever."""

    def __init__(self, n_workers=None):
        self.n_workers = int(n_workers or min(os.cpu_count() or 1, 8))
        self._pool = None

    def _ensure(self):
        if self._pool is None:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            self._pool = ProcessPoolExecutor(
                self.n_workers, mp_context=multiprocessing.get_context(
                    "spawn"),
                initializer=_share_host_cores, initargs=(self.n_workers,))
        return self._pool

    def __call__(self, f, xs):
        xs = list(xs)
        if not xs:
            return []
        if len(xs) == 1:   # not worth a worker round trip
            return [f(xs[0])]
        return list(self._ensure().map(f, xs))

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SubprocessTrainer:
    """Picklable fitness: train ``workflow_path`` with the config file,
    the overrides and the individual's values on ``device``; -> the
    decision's best validation metric. In this order, as the CLI does:
    the workflow module (its ``root`` defaults), the config file, the
    overrides, the values, ``prng.seed_all(seed)``, ``create_workflow()``,
    then a :class:`Launcher` run under a model-health monitor of its own.
    Re-importing the module each call resets the tree the previous
    individual's values were written into."""

    def __init__(self, workflow_path, config_path=None, overrides=(),
                 seed=1, device="cuda"):
        self.workflow_path = workflow_path
        self.config_path = config_path
        self.overrides = tuple(overrides)
        self.seed = int(seed)
        self.device = device

    def __call__(self, values):
        metric = self._train(values)
        # the finished run's workflow and units refer to each other: free
        # them, device tensors included, now and not at the collector's
        # next full pass, or a worker's allocation grows by a dead run with
        # every individual (MNIST on the card: 55, 77, 77, 98 MB over four)
        gc.collect()
        return metric

    def _train(self, values):
        from veles_torch import model_health, prng
        from veles_torch.__main__ import import_file
        from veles_torch.config import root
        from veles_torch.launcher import Launcher
        module = import_file(self.workflow_path,
                             "veles_torch_workflow_module")
        if self.config_path:
            import_file(self.config_path, "veles_torch_config_module")
        for override in self.overrides:
            root.apply_override(override)
        apply_values(root, values)
        prng.seed_all(self.seed)
        wf = module.create_workflow()
        with model_health.scoped():
            launcher = Launcher(device=self.device)
            launcher.initialize(wf)
            launcher.run()
        return float(wf.decision.best_metric)


class GeneticOptimizer(Logger):
    """Minimizes ``evaluate(values)`` over the box of ``tunables`` (a
    ``{path: Tune}`` dict). ``evaluate`` gets ``{path: value}`` and
    returns a fitness, lower is better; a failed individual (an
    exception, NaN, inf) scores inf."""

    def __init__(self, evaluate, tunables, population_size=12,
                 generations=8, elite=2, tournament=3,
                 mutation_rate=0.25, mutation_sigma=0.2, seed=1,
                 map_fn=None, name="genetics"):
        if not tunables:
            raise ValueError("nothing to optimize: no Tune leaves")
        self.name = name
        self.evaluate = evaluate
        self.paths = sorted(tunables)
        self.tunables = tunables
        self.population_size = int(population_size)
        self.generations = int(generations)
        self.elite = int(elite)
        self.tournament = int(tournament)
        self.mutation_rate = float(mutation_rate)
        self.mutation_sigma = float(mutation_sigma)
        self.map_fn = map_fn or (lambda f, xs: [f(x) for x in xs])
        self._gen = numpy.random.Generator(numpy.random.PCG64(seed))
        #: (fitness, values) of each generation's champion
        self.history = []
        self.best_values = None
        self.best_fitness = numpy.inf
        self.evaluations = 0

    def _decode(self, genome):
        return {path: self.tunables[path].clip(x)
                for x, path in zip(genome, self.paths)}

    def _spans(self):
        lo = numpy.array([self.tunables[p].min_value
                          for p in self.paths], float)
        hi = numpy.array([self.tunables[p].max_value
                          for p in self.paths], float)
        return lo, hi

    def _initial_population(self):
        lo, hi = self._spans()
        pop = self._gen.uniform(lo, hi,
                                (self.population_size, len(lo)))
        # individual 0 is the defaults: the search never ends worse than
        # the hand-tuned config
        pop[0] = [float(self.tunables[p].default) for p in self.paths]
        return pop

    def _select(self, fitness):
        idx = self._gen.integers(0, len(fitness), self.tournament)
        return idx[numpy.argmin(fitness[idx])]

    def _crossover(self, a, b):
        # blend: the child is uniform in the parents' interval, widened
        # by a tenth of its span on each side
        lo = numpy.minimum(a, b)
        hi = numpy.maximum(a, b)
        span = hi - lo
        return self._gen.uniform(lo - 0.1 * span, hi + 0.1 * span)

    def _mutate(self, genome):
        lo, hi = self._spans()
        mask = self._gen.random(len(genome)) < self.mutation_rate
        noise = self._gen.normal(0.0, self.mutation_sigma,
                                 len(genome)) * (hi - lo)
        return numpy.where(mask, genome + noise, genome)

    def _fitness_of(self, pop):
        vals = [self._decode(g) for g in pop]
        # list() first: a lazy map_fn must not be exhausted by the
        # fitness pass before the error pass reads it
        pairs = list(self.map_fn(_SafeEval(self.evaluate), vals))
        out = numpy.asarray([fit for fit, _ in pairs], float)
        errors = [msg for _, msg in pairs if msg]
        self.evaluations += len(vals)
        bad = int((~numpy.isfinite(out)).sum())
        if bad:
            self.warning("%d individual(s) failed this round (first: %s)",
                         bad, errors[0] if errors else "non-finite fitness")
        return numpy.where(numpy.isfinite(out), out, numpy.inf)

    def run(self):
        """The search; -> (best values, best fitness)."""
        pop = self._initial_population()
        fitness = self._fitness_of(pop)
        for gen in range(self.generations):
            order = numpy.argsort(fitness)
            pop, fitness = pop[order], fitness[order]
            if fitness[0] < self.best_fitness:
                self.best_fitness = float(fitness[0])
                self.best_values = self._decode(pop[0])
            self.history.append(
                (float(fitness[0]), self._decode(pop[0])))
            self.info("generation %d: best %.6g %r", gen,
                      fitness[0], self.history[-1][1])
            children = list(pop[:self.elite])
            while len(children) < self.population_size:
                a = pop[self._select(fitness)]
                b = pop[self._select(fitness)]
                children.append(self._mutate(self._crossover(a, b)))
            pop = numpy.asarray(children)
            # elites keep their known fitness; only newcomers pay a run
            new_fit = self._fitness_of(pop[self.elite:])
            fitness = numpy.concatenate([fitness[:self.elite], new_fit])
        order = numpy.argsort(fitness)
        if fitness[order[0]] < self.best_fitness:
            self.best_fitness = float(fitness[order[0]])
            self.best_values = self._decode(pop[order[0]])
        return self.best_values, self.best_fitness


def apply_values(config_root, values):
    """Write ``{path: value}`` into the tree; paths as
    :func:`find_tunables` gives them. A value replaces its Tune leaf in
    place, in the layer dicts too."""
    for path, value in values.items():
        node = config_root
        segs = path.split("/")
        for seg in segs[:-1]:
            if isinstance(node, Config):
                node = node.raw(seg)
            elif isinstance(node, (list, tuple)):
                node = node[int(seg)]
            else:
                node = node[seg]
        last = segs[-1]
        if isinstance(node, Config):
            setattr(node, last, value)
        elif isinstance(node, list):
            node[int(last)] = value
        else:
            node[last] = value


def optimize_config(config_root, run_one, **kwargs):
    """Search every Tune under ``config_root``; ``run_one()`` trains with
    the current config and returns the validation metric. -> the
    optimizer, its best values applied to the config."""
    tunables = find_tunables(config_root)

    def evaluate(values):
        apply_values(config_root, values)
        return run_one()

    opt = GeneticOptimizer(evaluate, tunables, **kwargs)
    best_values, _ = opt.run()
    if best_values is not None:
        apply_values(config_root, best_values)
    return opt
