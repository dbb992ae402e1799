"""Distribution contract per unit, in the port.

The port's own copy of ``veles/distributable.py``: master↔slave data
exchange is expressed per unit through the ``IDistributable`` hooks and
carried over the framed wire of ``server.py`` / ``client.py``. The
loaders ship minibatch index lists (``loader/base.py``), the GD units
ship parameters and deltas (``znicz/nn_units.py``).
:class:`DistributionRegistry` runs the round trips over the
distributable units of a workflow, keyed by unit name, as the
reference's does, so a port slave and a reference master (or the other
way round) exchange the same per-unit payloads.
"""


class IDistributable:
    """Interface (duck-typed): units override any subset."""

    #: True when the unit has state to exchange.
    negotiates_on_connect = False

    def generate_data_for_slave(self, slave=None):
        """Master: produce the payload shipped to ``slave`` before its
        next iteration (fresh weights, a minibatch index list)."""
        return None

    def apply_data_from_master(self, data):
        """Slave: ingest the master payload."""

    def generate_data_for_master(self):
        """Slave: produce the update payload (weight deltas)."""
        return None

    def apply_data_from_slave(self, data, slave=None):
        """Master: merge a slave update."""

    def drop_slave(self, slave=None):
        """Master: a slave died — requeue its in-flight work. May
        return the number of requeued items (the registry sums these
        into the master's fault counters)."""


class TriviallyDistributable(IDistributable):
    """No-op mixin for units with nothing to exchange."""


class DistributionRegistry:
    """Collects the distributable units of a workflow (iterating the
    workflow yields its units) and runs the master/slave exchange round
    trips over them."""

    def __init__(self, workflow):
        self.workflow = workflow

    def units(self):
        for unit in self.workflow:
            if isinstance(unit, IDistributable):
                yield unit

    def generate_job(self, slave=None):
        return {unit.name: unit.generate_data_for_slave(slave)
                for unit in self.units()}

    def apply_job(self, job):
        for unit in self.units():
            if unit.name in job:
                unit.apply_data_from_master(job[unit.name])

    def generate_update(self):
        return {unit.name: unit.generate_data_for_master()
                for unit in self.units()}

    def apply_update(self, update, slave=None):
        """Merge one slave update; -> how many units consumed data
        (0 means the payload named no unit of this workflow — a
        config-mismatched peer the master should hear about)."""
        merged = 0
        for unit in self.units():
            if unit.name in update:
                unit.apply_data_from_slave(update[unit.name], slave)
                merged += 1
        return merged

    def drop_slave(self, slave=None):
        """Requeue a dead slave's in-flight work across all units;
        -> total requeued items (for the fault counters)."""
        requeued = 0
        for unit in self.units():
            count = unit.drop_slave(slave)
            if isinstance(count, int):
                requeued += count
        return requeued
