"""Weight diversity diagnostics of the PyTorch port.

Counterpart of ``veles/znicz_tpu/diversity.py``: the pairwise cosine
similarity of a layer's weight rows, the summary of its near-duplicate
and dead filters, and :class:`WeightDiversity`, a plotter that computes
them once an epoch, warns on near-duplicates and publishes the
similarity matrix like any plot.
"""

import logging

import numpy

from veles_torch.znicz.nn_plotting_units import PlotterBase, weight_rows

logger = logging.getLogger("veles_torch.diversity")


def similarity_matrix(weights):
    """Pairwise cosine similarity of weight ROWS (units × fan_in)."""
    w = numpy.asarray(weights, numpy.float32)
    w = w.reshape(len(w), -1)
    norms = numpy.linalg.norm(w, axis=1, keepdims=True)
    wn = w / numpy.where(norms == 0, 1.0, norms)
    return wn @ wn.T


def diversity_stats(weights, threshold=0.98, sim=None):
    """Mean and max |off-diagonal similarity|, the near-duplicate pairs
    (|cos| ≥ ``threshold``) and the dead (all-zero) rows; ``sim`` is the
    similarity matrix when it is already computed."""
    w = numpy.asarray(weights, numpy.float32).reshape(len(weights), -1)
    if sim is None:
        sim = similarity_matrix(w)
    n = len(sim)
    off = numpy.abs(sim[~numpy.eye(n, dtype=bool)])
    dupes = int((numpy.abs(numpy.triu(sim, 1)) >= threshold).sum())
    dead = int((numpy.linalg.norm(w, axis=1) == 0).sum())
    return {
        "n_units": n,
        "mean_abs_similarity": float(off.mean()) if n > 1 else 0.0,
        "max_abs_similarity": float(off.max()) if n > 1 else 0.0,
        "similar_pairs": dupes,
        "dead_units": dead,
    }


class WeightDiversity(PlotterBase):
    """The diversity of one forward's weight rows (the first layer's by
    default) each epoch: ``stats`` the latest summary, ``history`` all
    of them."""

    def __init__(self, workflow, unit=None, threshold=0.98, **kwargs):
        super().__init__(workflow, **kwargs)
        self.unit = unit
        self.threshold = float(threshold)
        self.stats = None
        self.history = []

    def make_payload(self):
        u = self.unit or self.workflow.forwards[0]
        if getattr(u, "weights", None) is None:
            return None
        w = weight_rows(u)
        sim = similarity_matrix(w)
        self.stats = diversity_stats(w, self.threshold, sim=sim)
        self.history.append(self.stats)
        if self.stats["similar_pairs"]:
            logger.warning(
                "%s: %d near-duplicate filter pair(s), max |cos|=%.3f",
                u.name, self.stats["similar_pairs"],
                self.stats["max_abs_similarity"])
        meta = {"kind": "image", "cmap": "coolwarm",
                "title": "%s filter cosine similarity" % u.name}
        return meta, {"image": sim}
