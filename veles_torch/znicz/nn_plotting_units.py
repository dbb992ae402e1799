"""NN plotting units of the PyTorch port: error curves, weight imagers,
the confusion matrix and the Kohonen maps.

Counterpart of ``veles/znicz_tpu/nn_plotting_units.py``, with the same
payloads (meta and arrays, equal to the reference's on the same weights
and history). A plotter runs once an epoch, after the decision ended it
(the workflow's ``plotters``, ``standard_workflow.py``), so it reads
host data only then: the decision's ``history``, the evaluator's
confusion matrix and a forward's parameters (``export_params``), each
copied to the host once; it never reads a device tensor inside a class.
The payload goes to the workflow's ``graphics`` server when the launcher
attached one, else it is rendered in this process into ``out_dir``
(``graphics_client.render_payload``).
"""

import os

import numpy

from veles_torch.graphics_client import render_payload


def host_weights(unit):
    """The unit's weights as an f32 host array."""
    return unit.export_params()["weights"].detach().float().cpu().numpy()


def weight_rows(unit):
    """The unit's weights as (units, fan_in) rows: a convolution stores
    (n_kernels, fan_in) already, a dense layer (fan_in, neurons) unless
    ``weights_transposed``."""
    w = host_weights(unit)
    if hasattr(unit, "n_kernels") or getattr(unit, "weights_transposed",
                                             False):
        return w
    return w.T


def _has_weights(unit):
    return unit is not None and getattr(unit, "weights", None) is not None


class PlotterBase:
    """Publishes one payload an epoch."""

    def __init__(self, workflow, name=None, out_dir=None):
        self.workflow = workflow
        self.name = name or type(self).__name__
        self.out_dir = out_dir

    def make_payload(self):
        """-> (meta dict with ``kind``, {name: ndarray}), or None to skip
        this epoch."""
        raise NotImplementedError

    def run(self):
        payload = self.make_payload()
        if payload is None:
            return
        meta, arrays = payload
        meta.setdefault("name", self.name)
        gfx = self.workflow.graphics
        if gfx is not None:
            gfx.publish(meta, arrays)
        elif self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            render_payload(meta, arrays, self.out_dir)


class AccumulatingPlotter(PlotterBase):
    """Per-epoch curves of one history field, a line per class."""

    def __init__(self, workflow, field="metric", **kwargs):
        super().__init__(workflow, **kwargs)
        self.field = field

    def make_payload(self):
        hist = self.workflow.decision.history
        if not hist:
            return None
        series = {}
        for cls_name in ("test", "validation", "train"):
            ys = [h[cls_name][self.field] for h in hist if cls_name in h]
            if ys:
                series[cls_name] = numpy.asarray(ys, numpy.float32)
        meta = {"kind": "curves", "title": "%s per epoch" % self.field,
                "ylabel": self.field, "series": sorted(series)}
        return meta, series


class Weights2D(PlotterBase):
    """Tiles each neuron's or kernel's weights as a 2-D patch (the first
    forward's by default)."""

    def __init__(self, workflow, unit=None, limit=64, **kwargs):
        super().__init__(workflow, **kwargs)
        self.unit = unit
        self.limit = int(limit)

    def make_payload(self):
        u = self.unit or self.workflow.forwards[0]
        if not _has_weights(u):
            return None
        tiles = weight_rows(u)[:self.limit]
        n, fan_in = tiles.shape
        # a convolution knows its kernel's shape; a dense layer gets the
        # squarest rectangle
        if hasattr(u, "kx") and hasattr(u, "ky"):
            c = fan_in // (u.ky * u.kx)
            patch = tiles.reshape(n, u.ky, u.kx, c)[..., 0]
        else:
            side = int(numpy.sqrt(fan_in))
            while fan_in % side:
                side -= 1
            patch = tiles.reshape(n, side, fan_in // side)
        meta = {"kind": "grid", "title": "%s weights" % u.name}
        return meta, {"tiles": patch}


class ConfusionMatrixPlotter(PlotterBase):
    """The evaluator's confusion matrix, accumulated over the run."""

    def make_payload(self):
        cm = getattr(self.workflow.evaluator, "confusion_matrix", None)
        if cm is None:
            return None
        meta = {"kind": "matrix", "title": "confusion",
                "xlabel": "label", "ylabel": "prediction"}
        return meta, {"matrix": cm.cpu().numpy().astype(numpy.int32)}


class KohonenNeighborMap(PlotterBase):
    """The SOM's U-matrix: each cell the mean distance of its weights to
    its grid neighbours'."""

    def __init__(self, workflow, forward=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.forward = forward

    def make_payload(self):
        f = self.forward
        if not _has_weights(f):
            return None
        gy, gx = f.grid_shape
        w = host_weights(f).reshape(gy, gx, -1)
        umatrix = numpy.zeros((gy, gx), numpy.float32)
        for y in range(gy):
            for x in range(gx):
                dists = []
                for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    ny, nx = y + dy, x + dx
                    if 0 <= ny < gy and 0 <= nx < gx:
                        dists.append(numpy.linalg.norm(w[y, x] - w[ny, nx]))
                umatrix[y, x] = numpy.mean(dists)
        meta = {"kind": "image", "title": "SOM U-matrix", "cmap": "bone"}
        return meta, {"image": umatrix}


class KohonenHits(PlotterBase):
    """How many samples of the dataset each SOM cell wins, from the
    current weights on the host (the reference's numpy distance)."""

    def __init__(self, workflow, forward=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.forward = forward

    def make_payload(self):
        f = self.forward
        if not _has_weights(f):
            return None
        x = numpy.asarray(self.workflow.loader.original_data, numpy.float32)
        x2 = x.reshape(len(x), -1)
        w = host_weights(f)
        dist = (w * w).sum(axis=1)[None, :] - 2.0 * (x2 @ w.T)
        hits = numpy.bincount(numpy.argmin(dist, axis=1),
                              minlength=f.neurons).astype(numpy.float32)
        meta = {"kind": "image", "title": "SOM hits", "cmap": "hot"}
        return meta, {"image": hits.reshape(f.grid_shape)}
