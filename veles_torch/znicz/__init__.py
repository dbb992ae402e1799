"""The znicz plugin of the PyTorch port (counterpart of
``veles/znicz_tpu``)."""

# importing the op modules fills the layer registry
from veles_torch.znicz.ops import all2all, gd  # noqa: F401
