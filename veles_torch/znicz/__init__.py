"""The znicz plugin of the PyTorch port (counterpart of
``veles/znicz_tpu``)."""

# importing the op modules fills the layer registry
from veles_torch.znicz.ops import (  # noqa: F401
    activation, all2all, attention, conv, cutter, deconv, dropout, embedding, gd,
    gd_conv, gd_pooling, layernorm, mean_disp_normalizer, moe, normalization,
    pooling, transformer_stack)
