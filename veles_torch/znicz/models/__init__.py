"""Samples of the PyTorch port (counterpart of
``veles/znicz_tpu/models``)."""
