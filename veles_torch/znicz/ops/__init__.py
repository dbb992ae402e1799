"""Layer ops of the PyTorch port (counterpart of
``veles/znicz_tpu/ops``)."""
