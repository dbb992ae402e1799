"""Loaders of the PyTorch port (counterpart of ``veles/loader``)."""
