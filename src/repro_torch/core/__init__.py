"""core modules of the PyTorch port (counterparts of ``repro.core``)."""
