"""data modules of the PyTorch port (counterparts of ``repro.data``)."""
