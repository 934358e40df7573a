"""Hand-written Hopper kernels of the port, each beside its plain version.

``density_combine.density_combine_batch``, ``theta_stats.theta_stats_batch``
and ``plan_wave.block_gather`` are CUDA C++ (``src/repro_torch/csrc/``),
built at first use by :mod:`repro_torch.kernels._lib`.  A wrapper given CPU
tensors runs its plain PyTorch version; given CUDA tensors it launches its
kernel or raises.  ``_lib.LAUNCHES`` counts the launches.
"""
