"""Hand-written Hopper kernels of the port, each beside its plain version.

``density_combine.density_combine`` / ``density_combine_wave`` (and its
one-op forms), ``theta_stats.theta_stats`` / ``theta_stats_batch`` (and the
wave's and the sharded bisection's rounds on its kernel), ``window_scan.
prefix_sum``, ``plan_wave.block_gather``, ``flash_attention.
flash_attention``, ``ssd_chunk.ssd_scan`` and ``record_select.
record_select`` / ``record_pack`` (a round's records, added by the port) are
CUDA C++ (``src/repro_torch/csrc/``), built at first use by
:mod:`repro_torch.kernels._lib`; :mod:`repro_torch.kernels.ops` exposes them
under the reference's names.  A wrapper given CPU tensors runs its plain
PyTorch version; given CUDA tensors it launches its kernel or raises.
``_lib.LAUNCHES`` counts the launches.
"""
