"""Entry points: step factories, the serving and training launchers, meshes,
input stand-ins and the production dry run.

``repro/launch/hlo_analysis.py`` has no counterpart here: it walks the
optimised XLA HLO text a compiled cell prints, and the port compiles
nothing.  The port's dry run (:mod:`repro_torch.launch.dryrun`) counts one
device's FLOPs and collectives at dispatch instead, and reports no HBM
traffic.
"""
