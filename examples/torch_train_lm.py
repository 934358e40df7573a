"""End-to-end example on PyTorch: train an LM on NeedleTail-filtered corpus
slices, with checkpoints and auto-resume.

The corpus is an attribute-tagged token block store; the any-k engine fills
each batch from the densest unconsumed blocks that match the filter, its
refills on the card (kernels #1, #6 and #7).  Reduced mamba2-130m; the same
arguments as ``examples/train_lm.py`` plus ``--device cuda``.  Dropping
``--reduced`` from ``ARGS`` trains mamba2-130m at full width and depth (24
layers, d_model 768, vocab 50,280) on the card.

  PYTHONPATH=src python examples/torch_train_lm.py              # on the card
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu

Arguments given on the command line are appended to ``ARGS`` and win.
"""
import sys
import tempfile
from pathlib import Path

from repro_torch.launch.train import main

ARGS = [
    "--arch", "mamba2-130m", "--reduced",
    "--steps", "60", "--batch", "8", "--seq", "128",
    "--filter", "domain=code,quality=hi",
    "--corpus-seqs", "2048",
    "--ckpt-dir", str(Path(tempfile.gettempdir()) / "needletail_torch_ckpt"),
    "--ckpt-every", "20", "--log-every", "10",
    "--device", "cuda",
]

if __name__ == "__main__":
    main(ARGS + sys.argv[1:])
