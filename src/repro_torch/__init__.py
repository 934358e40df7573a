"""NeedleTail on PyTorch and CUDA: the any-k LIMIT engine ported from the JAX
package ``repro`` to an NVIDIA Hopper card.

The port keeps the reference's layout (``core/``, ``data/``, ``kernels/``) so
each module's counterpart is easy to find, and imports neither JAX nor
anything of ``repro``: where it needs a numpy-only helper of the reference it
keeps its own copy.

Devices are explicit.  Every entry point takes ``device``, which defaults to
``"cuda"`` and raises when CUDA is absent; ``"cpu"`` runs only when the
caller asks for it.  On a CUDA tensor each kernel wrapper launches its
hand-written kernel (``csrc/``) or raises; on a CPU tensor it runs the plain
PyTorch version beside it.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
