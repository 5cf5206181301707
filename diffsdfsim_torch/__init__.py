"""diffsdfsim_torch: the PyTorch/CUDA port of diffsdfsim_tpu.

It keeps the JAX package's module layout and public names. Plain tensor code
is PyTorch; each Pallas TPU kernel on a ported path is a hand-written CUDA
kernel for Hopper (``ops/csrc/``), built with nvcc at first use. Ported so
far: the bounce rollout and its gradient. Bodies with the MeshSDF surface
gradient, contacts (Frank-Wolfe kernel K3), the PDIPM contact solver (kernel
K1) with its KKT implicit-diff backward (kernel K2), the time-of-contact
differential and the staged probe-ladder stepping with a differentiable
replay of the accepted rung.

Entry points run on CUDA unless the caller passes ``device="cpu"``, which
takes the kernels' plain PyTorch versions.
"""

from . import config
from .config import Defaults, Defaults3D, SimConfig

__all__ = ["config", "Defaults", "Defaults3D", "SimConfig"]
