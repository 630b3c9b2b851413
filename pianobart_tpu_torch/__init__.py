"""PyTorch / CUDA port of pianobart_tpu for one NVIDIA H100.

The JAX package ``pianobart_tpu`` is the reference; this package imports
nothing from it (nor ``jax``).  Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""

import torch as _torch

# On the CPU, torch's exp, log, sin, cos, sqrt and tanh of a float tensor call
# MKL's vector math (VML), which picks each function's code on its first call.
# When that first call is a parallel one, its threads can race: one has been
# seen running VML's AVX2 low-accuracy exp (relative error up to 1.5e-4, bit
# for bit ``vmsExp`` in its "EP" mode) on its half of the tensor, where the
# other ran the AVX-512 one torch asks for (exact to 1 ulp).  A call on one
# element, here, makes each function's first call a single-threaded one.
for _f in (_torch.exp, _torch.log, _torch.sin, _torch.cos, _torch.sqrt, _torch.tanh):
    _f(_torch.ones(1))
del _f
