"""cooperativeimagecaptioning_tpu_torch: the PyTorch + CUDA port of
cooperativeimagecaptioning_tpu for NVIDIA Hopper (H100).

The JAX package beside it stays the reference.  Module names mirror it so
each counterpart can be found; parameters keep its nested-dict layout
({'w': [in, out], 'b': [out]}), so converting from JAX is a copy.  Every
Pallas kernel on a ported path becomes a hand-written CUDA kernel under
`csrc/`, with its plain PyTorch version beside it (`ops/kernels/`).

Ported: the whole single-device surface (serving, the three training
phases, evaluation, the reproduction chain, the paper's experiment drivers,
reference-checkpoint interop, the C++ host tier) and the (data, model)
process grid.  Importing this package imports nothing.
"""

__version__ = "0.1.0"
