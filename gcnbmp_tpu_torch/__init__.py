"""gcnbmp_tpu_torch — the PyTorch/CUDA port of ``gcnbmp_tpu``.

A second package beside the JAX one, which stays unchanged and is the
reference every module here is tested against.  The port covers the
serving and training paths of the flagship model (packed GGNN encoder +
HolE head) on the fused path, and of the MPNN family (EdgeNet messages,
Set2Set readout, HolE head) on the coo path:

- ``data.wire``      the wire-compact COO batch encoding, the training
                     and evaluation batch iterators (numpy).
- ``ops``            plain torch ops (COO adjacency scatter, circular
                     correlation, the slot-table gather) and the fused
                     GGNN, MPNN and Set2Set kernels, forward and
                     backward, behind autograd functions (hand-written
                     CUDA for Hopper, ``ops/csrc``).
- ``models``         ``nn.Module`` twins of the JAX modules, with the
                     same parameter names as the flax trees.
- ``convert``        flax param tree <-> torch modules, ``.npz`` I/O,
                     seeded initialization.
- ``train``          config and presets, schedules, numpy metrics,
                     losses, the optimizer chain, the train step, the
                     trainer and its checkpoints.
- ``eval``, ``cli``  the packed pair evaluator, the predict and train
                     CLIs.

Host layers without a framework (``gcnbmp_tpu.chem``,
``gcnbmp_tpu.data.{parsers,dataset,packing,native_pack}``) are reused
from the JAX package, not copied.  Nothing here imports jax.
"""

__version__ = "0.1.0"
