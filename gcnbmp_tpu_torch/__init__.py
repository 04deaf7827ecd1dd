"""gcnbmp_tpu_torch — the PyTorch/CUDA port of ``gcnbmp_tpu``.

A second package beside the JAX one, which stays unchanged and is the
reference every module here is tested against.  The port covers the
serving and training paths of the flagship model (packed GGNN encoder +
HolE head) on the fused path, and of the MPNN family (EdgeNet messages,
Set2Set readout, HolE head) on the coo path:

- ``chem``, ``data``, ``native_lib``
                     the host layers (numpy): SMILES parsing and
                     featurizing, pair datasets, CSV parsing, COO packing
                     (Python and the native C++ of ``native/``), the
                     wire-compact batch encoding, the training, scan and
                     evaluation batch iterators.
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

The host layers are the port's own copies of the JAX package's
(``chem/{mol,smiles,featurize,native}.py``,
``data/{dataset,parsers,packing,native_pack}.py``, ``native_lib.py``,
under the JAX module names): nothing here imports jax or anything of
``gcnbmp_tpu``.
"""

__version__ = "0.1.0"
