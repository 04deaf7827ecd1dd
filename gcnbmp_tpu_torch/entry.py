"""The port's twin of the JAX package's ``__graft_entry__.entry()``
(__graft_entry__.py:14-55): the padded flagship pair predictor (GGNN,
8 untied layers, H = D = 32, HolE head, one logit) with seeded weights,
and its example batch (B = 8, N = 32, from a seeded numpy generator).

    from gcnbmp_tpu_torch import entry
    forward, args = entry.entry()          # on the card
    logits = forward(*args)                # (8, 1)

``forward`` is the predictor itself (an ``nn.Module`` in eval mode,
deterministic), so the caller can load other weights into it
(``convert.from_jax_params``).  The multi-device dry run of the JAX
module is ROADMAP queue 1, item 11.
"""

from __future__ import annotations

import numpy as np
import torch

SEED = 0


def _example_batch(batch=8, n_atoms=32, seed=0):
    """atoms (B, N) int32, adj (B, 4, N, N) f32 (a path with random bond
    types), mask (B, N) of ones, labels (B,): the JAX module's draws."""
    rng = np.random.default_rng(seed)
    atoms = rng.integers(1, 54, size=(batch, n_atoms)).astype(np.int32)
    adj = np.zeros((batch, 4, n_atoms, n_atoms), dtype=np.float32)
    for b in range(batch):
        for i in range(n_atoms - 1):
            e = int(rng.integers(0, 4))
            adj[b, e, i, i + 1] = adj[b, e, i + 1, i] = 1.0
    mask = np.ones((batch, n_atoms), dtype=np.float32)
    labels = rng.integers(0, 2, size=(batch,)).astype(np.float32)
    return atoms, adj, mask, labels


FLAGSHIP = dict(method="ggnn", fp_hidden_dim=32, fp_out_dim=32,
                conv_layers=8, weight_tying=False, sim_method="hole",
                class_num=1)


def entry(device="cuda"):
    """(forward, args) on ``device``: the flagship predictor and
    (atoms, adj, atoms, adj, mask, mask) of the example batch."""
    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.models.predictor import set_up_predictor

    device = torch.device(device)
    model = from_jax_params(init_params(FLAGSHIP, SEED, padded=True),
                            set_up_predictor(**FLAGSHIP)).to(device).eval()
    atoms, adj, mask, _ = _example_batch()
    a, j, m = (torch.as_tensor(x).to(device) for x in (atoms, adj, mask))
    return model, (a, j, a, j, m, m)
