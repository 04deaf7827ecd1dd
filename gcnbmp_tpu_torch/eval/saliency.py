"""Atom-level saliency maps and SVG molecule rendering (port of
gcnbmp_tpu/eval/saliency.py:27-182).

Every padded encoder takes float atoms as already-embedded states, so
saliency is the gradient of the summed pair logit with respect to the two
embedded tensors (torch autograd, ``deterministic``, on the predictor's
device): vanilla gradients, integrated gradients (the midpoint rule from
zero) and Bayes-grad (the mean |gradient| under Gaussian embedding
noise) evaluate that one gradient function at different points.  Both
sides are embedded with ``encoder``'s table, as the JAX function embeds
them with ``params["encoder"]["embed"]`` (:33), also when
``siamese=False`` gives side 2 its own encoder (ROADMAP queue 3,
"Reference caveats").  The Bayes noise comes from a ``torch.Generator``
on the CPU (seed 0 unless one is given) and is moved to the device, so
the card and the CPU see the same noise; ``jax.random`` draws other
points, so the two packages agree there only at given noise points
(``embedding_grad_fn``).

Rendering is the JAX module's dependency-free force-directed 2D layout,
copied so that the SVG text is the same.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from gcnbmp_tpu_torch.chem.mol import Mol


def _tensor(x, device, dtype):
    return None if x is None else torch.as_tensor(x).to(device, dtype)


def embedding_grad_fn(predictor, adj1, adj2, mask1=None, mask2=None):
    """Returns ``(f_grad, embed)``: ``embed(atoms)`` looks up
    ``predictor.encoder``'s embedding table and ``f_grad(h1, h2) ->
    (g1, g2)`` is the gradient of the summed pair logit with respect to
    both embedded tensors."""
    device = next(predictor.parameters()).device
    table = predictor.encoder.embed.embedding.detach()
    adj1, adj2 = _tensor(adj1, device, torch.float32), _tensor(
        adj2, device, torch.float32)
    mask1, mask2 = _tensor(mask1, device, torch.float32), _tensor(
        mask2, device, torch.float32)

    def embed(atoms):
        return table[_tensor(atoms, device, torch.long)]

    def f_grad(h1, h2):
        h1 = h1.detach().requires_grad_(True)
        h2 = h2.detach().requires_grad_(True)
        with torch.enable_grad():
            out = predictor(h1, adj1, h2, adj2, mask1, mask2,
                            deterministic=True)
            return torch.autograd.grad(out.sum(), (h1, h2))

    return f_grad, embed


@contextlib.contextmanager
def _pre_embedded(predictor):
    """RelGCN's float path is the DrugFP raw-feature layer; for saliency
    float atoms mean "already embedded", as for every other encoder (the
    JAX function clones the encoder with ``pre_embedded=True``, :66-72).
    The parameters are unchanged."""
    from gcnbmp_tpu_torch.models.relgcn import RelGCN

    enc = getattr(predictor, "encoder", None)
    if not isinstance(enc, RelGCN) or enc.pre_embedded:
        yield
        return
    enc.pre_embedded = True
    try:
        yield
    finally:
        enc.pre_embedded = False


def atom_saliency(
    predictor,
    atoms1, adj1, atoms2, adj2, mask1=None, mask2=None,
    method: str = "gradient",
    steps: int = 16,
    n_samples: int = 8,
    noise_scale: float = 0.1,
    generator: Optional[torch.Generator] = None,
    multiply_input: bool = True,
) -> Dict[str, np.ndarray]:
    """Per-atom saliency for both molecules of each pair of a padded
    batch (numpy arrays or tensors), through the padded ``predictor``
    holding its weights.

    Returns {'mol1': (B, N), 'mol2': (B, N)}: the L2 norm over features
    of the embedding gradient (times the embedding when
    ``multiply_input``, the IntegratedGradients convention).
    """
    with _pre_embedded(predictor):
        grad_fn, embed = embedding_grad_fn(predictor, adj1, adj2, mask1,
                                           mask2)
        h1, h2 = embed(atoms1), embed(atoms2)

        if method == "gradient":
            g1, g2 = grad_fn(h1, h2)
        elif method == "integrated":
            g1, g2 = torch.zeros_like(h1), torch.zeros_like(h2)
            for alpha in (np.arange(steps) + 0.5) / steps:
                d1, d2 = grad_fn(float(alpha) * h1, float(alpha) * h2)
                g1, g2 = g1 + d1, g2 + d2
            g1, g2 = g1 / steps, g2 / steps
        elif method == "bayes":
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            g1, g2 = torch.zeros_like(h1), torch.zeros_like(h2)
            for _ in range(n_samples):
                n1 = torch.randn(h1.shape, generator=generator).to(h1.device)
                n2 = torch.randn(h2.shape, generator=generator).to(h2.device)
                d1, d2 = grad_fn(h1 + noise_scale * n1, h2 + noise_scale * n2)
                g1, g2 = g1 + d1.abs(), g2 + d2.abs()
            g1, g2 = g1 / n_samples, g2 / n_samples
        else:
            raise ValueError(f"unknown saliency method {method!r}")

    if multiply_input:
        g1, g2 = g1 * h1, g2 * h2
    return {
        "mol1": np.linalg.norm(g1.cpu().numpy(), axis=-1),
        "mol2": np.linalg.norm(g2.cpu().numpy(), axis=-1),
    }


# ---------------------------------------------------------------------------
# SVG rendering (dependency-free 2D layout)
# ---------------------------------------------------------------------------

def layout_2d(mol: Mol, iterations: int = 200, seed: int = 0) -> np.ndarray:
    """Simple force-directed 2D layout; returns (N, 2) coordinates."""
    n = mol.num_atoms
    rng = np.random.default_rng(seed)
    pos = rng.normal(scale=0.1, size=(n, 2))
    if n == 1:
        return np.zeros((1, 2))
    edges = [(b.a1, b.a2) for b in mol.bonds]
    ideal = 1.0
    for _ in range(iterations):
        disp = np.zeros_like(pos)
        diff = pos[:, None, :] - pos[None, :, :]
        dist2 = np.maximum((diff ** 2).sum(-1), 1e-4)
        disp += (diff / dist2[..., None] * 0.3).sum(axis=1)
        for a, b in edges:
            d = pos[a] - pos[b]
            dist = max(np.linalg.norm(d), 1e-4)
            f = (dist - ideal) * 0.5 * d / dist
            disp[a] -= f
            disp[b] += f
        pos += np.clip(disp, -0.2, 0.2)
    pos -= pos.mean(axis=0)
    return pos / max(np.abs(pos).max(), 1e-3)


def render_molecule_svg(
    mol: Mol,
    atom_values: Optional[np.ndarray] = None,
    size: int = 300,
) -> str:
    """Render a molecule as SVG with atoms colored by saliency
    (the SmilesVisualizer role, reference eval_saliency_map.py)."""
    pos = layout_2d(mol)
    pad = 30
    xy = (pos * (size / 2 - pad)) + size / 2
    vals = None
    if atom_values is not None:
        vals = np.asarray(atom_values, np.float64)[: mol.num_atoms]
        vmax = vals.max() if vals.max() > 0 else 1.0
        vals = vals / vmax

    def color(i):
        if vals is None:
            return "#cccccc"
        gb = int(255 * (1 - float(vals[i])))
        return f"#ff{gb:02x}{gb:02x}"

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}">',
        f'<rect width="{size}" height="{size}" fill="white"/>',
    ]
    for b in mol.bonds:
        x1, y1 = xy[b.a1]
        x2, y2 = xy[b.a2]
        w = {0: 1.5, 1: 3.0, 2: 4.5, 3: 2.5}[int(b.order)]
        dash = ' stroke-dasharray="4,2"' if int(b.order) == 3 else ""
        parts.append(
            f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" y2="{y2:.1f}" '
            f'stroke="black" stroke-width="{w}"{dash}/>'
        )
    for i, a in enumerate(mol.atoms):
        x, y = xy[i]
        parts.append(
            f'<circle cx="{x:.1f}" cy="{y:.1f}" r="11" fill="{color(i)}" '
            f'stroke="black" stroke-width="0.5"/>'
        )
        parts.append(
            f'<text x="{x:.1f}" y="{y + 4:.1f}" text-anchor="middle" '
            f'font-size="11" font-family="sans-serif">{a.symbol}</text>'
        )
    parts.append("</svg>")
    return "\n".join(parts)
