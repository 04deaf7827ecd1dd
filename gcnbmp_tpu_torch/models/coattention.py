"""The co-attention family over a drug pair's atom states (port of
gcnbmp_tpu/models/coattention.py).

Every variant has the signature

    attn(atoms1 (B, N1, H), g1 (B, D), atoms2 (B, N2, H), g2 (B, D),
         mask1=None, mask2=None) -> (c1 (B, D'), c2 (B, D'))

with D' = D, except ``bimpm`` (3 D).  D is ``out_dim``, the width of the
module's own projections; g may be another width (``g_dim``: L·D under
``concat_hidden``, H under GGNN-dev's sum pool), which only ``para``
reads into weights of its own shape.  ``alter`` and ``circ`` need g D
wide, and the JAX modules raise at any other width (a flax
ScopeParamShapeError, a broadcast error): ``build_coattention`` refuses
such a width with those reasons, quoted.  The other variants read no g.
Masks are 1 on real atoms; ``None`` masks compute what the JAX module
computes without them.  Parameter names
and layouts follow the flax tree of the JAX module under its
predictor's ``coattention`` field: raw leaves (``W_0``, ``W``, ``V1``,
``b``, ``W1``, ``max_pooling_W``...) keep flax's shapes, Dense layers are
``nn.Linear`` (``j/dense``, ``att_0``).  flax infers the input widths
that these constructors take: the atom width H (``hidden_dim``), the
molecule embedding width D (``out_dim``), and for ``lt`` the atom table
widths N1 and N2.

The JAX predictor builds every variant with its defaults, so the port
keeps those as constants: one (tied) set of energy and gate weights for
both sides, ``ALTER_HEAD``/``AFFINITY_HEAD`` = 8 and ``PARA_HEAD`` = 1
energy columns, and BiMPM's ``BIMPM_EPS``.  The JAX module's other quirk
choices (:19-28) are kept: ``lt``'s projections are trainable and sized by
the table width, and BiMPM matches on the diagonal cos(W_k v1, W_k v2).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Type

import torch
from torch import nn

from gcnbmp_tpu_torch.models.layers import GraphLinear
from gcnbmp_tpu_torch.ops.circular import circular_correlation

COATTENTION_REGISTRY: Dict[str, Type[nn.Module]] = {}

NEG_INF = -1e9
ALTER_HEAD = 8
PARA_HEAD = 1
AFFINITY_HEAD = 8
BIMPM_EPS = 1e-4


def register(name: str):
    def deco(cls):
        COATTENTION_REGISTRY[name] = cls
        return cls

    return deco


def masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int) -> torch.Tensor:
    """Softmax over ``dim`` with an optional mask broadcastable to x
    (1 = keep); masked entries come out 0."""
    if mask is None:
        return torch.softmax(x, dim=dim)
    keep = mask > 0
    return torch.softmax(x.masked_fill(~keep, NEG_INF), dim=dim) * keep


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                dim: int) -> torch.Tensor:
    if mask is None:
        return x.mean(dim=dim)
    m = mask[..., None] if mask.dim() == x.dim() - 1 else mask
    return (x * m).sum(dim) / torch.clamp(m.sum(dim), min=1.0)


def _raw(*shape, device=None) -> nn.Parameter:
    """A raw flax leaf; ``convert.init_params`` fills it."""
    return nn.Parameter(torch.empty(shape, device=device))


def _expand(q: torch.Tensor, n: int) -> torch.Tensor:
    """(B, C) -> (B, n, C)."""
    return q[:, None, :].expand(q.shape[0], n, q.shape[-1])


def _masked_sum(z, mask):
    """Sum over the atom axis of z (B, N, C), padded atoms zeroed."""
    if mask is not None:
        z = z * mask[..., None]
    return z.sum(1)


class PairBilinear(nn.Module):
    """E[b, q, k] = act(key_k^T W query_q + V1 . key_k + V2 . query_q + b)
    over every (query, key) pair: (B, Nq, Nk) (coattention.py:73-94)."""

    def __init__(self, key_dim: int, query_dim: int,
                 activation: Callable = torch.tanh, device=None):
        super().__init__()
        self.activation = activation
        self.W = _raw(key_dim, query_dim, device=device)
        self.V1 = _raw(key_dim, 1, device=device)
        self.V2 = _raw(query_dim, 1, device=device)
        self.b = _raw(device=device)

    def forward(self, key, query):
        e = torch.einsum("bkh,hg,bqg->bqk", key, self.W, query)
        e = e + (key @ self.V1).transpose(-1, -2) + query @ self.V2
        return self.activation(e + self.b)


class _Coattention(nn.Module):
    """A variant's ``out_width``: ``out_factor`` times D, the head's input
    width."""

    out_factor = 1

    def __init__(self, out_dim: int):
        super().__init__()
        self.out_width = self.out_factor * out_dim


@register("alter")
class AlternatingCoattention(_Coattention):
    """Attend mol 1 with query g2, then mol 2 with query c1
    (coattention.py:97-129)."""

    def __init__(self, hidden_dim: int, out_dim: int, device=None):
        super().__init__(out_dim)
        self.energy1_0 = GraphLinear(out_dim + hidden_dim, ALTER_HEAD,
                                     device=device)
        self.energy2_0 = GraphLinear(ALTER_HEAD, 1, device=device)
        self.j = GraphLinear(hidden_dim, out_dim, device=device)

    def _attend(self, query, key, mask):
        x = torch.cat([_expand(query, key.shape[1]), key], dim=-1)
        energy = self.energy2_0(torch.tanh(self.energy1_0(x)))
        return masked_softmax(energy, None if mask is None else mask[..., None],
                              dim=1)

    def forward(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        c1 = _masked_sum(self._attend(g2, atoms1, mask1) * self.j(atoms1),
                         mask1)
        a2 = self._attend(c1, atoms2, mask2)
        return c1, _masked_sum(a2 * self.j(atoms2), mask2)


@register("para")
class ParallelCoattention(_Coattention):
    """Unnormalised tanh gate of a bilinear energy (atom, other mol's g)
    on each side (coattention.py:132-171)."""

    def __init__(self, hidden_dim: int, out_dim: int,
                 g_dim: Optional[int] = None, device=None):
        super().__init__(out_dim)
        g_dim = out_dim if g_dim is None else g_dim
        self.W_0 = _raw(hidden_dim, g_dim, PARA_HEAD, device=device)
        self.V1_0 = _raw(hidden_dim, PARA_HEAD, device=device)
        self.V2_0 = _raw(g_dim, PARA_HEAD, device=device)
        self.b_0 = _raw(PARA_HEAD, device=device)
        self.j = GraphLinear(hidden_dim, out_dim, device=device)

    def _attend(self, query, key):
        e = torch.einsum("bnh,hdk,bd->bnk", key, self.W_0, query)
        return torch.tanh(e + key @ self.V1_0 + (query @ self.V2_0)[:, None, :]
                          + self.b_0)

    def forward(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        z1 = self._attend(g2, atoms1) * self.j(atoms1)
        z2 = self._attend(g1, atoms2) * self.j(atoms2)
        return _masked_sum(z1, mask1), _masked_sum(z2, mask2)


@register("circ")
class CircularParallelCoattention(_Coattention):
    """Gate tanh(corr(j(atom), other mol's g)) (coattention.py:174-196)."""

    def __init__(self, hidden_dim: int, out_dim: int, device=None):
        super().__init__(out_dim)
        self.j = GraphLinear(hidden_dim, out_dim, device=device)

    def _side(self, atoms, g_other, mask):
        a = self.j(atoms)
        gate = torch.tanh(circular_correlation(a, _expand(g_other, a.shape[1])))
        return _masked_sum(gate * a, mask)

    def forward(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        return self._side(atoms1, g2, mask1), self._side(atoms2, g1, mask2)


class _AffinityCoattentionBase(_Coattention):
    """VQA/Nie skeleton (coattention.py:199-253): the affinity C (B, N2, N1)
    by a pairwise bilinear, row and column softmaxes, H = tanh(lt + L @
    lt_other), a softmax per atom, a weighted sum of j(atoms);
    ``n_prev_layers`` GraphLinear layers on each side first (the deep
    variants)."""

    n_prev_layers = 0

    def __init__(self, hidden_dim: int, out_dim: int, device=None):
        super().__init__(out_dim)
        self.energy = PairBilinear(hidden_dim, hidden_dim, self._activation(),
                                   device=device)
        for i in range(self.n_prev_layers):
            self.add_module(f"prev1_{i}", GraphLinear(hidden_dim, hidden_dim,
                                                      device=device))
            self.add_module(f"prev2_{i}", GraphLinear(hidden_dim, hidden_dim,
                                                      device=device))
        self.lt1 = GraphLinear(hidden_dim, AFFINITY_HEAD, bias=False,
                               device=device)
        self.lt2 = GraphLinear(hidden_dim, AFFINITY_HEAD, bias=False,
                               device=device)
        self.attn1 = GraphLinear(AFFINITY_HEAD, 1, bias=False, device=device)
        self.attn2 = GraphLinear(AFFINITY_HEAD, 1, bias=False, device=device)
        self.j = GraphLinear(hidden_dim, out_dim, device=device)

    @staticmethod
    def _activation():
        return torch.tanh

    def _tail(self, c, atoms1, atoms2, mask1, mask2):
        col = lambda m: None if m is None else m[..., None]
        l2 = masked_softmax(c, col(mask2), dim=1)
        l1 = masked_softmax(c.transpose(1, 2), col(mask1), dim=1)
        # zero the columns of the summed-over side's padded atoms
        if mask2 is not None:
            l1 = l1 * mask2[:, None, :]
        if mask1 is not None:
            l2 = l2 * mask1[:, None, :]
        for i in range(self.n_prev_layers):
            atoms1 = getattr(self, f"prev1_{i}")(atoms1)
            atoms2 = getattr(self, f"prev2_{i}")(atoms2)
        lt1, lt2 = self.lt1(atoms1), self.lt2(atoms2)
        h1 = torch.tanh(lt1 + torch.einsum("bij,bjh->bih", l1, lt2))
        h2 = torch.tanh(lt2 + torch.einsum("bij,bjh->bih", l2, lt1))
        a1 = masked_softmax(self.attn1(h1), col(mask1), dim=1)
        a2 = masked_softmax(self.attn2(h2), col(mask2), dim=1)
        return (_masked_sum(a1 * self.j(atoms1), mask1),
                _masked_sum(a2 * self.j(atoms2), mask2))

    def forward(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        return self._tail(self.energy(atoms1, atoms2), atoms1, atoms2, mask1,
                          mask2)


@register("vqa")
class VQAParallelCoattention(_AffinityCoattentionBase):
    """Lu et al.'s parallel co-attention (coattention.py:256-261)."""


@register("nie")
class NieFineCoattention(_AffinityCoattentionBase):
    """Nie's fine-grained co-attention (coattention.py:264-268)."""


@register("deep")
class DeepNieFineCoattention(_AffinityCoattentionBase):
    n_prev_layers = 1


@register("very-deep")
class VeryDeepNieFineCoattention(_AffinityCoattentionBase):
    n_prev_layers = 2


@register("extreme-deep")
class ExtremeDeepNieFineCoattention(_AffinityCoattentionBase):
    n_prev_layers = 3


@register("fourier")
class FourierFineCoattention(_AffinityCoattentionBase):
    """The affinity from the FFT of the atom features: one bilinear (no
    activation) on the real parts plus the same on the imaginary parts,
    then tanh (coattention.py:286-302)."""

    @staticmethod
    def _activation():
        return lambda x: x

    def forward(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        f1 = torch.fft.fft(atoms1.to(torch.complex64), dim=-1)
        f2 = torch.fft.fft(atoms2.to(torch.complex64), dim=-1)
        c = torch.tanh(self.energy(f1.real, f2.real)
                       + self.energy(f1.imag, f2.imag))
        return self._tail(c, atoms1, atoms2, mask1, mask2)


@register("pool")
class PoolingFineCoattention(_Coattention):
    """Affinity -> masked means over rows and columns -> a softmax per
    atom (coattention.py:305-326)."""

    def __init__(self, hidden_dim: int, out_dim: int, device=None):
        super().__init__(out_dim)
        self.energy = PairBilinear(hidden_dim, hidden_dim, device=device)
        self.j = GraphLinear(hidden_dim, out_dim, device=device)

    def forward(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        c = self.energy(atoms1, atoms2)  # (B, N2, N1)
        col = lambda m: None if m is None else m[..., None]
        e1 = masked_mean(c, col(mask2), dim=1)                  # (B, N1)
        e2 = masked_mean(c.transpose(1, 2), col(mask1), dim=1)  # (B, N2)
        a1 = masked_softmax(e1, mask1, dim=1)[..., None]
        a2 = masked_softmax(e2, mask2, dim=1)[..., None]
        return (a1 * self.j(atoms1)).sum(1), (a2 * self.j(atoms2)).sum(1)


@register("lt")
class LinearTransformFineCoattention(_Coattention):
    """attn_1 = C^T W1, attn_2 = C W2 with projections indexed by atom
    position (coattention.py:329-352): ``W1`` is (N2, D) and ``W2``
    (N1, D), so the table widths are fixed by the weights."""

    def __init__(self, hidden_dim: int, out_dim: int, n1: int, n2: int,
                 device=None):
        super().__init__(out_dim)
        self.energy = PairBilinear(hidden_dim, hidden_dim, device=device)
        self.W1 = _raw(n2, out_dim, device=device)
        self.W2 = _raw(n1, out_dim, device=device)
        self.j = GraphLinear(hidden_dim, out_dim, device=device)

    def forward(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        n1, n2 = atoms1.shape[1], atoms2.shape[1]
        if (n2, n1) != (self.W1.shape[0], self.W2.shape[0]):
            raise ValueError(
                f"lt co-attention holds weights for atom tables {self.W2.shape[0]}"
                f" and {self.W1.shape[0]} wide, got {n1} and {n2}")
        c = self.energy(atoms1, atoms2)                    # (B, N2, N1)
        a1 = torch.einsum("bji,jd->bid", c, self.W1)       # (B, N1, D)
        a2 = torch.einsum("bij,jd->bid", c, self.W2)       # (B, N2, D)
        return (_masked_sum(a1 * self.j(atoms1), mask1),
                _masked_sum(a2 * self.j(atoms2), mask2))


class _GlobalGate(_Coattention):
    """Per-dimension sigmoid gate ``att_{i}`` over [atom ‖ molecule means]
    times ``lt(atom)``; ``n_means`` is 1 for ``global`` (the other
    molecule's mean) and 2 for ``dual-global`` (the other's, then its
    own)."""

    n_means = 1

    def __init__(self, hidden_dim: int, out_dim: int, device=None):
        super().__init__(out_dim)
        self.att_0 = nn.Linear((1 + self.n_means) * hidden_dim, out_dim,
                               device=device)
        self.lt = GraphLinear(hidden_dim, out_dim, device=device)

    def _side(self, atoms, means, mask):
        n = atoms.shape[1]
        x = torch.cat([atoms, *(_expand(m, n) for m in means)], dim=-1)
        gate = torch.sigmoid(self.att_0(x))
        return _masked_sum(gate * self.lt(atoms), mask)

    def forward(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        ig1 = masked_mean(atoms1, mask1, dim=1)
        ig2 = masked_mean(atoms2, mask2, dim=1)
        own = self.n_means == 2
        return (self._side(atoms1, [ig2] + [ig1] * own, mask1),
                self._side(atoms2, [ig1] + [ig2] * own, mask2))


@register("global")
class GlobalCoattention(_GlobalGate):
    """Gate from [atom ‖ other molecule's mean] (coattention.py:355-385)."""


@register("dual-global")
class DualGlobalCoattention(_GlobalGate):
    """Gate from [atom ‖ other molecule's mean ‖ own mean]
    (coattention.py:388-422)."""

    n_means = 2


@register("neural")
class NeuralCoattention(_Coattention):
    """doc = relu(att(atom)), context = relu(att(other molecule's mean)),
    gate sigmoid(doc . context) (coattention.py:425-456)."""

    def __init__(self, hidden_dim: int, out_dim: int, device=None):
        super().__init__(out_dim)
        self.att_0 = GraphLinear(hidden_dim, out_dim, device=device)

    def _side(self, atoms, q, mask):
        context = torch.relu(self.att_0(q[:, None, :]))          # (B, 1, D)
        doc = torch.relu(self.att_0(atoms))                      # (B, N, D)
        energy = torch.sigmoid(torch.einsum("bnd,bod->bno", doc, context))
        return _masked_sum(energy * doc, mask)

    def forward(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        ig1 = masked_mean(atoms1, mask1, dim=1)
        ig2 = masked_mean(atoms2, mask2, dim=1)
        return self._side(atoms1, ig2, mask1), self._side(atoms2, ig1, mask2)


def _unit(v: torch.Tensor, dim: int) -> torch.Tensor:
    # eps inside the sqrt keeps the gradient finite at v == 0 (padded atoms)
    return v * torch.rsqrt((v * v).sum(dim, keepdim=True) + 1e-12)


@register("bimpm")
class BiMPM(_Coattention):
    """Bilateral multi-perspective matching (coattention.py:459-538):
    max-pooling, attentive-mean and attentive-max matchers with
    ``out_dim`` perspectives each, so the output is 3 ``out_dim`` wide."""

    out_factor = 3

    def __init__(self, hidden_dim: int, out_dim: int, device=None):
        super().__init__(out_dim)
        for name in ("max_pooling_W", "att_mean_W", "att_max_W"):
            self.register_parameter(name, _raw(out_dim, hidden_dim,
                                               device=device))

    @staticmethod
    def _match(v1, v2, w):
        """m[b, n, k] = cos(w_k * v1[b, n], w_k * v2[b, n])."""
        return (_unit(v1[..., None, :] * w, -1)
                * _unit(v2[..., None, :] * w, -1)).sum(-1)

    def forward(self, atoms1, g1, atoms2, g2, mask1=None, mask2=None):
        pair = None
        if mask1 is not None and mask2 is not None:
            pair = mask1[:, :, None] * mask2[:, None, :]     # (B, N1, N2)
        # max pooling over the pairwise matches (B, N1, N2, head)
        w = self.max_pooling_W
        mv = torch.einsum("bikh,bjkh->bijk",
                          _unit(atoms1[:, :, None, :] * w, -1),
                          _unit(atoms2[:, :, None, :] * w, -1))
        if pair is not None:
            mv = mv.masked_fill(~(pair[..., None] > 0), NEG_INF)
        mv1, mv2 = [torch.amax(mv, dim=2)], [torch.amax(mv, dim=1)]
        # attentive matches against the cosine-attended other molecule
        att = torch.einsum("bih,bjh->bij", _unit(atoms1, -1), _unit(atoms2, -1))
        if pair is not None:
            att = att * pair
        att_atoms2 = atoms2[:, None, :, :] * att[..., None]  # (B, N1, N2, H)
        att_atoms1 = atoms1[:, :, None, :] * att[..., None]
        mean2 = att_atoms2.sum(2) / torch.clamp(att.sum(2, keepdim=True),
                                                min=BIMPM_EPS)
        mean1 = att_atoms1.sum(1) / torch.clamp(
            att.sum(1, keepdim=True).transpose(1, 2), min=BIMPM_EPS)
        mv1.append(self._match(atoms1, mean2, self.att_mean_W))
        mv2.append(self._match(atoms2, mean1, self.att_mean_W))
        mv1.append(self._match(atoms1, torch.amax(att_atoms2, dim=2),
                               self.att_max_W))
        mv2.append(self._match(atoms2, torch.amax(att_atoms1, dim=1),
                               self.att_max_W))
        return (_masked_sum(torch.cat(mv1, dim=-1), mask1),
                _masked_sum(torch.cat(mv2, dim=-1), mask2))


def g_width_problem(name: str, hidden_dim: int, out_dim: int,
                    g_dim: int) -> Optional[str]:
    """Why the JAX variant ``name`` raises on molecule embeddings ``g_dim``
    wide (its error, quoted), or None when it takes them."""
    if g_dim == out_dim:
        return None
    if name == "alter":
        # the tied energy1_0 reads [g2 ‖ atom], then [c1 ‖ atom]
        return (f"attn='alter' over molecule embeddings {g_dim} wide with "
                f"out_dim={out_dim}: the JAX module raises flax's "
                "ScopeParamShapeError 'For parameter \"kernel\" in "
                "\"/coattention/energy1_0/dense\", the given initializer "
                "is expected to generate shape "
                f"({out_dim + hidden_dim}, {ALTER_HEAD}), "
                "but the existing parameter it received has shape "
                f"({g_dim + hidden_dim}, {ALTER_HEAD})'")
    if name == "circ":
        return (f"attn='circ' over molecule embeddings {g_dim} wide with "
                f"out_dim={out_dim}: the JAX module raises 'ValueError: "
                f"Incompatible shapes for broadcasting: (B, 1, {g_dim}) and "
                f"requested shape (B, N, {out_dim})'")
    return None


def build_coattention(name: str, hidden_dim: int, out_dim: int,
                      n_max: Optional[int] = None,
                      g_dim: Optional[int] = None, device=None) -> nn.Module:
    """The ``--attn`` variant ``name`` (coattention.py:541-550) over atoms
    H = ``hidden_dim`` wide, molecule embeddings ``g_dim`` wide (default
    ``out_dim``) and projections D = ``out_dim`` wide; ``n_max``, the atom
    table width, sizes ``lt``'s weights.  A width the JAX module raises on
    is refused with its reason (``g_width_problem``)."""
    if name not in COATTENTION_REGISTRY:
        raise ValueError(f"unknown co-attention {name!r}; available: "
                         f"{sorted(COATTENTION_REGISTRY)}")
    cls = COATTENTION_REGISTRY[name]
    g_dim = out_dim if g_dim is None else g_dim
    problem = g_width_problem(name, hidden_dim, out_dim, g_dim)
    if problem:
        raise ValueError(problem)
    if cls is LinearTransformFineCoattention:
        if n_max is None:
            raise ValueError("lt co-attention sizes its W1/W2 by the atom "
                             "table width: pass n_max")
        return cls(hidden_dim, out_dim, n_max, n_max, device=device)
    if cls is ParallelCoattention:
        return cls(hidden_dim, out_dim, g_dim, device=device)
    return cls(hidden_dim, out_dim, device=device)
