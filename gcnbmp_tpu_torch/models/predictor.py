"""The padded pair predictor (port of gcnbmp_tpu/models/predictor.py:21-292).

- ``PairPredictor``: ``encoder`` on both molecules (``encoder2`` on the
  second when ``siamese=False``), an optional co-attention module over
  the two sides' per-atom states (``models.coattention``), then the head;
  ``symmetric`` 'or'/'and' takes the max/min over both pair orders;
  ``mask_padding=False`` gives the encoders and co-attention no mask (the
  reference's live padding);
- ``predict_proba``: sigmoid probabilities and the pair's embeddings;
- ``set_up_predictor``: the factory of ``--method`` x ``--sim-method``
  (x ``--attn``), GGNN-GWM's ``GWMPairPredictor`` included;
  ``padded_kwargs_from_config`` reads its arguments from a run config,
  as the JAX ``Trainer`` passes them (loop.py:702-718).

The padded path reaches no Pallas kernel in the JAX package (its GGNN
aggregation is one XLA dot_general per layer), so the port runs it as
PyTorch ops, on the card when the tensors are there.  Parameter names
follow the flax tree (``encoder``, ``encoder2``, ``coattention``,
``head``), the same as the packed predictors', so one checkpoint serves
both layouts.  ``FixedEmbeddingPredictor`` (predictor.py:170-189) is a
head over two precomputed drug vectors (``train.fixed``).  The JAX
package's ``ResearchPairPredictor`` is ROADMAP queue 1, item 9.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gcnbmp_tpu_torch.models.heads import make_head


class PairPredictor(nn.Module):
    """``forward(atoms1, adj1, atoms2, adj2, mask1=None, mask2=None,
    deterministic=True, return_aux=False, generator=None)`` -> logits
    (with ``return_aux`` also the dict of ``g1``, ``g2`` (after
    co-attention), ``aux1``, ``aux2``).  ``generator`` feeds dropout in
    training."""

    def __init__(self, encoder: nn.Module, head: nn.Module,
                 encoder2: Optional[nn.Module] = None,
                 coattention: Optional[nn.Module] = None,
                 symmetric: Optional[str] = None, mask_padding: bool = True):
        super().__init__()
        if symmetric not in (None, "or", "and"):
            raise ValueError(f"symmetric={symmetric!r}")
        self.encoder = encoder
        if encoder2 is not None:
            self.encoder2 = encoder2
        if coattention is not None:
            self.coattention = coattention
        self.head = head
        self.symmetric = symmetric
        self.mask_padding = mask_padding

    @property
    def siamese(self) -> bool:
        return not hasattr(self, "encoder2")

    def _score(self, atoms1, adj1, mask1, atoms2, adj2, mask2,
               deterministic, generator):
        m1 = mask1 if self.mask_padding else None
        m2 = mask2 if self.mask_padding else None
        enc2 = self.encoder if self.siamese else self.encoder2
        g1, aux1 = self.encoder(atoms1, adj1, m1, deterministic, generator)
        g2, aux2 = enc2(atoms2, adj2, m2, deterministic, generator)
        if hasattr(self, "coattention"):
            g1, g2 = self.coattention(aux1["atoms"], g1, aux2["atoms"], g2,
                                      m1, m2)
        logits = self.head(g1, g2)
        return logits, {"g1": g1, "g2": g2, "aux1": aux1, "aux2": aux2}

    def forward(self, atoms1, adj1, atoms2, adj2, mask1=None, mask2=None,
                deterministic: bool = True, return_aux: bool = False,
                generator=None):
        logits, aux = self._score(atoms1, adj1, mask1, atoms2, adj2, mask2,
                                  deterministic, generator)
        if self.symmetric is not None:
            rev, _ = self._score(atoms2, adj2, mask2, atoms1, adj1, mask1,
                                 deterministic, generator)
            logits = (torch.maximum(logits, rev) if self.symmetric == "or"
                      else torch.minimum(logits, rev))
        if return_aux:
            return logits, aux
        return logits


class FixedEmbeddingPredictor(nn.Module):
    """A scoring head over fixed precomputed drug embeddings, the
    reference's DDIPredictor for mol2vec / autoencoder / SSP features:
    ``forward(e1, e2)`` -> ``head(e1, e2)``, with ``symmetric`` 'or'/'and'
    the max/min over both orders.  The head is the flax tree's ``head``."""

    def __init__(self, head: nn.Module, symmetric: Optional[str] = None):
        super().__init__()
        if symmetric not in (None, "or", "and"):
            raise ValueError(f"symmetric={symmetric!r}")
        self.head = head
        self.symmetric = symmetric

    def forward(self, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
        logits = self.head(e1, e2)
        if self.symmetric is not None:
            rev = self.head(e2, e1)
            logits = (torch.maximum(logits, rev) if self.symmetric == "or"
                      else torch.minimum(logits, rev))
        return logits


@torch.no_grad()
def predict_proba(predictor, atoms1, adj1, atoms2, adj2, mask1=None,
                  mask2=None, **kwargs):
    """Sigmoid probabilities and the pair's embeddings (g1, g2), the
    reference's ``predictor.predict`` contract; ``kwargs`` (a GWM
    predictor's ``super1``/``super2``) go to the predictor."""
    logits, aux = predictor(atoms1, adj1, atoms2, adj2, mask1, mask2,
                            deterministic=True, return_aux=True, **kwargs)
    return torch.sigmoid(logits), (aux["g1"], aux["g2"])


def set_up_predictor(
    method: str = "ggnn",
    fp_hidden_dim: int = 16,
    fp_out_dim: int = 16,
    conv_layers: int = 4,
    concat_hidden: bool = False,
    layer_aggregator: Optional[str] = None,
    fp_dropout_rate: float = 0.0,
    fp_batch_normalization: bool = False,
    weight_tying: bool = True,
    sim_method: str = "hole",
    class_num: int = 1,
    net_hidden_dims: Sequence[int] = (),
    attn_model: Optional[str] = None,
    siamese: bool = True,
    symmetric: Optional[str] = None,
    mask_padding: bool = True,
    coattn_n_max: Optional[int] = None,
    device=None,
) -> nn.Module:
    """The padded predictor of the JAX factory's arguments, on ``device``.
    ``coattn_n_max``, the padded atom count, sizes the ``lt``
    co-attention's weights.  ``method='ggnn-gwm'`` builds the
    ``GWMPairPredictor`` (the JAX factory ignores ``attn_model``,
    ``siamese``, ``mask_padding`` and the layer aggregator for it, and so
    does this one)."""
    from gcnbmp_tpu_torch.models import ENCODERS
    from gcnbmp_tpu_torch.models.coattention import build_coattention

    if method == "ggnn-gwm":
        from gcnbmp_tpu_torch.models.gwm import GGNN_GWM, GWMPairPredictor

        encoder = GGNN_GWM(
            out_dim=fp_out_dim, hidden_dim=fp_hidden_dim,
            hidden_dim_super=fp_hidden_dim, n_layers=conv_layers,
            dropout_ratio=fp_dropout_rate, concat_hidden=concat_hidden,
            weight_tying=weight_tying, device=device)
        head = make_head(sim_method, encoder.out_width, class_num,
                         tuple(net_hidden_dims), device=device)
        return GWMPairPredictor(encoder, head, symmetric=symmetric)
    if method not in ENCODERS:
        raise ValueError(f"unknown encoder method {method!r}")

    def make_encoder() -> nn.Module:
        return ENCODERS[method](
            out_dim=fp_out_dim, hidden_dim=fp_hidden_dim,
            n_layers=conv_layers, concat_hidden=concat_hidden,
            layer_aggregator=layer_aggregator, dropout_rate=fp_dropout_rate,
            batch_normalization=fp_batch_normalization,
            weight_tying=weight_tying, device=device)

    encoder = make_encoder()
    coattention = None
    width = encoder.out_width
    if attn_model is not None:
        if width != fp_out_dim:
            # flax infers the co-attention's molecule width from g; the
            # port's modules take g fp_out_dim wide
            raise ValueError(
                f"attn_model={attn_model!r} with molecule embeddings {width} "
                f"wide (concat_hidden): the port's co-attention takes "
                f"fp_out_dim={fp_out_dim}; ROADMAP queue 1, item 8")
        coattention = build_coattention(attn_model, fp_hidden_dim,
                                        fp_out_dim, coattn_n_max,
                                        device=device)
        width = coattention.out_width
    head = make_head(sim_method, width, class_num, tuple(net_hidden_dims),
                     device=device)
    return PairPredictor(encoder, head,
                         encoder2=None if siamese else make_encoder(),
                         coattention=coattention, symmetric=symmetric,
                         mask_padding=mask_padding)


def padded_kwargs_from_config(cfg: dict) -> dict:
    """``set_up_predictor`` kwargs from a run config dict (a
    ``config.json``, the port's or a JAX run's): the fields the JAX
    trainer passes its factory, ``TrainConfig``'s defaults for those it
    omits."""
    from gcnbmp_tpu_torch.train.config import TrainConfig

    c = TrainConfig.from_dict(cfg)
    return {
        "method": c.method,
        "fp_hidden_dim": int(c.fp_hidden_dim),
        "fp_out_dim": int(c.fp_out_dim),
        "conv_layers": int(c.conv_layers),
        "concat_hidden": bool(c.concat_hidden),
        "layer_aggregator": c.layer_aggregator,
        "fp_dropout_rate": float(c.fp_dropout_rate),
        "fp_batch_normalization": bool(c.fp_batch_normalization),
        "weight_tying": bool(c.weight_tying),
        "sim_method": c.sim_method,
        "class_num": int(c.class_num),
        "net_hidden_dims": tuple(c.net_hidden_dims or ()),
        "attn_model": c.attn,
        "siamese": bool(c.siamese),
        "symmetric": c.symmetric,
        "mask_padding": bool(c.mask_padding),
    }
