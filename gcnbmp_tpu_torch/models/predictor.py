"""The padded pair predictor (port of gcnbmp_tpu/models/predictor.py:21-292).

- ``PairPredictor``: ``encoder`` on both molecules (``encoder2`` on the
  second when ``siamese=False``), an optional co-attention module over
  the two sides' per-atom states (``models.coattention``), then the head;
  ``symmetric`` 'or'/'and' takes the max/min over both pair orders;
  ``mask_padding=False`` gives the encoders and co-attention no mask (the
  reference's live padding);
- ``predict_proba``: sigmoid probabilities and the pair's embeddings;
- ``ResearchPairPredictor`` (predictor.py:91-167): a GGNN-dev encoder
  whose first and last layers' atom states [h_1 ‖ h_L] (2H wide) feed
  the co-attention, with an LSTM over each side's per-layer readouts
  (``use_s_lstm``: ``s_lstm_1``, ``s_lstm_2``) and one over the pairs of
  them (``use_i_lstm``: ``i_lstm``); an MLP head reads left = [g1, s1]
  and right = [i, s2, g2], the documented intent (the reference drops
  them before its MLP), any other head (g1, g2);
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
head over two precomputed drug vectors (``train.fixed``).  No CLI of the
JAX package reaches ``ResearchPairPredictor``; its tests hold it, and the
port's hold the port's against it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gcnbmp_tpu_torch.models.heads import MLPHead, make_head
from gcnbmp_tpu_torch.models.layers import OptimizedLSTMCell, lstm_scan


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


def _lstm_last(cell: OptimizedLSTMCell, seq) -> torch.Tensor:
    """The last output of ``cell`` run over the list ``seq``."""
    return lstm_scan(cell, torch.stack(seq, dim=1))[:, -1]


class ResearchPairPredictor(nn.Module):
    """``forward(atoms1, adj1, atoms2, adj2, mask1=None, mask2=None,
    deterministic=True, return_aux=False, generator=None)`` -> logits.
    The encoder (``encoder2`` on side 2 when given) must return
    ``h_list`` and ``g_list`` in its aux, as ``GGNNDev`` does, and have
    ``out_dim``, the width of its per-layer readouts; the co-attention
    takes atoms 2H wide.  Build the head with ``head_widths``."""

    def __init__(self, encoder: nn.Module, head: nn.Module,
                 coattention: Optional[nn.Module] = None,
                 encoder2: Optional[nn.Module] = None,
                 use_s_lstm: bool = False, use_i_lstm: bool = False,
                 device=None):
        super().__init__()
        self.encoder = encoder
        if encoder2 is not None:
            self.encoder2 = encoder2
        if coattention is not None:
            self.coattention = coattention
        self.head = head
        self.use_s_lstm = use_s_lstm
        self.use_i_lstm = use_i_lstm
        d = encoder.out_dim
        if use_s_lstm:
            self.s_lstm_1 = OptimizedLSTMCell(d, d, device=device)
            self.s_lstm_2 = OptimizedLSTMCell(d, d, device=device)
        if use_i_lstm:
            self.i_lstm = OptimizedLSTMCell(2 * d, 2 * d, device=device)

    @staticmethod
    def head_widths(encoder: nn.Module, coattention: Optional[nn.Module],
                    use_s_lstm: bool, use_i_lstm: bool, mlp: bool):
        """(left, right) widths the head reads: g's (the co-attention's
        output, else the encoder's), plus with an MLP head the LSTMs'."""
        g = (encoder.out_width if coattention is None
             else coattention.out_width)
        if not mlp:
            return g, g
        d = encoder.out_dim
        return (g + d * use_s_lstm,
                g + d * use_s_lstm + 2 * d * use_i_lstm)

    def forward(self, atoms1, adj1, atoms2, adj2, mask1=None, mask2=None,
                deterministic: bool = True, return_aux: bool = False,
                generator=None):
        enc2 = getattr(self, "encoder2", self.encoder)
        g1, aux1 = self.encoder(atoms1, adj1, mask1, deterministic, generator)
        g2, aux2 = enc2(atoms2, adj2, mask2, deterministic, generator)
        a1 = torch.cat([aux1["h_list"][0], aux1["h_list"][-1]], dim=-1)
        a2 = torch.cat([aux2["h_list"][0], aux2["h_list"][-1]], dim=-1)
        left, right = [], []
        if self.use_s_lstm:
            left.append(_lstm_last(self.s_lstm_1, aux1["g_list"]))
            right.append(_lstm_last(self.s_lstm_2, aux2["g_list"]))
        if self.use_i_lstm:
            right.insert(0, _lstm_last(self.i_lstm, [
                torch.cat([ga, gb], dim=-1)
                for ga, gb in zip(aux1["g_list"], aux2["g_list"])]))
        if hasattr(self, "coattention"):
            g1, g2 = self.coattention(a1, g1, a2, g2, mask1, mask2)
        if isinstance(self.head, MLPHead) and (left or right):
            logits = self.head(torch.cat([g1] + left, dim=-1),
                               torch.cat(right + [g2], dim=-1))
        else:
            logits = self.head(g1, g2)
        if return_aux:
            return logits, {"g1": g1, "g2": g2, "aux1": aux1, "aux2": aux2}
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
    attention: Optional[str] = None,
    update_attention: bool = False,
    context: bool = False,
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
    co-attention's weights.  ``attention``, ``update_attention`` and
    ``context`` are GGNN's research options (the other encoders refuse
    them); no run config sets them, as in the JAX package.  The
    co-attention reads g as wide as the encoder makes it.
    ``method='ggnn-gwm'`` builds the ``GWMPairPredictor`` (the JAX factory
    ignores ``attn_model``, ``siamese``, ``mask_padding``, the layer
    aggregator and the research options for it, and so does this one)."""
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
            weight_tying=weight_tying, attention=attention,
            update_attention=update_attention, context=context,
            device=device)

    encoder = make_encoder()
    coattention = None
    width = encoder.out_width
    if attn_model is not None:
        coattention = build_coattention(attn_model, fp_hidden_dim,
                                        fp_out_dim, coattn_n_max,
                                        g_dim=width, device=device)
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
