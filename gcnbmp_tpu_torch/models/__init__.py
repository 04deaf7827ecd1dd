"""nn.Module twins of the JAX package's models, and the padded encoders'
registry (port of gcnbmp_tpu/models/__init__.py:26-117): each ``--method``
string maps to a function taking the factory's uniform arguments, of which
RelGCN, GIN, MPNN, NFP and the GGNN-dev encoders use the ones they have.
GGNN alone takes the research options ``attention``, ``update_attention``
and ``context``; the other encoders refuse them with the JAX text."""


def _build_ggnn(out_dim, hidden_dim, n_layers, concat_hidden,
                layer_aggregator, dropout_rate, batch_normalization,
                weight_tying, attention=False, update_attention=False,
                context=False, device=None):
    from gcnbmp_tpu_torch.models.ggnn import GGNN

    return GGNN(
        out_dim=out_dim, hidden_dim=hidden_dim, n_layers=n_layers,
        concat_hidden=concat_hidden, layer_aggregator=layer_aggregator,
        dropout_rate=dropout_rate, batch_normalization=batch_normalization,
        weight_tying=weight_tying, use_attention=bool(attention),
        update_attention=bool(update_attention), context=bool(context),
        device=device)


def _build_relgcn(out_dim, hidden_dim, n_layers, concat_hidden,
                  layer_aggregator, dropout_rate, batch_normalization,
                  weight_tying, device=None, **attn_opts):
    from gcnbmp_tpu_torch.models.relgcn import RelGCN

    _reject_attention_opts("relgcn", attn_opts)
    return RelGCN(out_dim=out_dim, hidden_dim=hidden_dim, n_layers=n_layers,
                  device=device)


def _build_gin(out_dim, hidden_dim, n_layers, concat_hidden,
               layer_aggregator, dropout_rate, batch_normalization,
               weight_tying, device=None, **attn_opts):
    from gcnbmp_tpu_torch.models.gin import GIN

    _reject_attention_opts("gin", attn_opts)
    return GIN(out_dim=out_dim, hidden_dim=hidden_dim, n_layers=n_layers,
               dropout_ratio=dropout_rate, concat_hidden=concat_hidden,
               weight_tying=weight_tying, device=device)


def _build_mpnn(out_dim, hidden_dim, n_layers, concat_hidden,
                layer_aggregator, dropout_rate, batch_normalization,
                weight_tying, device=None, **attn_opts):
    from gcnbmp_tpu_torch.models.mpnn import MPNN

    _reject_attention_opts("mpnn", attn_opts)
    return MPNN(out_dim=out_dim, hidden_dim=hidden_dim, n_layers=n_layers,
                concat_hidden=concat_hidden, weight_tying=weight_tying,
                device=device)


def _build_nfp(out_dim, hidden_dim, n_layers, concat_hidden,
               layer_aggregator, dropout_rate, batch_normalization,
               weight_tying, device=None, **attn_opts):
    from gcnbmp_tpu_torch.models.nfp import NFP

    _reject_attention_opts("nfp", attn_opts)
    return NFP(out_dim=out_dim, hidden_dim=hidden_dim, n_layers=n_layers,
               concat_hidden=concat_hidden, device=device)


def _reject_attention_opts(method, opts):
    bad = [k for k, v in opts.items() if v]
    if bad:
        raise ValueError(
            f"encoder {method!r} does not support {bad} "
            "(GGNN-only options)")


def _build_ggnn_dev(variant):
    def build(out_dim, hidden_dim, n_layers, concat_hidden,
              layer_aggregator, dropout_rate, batch_normalization,
              weight_tying, device=None, **attn_opts):
        from gcnbmp_tpu_torch.models.ggnn_dev import GGNNDev

        _reject_attention_opts(f"ggnn-dev ({variant})", attn_opts)
        return GGNNDev(
            out_dim=out_dim, hidden_dim=hidden_dim, n_layers=n_layers,
            concat_hidden=concat_hidden, dropout_rate=dropout_rate,
            weight_tying=weight_tying, update_variant=variant, device=device)

    return build


# --method strings, as in the JAX registry
ENCODERS = {
    "ggnn": _build_ggnn,
    "relgcn": _build_relgcn,
    "gin": _build_gin,
    "mpnn": _build_mpnn,
    "nfp": _build_nfp,
    "ggnn-dev": _build_ggnn_dev("gru"),
    "ggnn-dev-fuse": _build_ggnn_dev("fuse"),
    "ggnn-dev-gate": _build_ggnn_dev("gate"),
    "ggnn-dev-self-loop": _build_ggnn_dev("self_loop"),
}
