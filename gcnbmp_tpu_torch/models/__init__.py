"""nn.Module twins of the JAX package's models, and the padded encoders'
registry (port of gcnbmp_tpu/models/__init__.py:26-117): each ``--method``
string maps to a function taking the factory's uniform arguments, of which
RelGCN, GIN, MPNN and NFP use the ones they have.  GGNN's attention and
context options and the ``ggnn-dev*`` encoders are ROADMAP queue 1,
item 9."""


def _build_ggnn(out_dim, hidden_dim, n_layers, concat_hidden,
                layer_aggregator, dropout_rate, batch_normalization,
                weight_tying, device=None):
    from gcnbmp_tpu_torch.models.ggnn import GGNN

    return GGNN(
        out_dim=out_dim, hidden_dim=hidden_dim, n_layers=n_layers,
        concat_hidden=concat_hidden, layer_aggregator=layer_aggregator,
        dropout_rate=dropout_rate, batch_normalization=batch_normalization,
        weight_tying=weight_tying, device=device)


def _build_relgcn(out_dim, hidden_dim, n_layers, concat_hidden,
                  layer_aggregator, dropout_rate, batch_normalization,
                  weight_tying, device=None):
    from gcnbmp_tpu_torch.models.relgcn import RelGCN

    return RelGCN(out_dim=out_dim, hidden_dim=hidden_dim, n_layers=n_layers,
                  device=device)


def _build_gin(out_dim, hidden_dim, n_layers, concat_hidden,
               layer_aggregator, dropout_rate, batch_normalization,
               weight_tying, device=None):
    from gcnbmp_tpu_torch.models.gin import GIN

    return GIN(out_dim=out_dim, hidden_dim=hidden_dim, n_layers=n_layers,
               dropout_ratio=dropout_rate, concat_hidden=concat_hidden,
               weight_tying=weight_tying, device=device)


def _build_mpnn(out_dim, hidden_dim, n_layers, concat_hidden,
                layer_aggregator, dropout_rate, batch_normalization,
                weight_tying, device=None):
    from gcnbmp_tpu_torch.models.mpnn import MPNN

    return MPNN(out_dim=out_dim, hidden_dim=hidden_dim, n_layers=n_layers,
                concat_hidden=concat_hidden, weight_tying=weight_tying,
                device=device)


def _build_nfp(out_dim, hidden_dim, n_layers, concat_hidden,
               layer_aggregator, dropout_rate, batch_normalization,
               weight_tying, device=None):
    from gcnbmp_tpu_torch.models.nfp import NFP

    return NFP(out_dim=out_dim, hidden_dim=hidden_dim, n_layers=n_layers,
               concat_hidden=concat_hidden, device=device)


def _build_ggnn_dev(variant):
    def build(*args, **kwargs):
        raise ValueError(f"method 'ggnn-dev' ({variant}): the GGNNDev "
                         "encoders are not ported yet (ROADMAP queue 1, "
                         "item 9)")

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
