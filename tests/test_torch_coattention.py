"""The port's co-attention family against the JAX package on the CPU.

- each of the 15 variants against the JAX module, outputs and the
  gradients of every parameter and input, with masks and without;
- each of the 15 variants in the padded predictor over molecule
  embeddings of another width than ``fp_out_dim``: L·D (GGNN with
  ``concat_hidden``) and H (GGNN-dev's sum pool), logits and every
  gradient against the JAX predictor; ``alter`` and ``circ``, which the
  JAX modules cannot run there, refused with the JAX error quoted;
- the packed co-attention predictor (the GGNN kernel path's plain
  versions in the K1/K1b form and the two-pass K1m/K3 form, the slot
  table gather, co-attention, the head) against the JAX predictor on
  sample batches, logits and every gradient;
- the parameter tree of every variant and head against the JAX
  predictor's, and the converter's round trip;
- the host side (slot tables, the injectivity check, the wire, the row
  map) against the JAX functions;
- training: one step against the JAX coo train step, the configuration
  checks, the Trainer's table width, the train CLI and the predict CLI;
  the ``lt`` table width refused where the JAX package cannot serve it.

Weights come from ``convert.init_params`` / ``init_module_params`` with a
seed, inputs from numpy with a seed.  The CUDA kernels on this path (K1,
K1b, K1m, K3) are held against these plain versions on the card by
chip_smoke.py."""

import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.data import packing as jpacking
from gcnbmp_tpu.data.dataset import make_batch as jmake_batch
from gcnbmp_tpu.data.parsers import CSVPairParser
from gcnbmp_tpu.eval.evaluate import PackedPairEvaluator as JaxEvaluator
from gcnbmp_tpu.models import coattention as jcoattn
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.models import set_up_predictor as jset_up_predictor
from gcnbmp_tpu.ops import slotgather as jslot
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.cli import predict
from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_module_params, init_params, load_params_npz,
    named_to_tree, save_params_npz, to_jax_params)
from gcnbmp_tpu_torch.data import packing as tpacking
from gcnbmp_tpu_torch.data.wire import compact_coattn_arrays
from gcnbmp_tpu_torch.eval.evaluate import PackedPairEvaluator
from gcnbmp_tpu_torch.models import coattention as tcoattn
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.models.predictor import set_up_predictor
from gcnbmp_tpu_torch.ops import fused_ggnn as tfg
from gcnbmp_tpu_torch.ops.slotgather import side_mol_row
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import PRESETS, TrainConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
RTOL, ATOL = 1e-4, 1e-5              # outputs
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6    # per tensor, times max|want|
VARIANTS = sorted(tcoattn.COATTENTION_REGISTRY)
HEADS = ["hole", "ntn", "dist-mult", "mlp", "symmlp", "cosine"]


def _dataset(n):
    return CSVPairParser().parse(pd.read_csv(SAMPLE).head(n)).dataset


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _shapes(tree):
    return {k: v.shape for k, v in _flat(tree).items()}


def _assert_grads(got: dict, want: dict):
    """|got - want| <= GRAD_RTOL * max|want| + GRAD_ATOL, tensor by tensor;
    a gradient the port leaves None counts as zeros."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = np.zeros_like(w) if got[k] is None else np.asarray(got[k])
        assert g.shape == w.shape, k
        err = float(np.abs(g - w).max()) if w.size else 0.0
        bound = GRAD_RTOL * float(np.abs(w).max(initial=0.0)) + GRAD_ATOL
        assert err <= bound, f"{k}: {err:.3e} > {bound:.3e}"


def _param_grads(module) -> dict:
    """Each parameter's gradient in the flax layout; a parameter the loss
    does not reach (the GGNN readout under a variant that reads no g)
    gets zeros, as jax.grad gives it."""
    return _flat(named_to_tree({
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in module.named_parameters()}))


def test_the_registry_holds_the_jax_variants():
    assert VARIANTS == sorted(jcoattn.COATTENTION_REGISTRY)
    assert len(VARIANTS) == 15


# ---------------------------------------------------------------------------
# each variant against the JAX module

B, N1, N2, H, D = 3, 5, 7, 8, 8


def _variant(name):
    if name == "lt":
        return tcoattn.LinearTransformFineCoattention(H, D, N1, N2)
    return tcoattn.build_coattention(name, H, D)


@pytest.mark.parametrize("masked", [True, False], ids=["masks", "none"])
@pytest.mark.parametrize("name", VARIANTS)
def test_variant_matches_jax(name, masked):
    rng = np.random.default_rng(VARIANTS.index(name))
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    atoms1, g1, atoms2, g2 = f32(B, N1, H), f32(B, D), f32(B, N2, H), f32(B, D)
    masks = [None, None]
    if masked:
        masks = [(np.arange(n)[None, :] < np.array(lens)[:, None]).astype(np.float32)
                 for n, lens in ((N1, [5, 3, 1]), (N2, [2, 7, 4]))]
    module = _variant(name)
    width = 3 * D if name == "bimpm" else D
    assert module.out_width == width
    r1, r2 = f32(B, width), f32(B, width)
    tree = init_module_params(module, seed=7)

    jmod = jcoattn.COATTENTION_REGISTRY[name](hidden_dim=H, out_dim=D)
    jin = [jnp.asarray(a) for a in (atoms1, g1, atoms2, g2)]
    jmasks = [None if m is None else jnp.asarray(m) for m in masks]
    flax_tree = jmod.init(jax.random.PRNGKey(0), *jin, *jmasks)["params"]
    assert _shapes(tree) == _shapes(flax_tree)

    def jloss(params, a1, x1, a2, x2):
        c1, c2 = jmod.apply({"params": params}, a1, x1, a2, x2, *jmasks)
        return jnp.sum(c1 * r1) + jnp.sum(c2 * r2), (c1, c2)

    (_, want), wgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(tree, *jin)

    from_jax_params(tree, module)
    tin = [torch.as_tensor(a).requires_grad_() for a in (atoms1, g1, atoms2, g2)]
    tmasks = [None if m is None else torch.as_tensor(m) for m in masks]
    got = module(*tin, *tmasks)
    ((got[0] * torch.as_tensor(r1)).sum()
     + (got[1] * torch.as_tensor(r2)).sum()).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)
    grads = _param_grads(module)
    names = ("atoms1", "g1", "atoms2", "g2")
    grads.update({n: None if t.grad is None else t.grad.numpy()
                  for n, t in zip(names, tin)})
    _assert_grads(grads, {**_flat(wgrads[0]), **dict(zip(names, wgrads[1:]))})


WIDE = {"concat_hidden": dict(method="ggnn", concat_hidden=True),
        "ggnn-dev": dict(method="ggnn-dev")}


@pytest.mark.parametrize("wide", WIDE)
@pytest.mark.parametrize("name", VARIANTS)
def test_variant_over_wide_molecule_embeddings_matches_jax(name, wide):
    """g is 2 * 6 = 12 wide under concat_hidden (L=2, D=6) and H = 8 under
    GGNN-dev's sum pool: the port's co-attention reads g at its width, as
    flax infers it.  ``alter`` and ``circ`` raise in the JAX package at
    such a width; the port refuses them with that error, quoted."""
    kw = dict(fp_hidden_dim=8, fp_out_dim=6, conv_layers=2, sim_method="ntn",
              net_hidden_dims=(4,), attn_model=name, **WIDE[wide])
    jb = jmake_batch(_dataset(4), list(range(4)))
    names = ("atoms1", "adj1", "atoms2", "adj2", "mask1", "mask2")
    jargs = [jnp.asarray(getattr(jb, n)) for n in names]
    targs = [torch.as_tensor(getattr(jb, n)) for n in names]
    jpred = jset_up_predictor(**kw)
    n_max = jb.atoms1.shape[1]
    if name in ("alter", "circ"):
        with pytest.raises(Exception) as jerr:
            jpred.init(jax.random.PRNGKey(0), *jargs)
        with pytest.raises(ValueError) as err:
            set_up_predictor(**kw)
        g, b = (12 if wide == "concat_hidden" else 8), len(jb.labels)
        if name == "alter":
            frag = ("expected to generate shape (14, 8), but the existing "
                    f"parameter it received has shape ({g + 8}, 8)")
            port = frag
        else:
            frag = (f"Incompatible shapes for broadcasting: ({b}, 1, {g}) "
                    f"and requested shape ({b}, {n_max}, 6)")
            port = frag.replace(f"({b}, 1,", "(B, 1,").replace(
                f"({b}, {n_max},", "(B, N,")
        assert frag in str(jerr.value) and port in str(err.value)
        assert loop.padded_model_problems(TrainConfig(
            **{k: v for k, v in kw.items() if k != "attn_model"},
            attn=name)) == [str(err.value)]
        return
    tree = init_params(dict(kw, coattn_n_max=n_max), seed=len(name),
                       padded=True)
    flax_tree = jpred.init(jax.random.PRNGKey(0), *jargs)["params"]
    assert _shapes(tree) == _shapes(flax_tree)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    want = np.asarray(jpred.apply({"params": params}, *jargs))
    w = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    want_grads = jax.grad(lambda p: jnp.sum(
        jpred.apply({"params": p}, *jargs) * w))(params)
    model = from_jax_params(tree, set_up_predictor(**kw, coattn_n_max=n_max))
    assert model.encoder.out_width == (12 if wide == "concat_hidden" else 8)
    got = model(*targs)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    (got * torch.as_tensor(w)).sum().backward()
    _assert_grads(_param_grads(model), _flat(want_grads))


def test_lt_refuses_tables_of_another_width():
    module = tcoattn.LinearTransformFineCoattention(H, D, N1, N2)
    init = init_module_params(module, seed=0)
    from_jax_params(init, module)
    x = torch.zeros
    with pytest.raises(ValueError, match="wide"):
        module(x(B, N1 + 1, H), x(B, D), x(B, N2, H), x(B, D))
    with pytest.raises(ValueError, match="n_max"):
        tcoattn.build_coattention("lt", H, D)


# ---------------------------------------------------------------------------
# the packed predictor against the JAX one

PRED_N_MAX = 32  # bounds every molecule of the sample's first pairs


def _pred_cfg(attn, sim, layers=3, hidden=16):
    return dict(fp_hidden_dim=hidden, fp_out_dim=hidden, conv_layers=layers,
                weight_tying=False, sim_method=sim, attn=attn,
                net_hidden_dims=(8,))


@pytest.fixture
def flags():
    """Set the port's kernel-path form flags for one test."""
    saved = (tfg.TWOPASS, tpacked.FUSED_READOUT)

    def set_flags(twopass, fused_readout):
        tfg.TWOPASS, tpacked.FUSED_READOUT = twopass, fused_readout

    yield set_flags
    tfg.TWOPASS, tpacked.FUSED_READOUT = saved


@pytest.mark.parametrize("twopass", [False, True], ids=["k1", "twopass"])
@pytest.mark.parametrize("attn,sim", [("para", "ntn"), ("nie", "hole"),
                                      ("bimpm", "mlp"), ("lt", "dist-mult")])
def test_predictor_logits_and_grads_match_jax(attn, sim, twopass, flags,
                                              monkeypatch):
    cfg = _pred_cfg(attn, sim)
    batch = jpacking.pack_pair_dataset_coo(_dataset(12), list(range(12)))
    wire = compact_coattn_arrays(batch, PRED_N_MAX)
    labels = np.asarray(batch.labels, np.float32)
    tree = init_params(dict(cfg, coattn_n_max=PRED_N_MAX), seed=len(attn))
    pred = jpacked.make_packed_predictor(**cfg, coo=True, compact=True)

    def jloss(params):
        logits = pred.apply({"params": params}, *(jnp.asarray(a) for a in wire))
        return jloop.sigmoid_cross_entropy(logits.reshape(labels.shape),
                                           jnp.asarray(labels)), logits

    (want_loss, want_logits), want = jax.value_and_grad(jloss, has_aux=True)(tree)

    # the readout flag on: co-attention takes the K1 form whatever it says
    flags(twopass, True)
    calls = {"mid": 0, "half": 0}
    for name in ("fused_ggnn_mid", "fused_ggnn_half_bwd"):
        real = getattr(tfg, name)

        def counting(*a, _real=real, _key=name.split("_")[2]):
            calls[_key] += 1
            return _real(*a)

        monkeypatch.setattr(tfg, name, counting)
    before = (tfg.FusedGGNNFunction.backward_calls,
              tfg.FusedGGNNReadoutFunction.backward_calls)
    model = from_jax_params(tree, tpacked.make_packed_predictor(
        **cfg, coattn_n_max=PRED_N_MAX))
    logits = model(*(torch.as_tensor(np.asarray(a)) for a in wire))
    loss = loop.sigmoid_cross_entropy(logits, torch.as_tensor(labels))
    loss.backward()
    assert (tfg.FusedGGNNFunction.backward_calls,
            tfg.FusedGGNNReadoutFunction.backward_calls) == (before[0] + 1,
                                                             before[1])
    assert calls == ({"mid": 1, "half": 2} if twopass else {"mid": 0, "half": 0})
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL,
                               atol=ATOL)
    _assert_grads(_param_grads(model), _flat(want))


@pytest.mark.parametrize("attn,sim", [(a, "ntn") for a in VARIANTS]
                         + [("para", h) for h in HEADS if h != "ntn"])
def test_param_tree_matches_the_jax_predictor_and_round_trips(attn, sim):
    cfg = dict(_pred_cfg(attn, sim, layers=2, hidden=8), class_num=2)
    batch = jpacking.pack_pair_dataset_coo(_dataset(4), list(range(4)))
    wire = [jnp.asarray(a) for a in compact_coattn_arrays(batch, PRED_N_MAX)]
    flax_tree = jpacked.make_packed_predictor(**cfg, coo=True, compact=True).init(
        jax.random.PRNGKey(0), *wire)["params"]
    kwargs = dict(cfg, coattn_n_max=PRED_N_MAX)
    tree = init_params(kwargs, seed=3)
    assert _shapes(tree) == _shapes(flax_tree)
    back = to_jax_params(from_jax_params(
        tree, tpacked.make_packed_predictor(**kwargs)))
    a, b = _flat(tree), _flat(back)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("leaf,path,std", [
    # lecun-normal: flax's fan-in, in_axis -2 times the receptive field
    ("W_0", ("coattention",), (16 * 16) ** -0.5),
    ("W", ("head", "bilinear"), (16 * 16) ** -0.5),
    # glorot-normal over (n_max, D); he-normal over (head=D, H)
    ("W1", ("coattention",), (2.0 / (PRED_N_MAX + 16)) ** 0.5),
    ("max_pooling_W", ("coattention",), (2.0 / 16) ** 0.5)])
def test_init_params_draws_each_leaf_from_its_flax_initializer(leaf, path, std):
    attn = {"W_0": "para", "W": "para", "W1": "lt", "max_pooling_W": "bimpm"}[leaf]
    tree = init_params(dict(_pred_cfg(attn, "ntn", hidden=16),
                            coattn_n_max=PRED_N_MAX), seed=0)
    node = tree
    for k in path:
        node = node[k]
    x = node[leaf]
    # a normal truncated at 2 sigma, scaled to the variance
    assert np.abs(x).max() <= 2 * std / 0.8796256610342398 + 1e-6
    assert abs(float(x.std()) - std) < 0.25 * std
    zeros = tree["coattention"].get("b_0", tree["head"]["bilinear"]["b"])
    assert not np.any(zeros)


# ---------------------------------------------------------------------------
# the host side


def _batch(n=10):
    return jpacking.pack_pair_dataset_coo(_dataset(n), list(range(n)))


def test_slot_table_and_injectivity_check_match_jax():
    batch = _batch()
    got = tpacking.molecule_slot_table(batch.mol_id, batch.num_mols, 24)
    want = jpacking.molecule_slot_table(batch.mol_id, batch.num_mols, 24)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for fn in (tpacking.molecule_slot_table, jpacking.molecule_slot_table):
        with pytest.raises(ValueError, match="n_max=4"):
            fn(batch.mol_id, batch.num_mols, 4)
    mask = np.ones((3, 2), np.float32)
    index = np.array([4, 5, 4], np.int32)
    for fn in (tpacking.check_side_index_injective,
               jpacking.check_side_index_injective):
        with pytest.raises(ValueError, match="injectivity"):
            fn(index, mask)
        mask_pad = mask.copy()
        mask_pad[2] = 0.0  # a repeat on a fully masked row is allowed
        fn(index, mask_pad)


def test_wire_arrays_and_row_maps_match_jax():
    batch = _batch()
    got = compact_coattn_arrays(batch, 32)
    want = jpacked.compact_coattn_arrays(batch, 32)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert np.asarray(g).dtype.itemsize == 4
        np.testing.assert_array_equal(g, w)
    for index in (batch.left_index, batch.right_index):
        np.testing.assert_array_equal(
            side_mol_row(torch.as_tensor(index), batch.num_mols).numpy(),
            np.asarray(jslot.side_mol_row(jnp.asarray(index), batch.num_mols)))


# ---------------------------------------------------------------------------
# training and serving


def _jax_cfg(**kw):
    base = dict(method="ggnn", sim_method="ntn", attn="para", conv_layers=2,
                fp_hidden_dim=16, fp_out_dim=16, weight_tying=False,
                compute_path="coo", learning_rate=1e-2, batch_size=12)
    return JaxTrainConfig(**{**base, **kw})


def test_train_step_matches_the_jax_coo_step():
    jcfg = _jax_cfg()
    batch = _batch(12)
    wire = compact_coattn_arrays(batch, PRED_N_MAX)
    labels = np.asarray(batch.labels, np.float32)
    kwargs = predict.model_kwargs_from_config(json.loads(jcfg.to_json()))
    tree = init_params(dict(kwargs, coattn_n_max=PRED_N_MAX), seed=5)

    tx, _ = jloop.build_optimizer(jcfg, 1)
    pred = jpacked.make_packed_predictor(**kwargs, coo=True, compact=True)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    step = jloop.make_packed_coo_train_step(pred, tx)
    want_params, _, want_loss, _ = step(
        params, tx.init(params), tuple(jnp.asarray(a) for a in wire),
        jnp.asarray(labels))

    model = from_jax_params(tree, tpacked.make_packed_predictor(
        **kwargs, coattn_n_max=PRED_N_MAX))
    opt, _ = loop.build_optimizer(TrainConfig(**json.loads(jcfg.to_json())),
                                  1, list(model.parameters()))
    loss = loop.train_step(model, opt, [torch.as_tensor(np.asarray(a))
                                        for a in wire],
                           torch.as_tensor(labels))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL,
                               atol=ATOL)
    got, want = _flat(to_jax_params(model)), _flat(want_params)
    assert sorted(got) == sorted(want)
    for k in want:
        # one Adam step moves each weight by about lr: hold the moves
        np.testing.assert_allclose(got[k] - _flat(tree)[k],
                                   want[k] - _flat(tree)[k],
                                   rtol=1e-3, atol=1e-6, err_msg=k)


def test_config_problems_take_coattention_on_coo_only():
    coo = TrainConfig(compute_path="coo", attn="para", sim_method="ntn")
    assert loop.config_problems(coo) == []
    assert loop.config_problems(PRESETS["ggnn_coattention"]) == []  # padded
    preset = TrainConfig(**{**json.loads(
        PRESETS["ggnn_coattention"].to_json()), "compute_path": "coo"})
    assert loop.config_problems(preset) == []
    fused = TrainConfig(compute_path="fused", attn="para")
    problems = loop.config_problems(fused)
    assert len(problems) == 1 and "attn" in problems[0]
    assert "co-attention (use compute_path='coo')" in problems[0]
    # the JAX package refuses the same configuration
    jax_fused = _jax_cfg(compute_path="fused")
    assert any("co-attention" in p for p in jloop.packed_config_problems(
        jax_fused, allow_attn=jax_fused.compute_path == "coo"))
    with pytest.raises(ValueError, match="attn"):
        loop.Trainer(fused, _dataset(4), device="cpu")
    # MPNN with co-attention trains on coo, through K5/K5b and K4/K4b
    mpnn = TrainConfig(compute_path="coo", attn="para", method="mpnn")
    assert loop.config_problems(mpnn) == []
    for bad in (dict(attn="coattn"), dict(sim_method="transe")):
        assert len(loop.config_problems(TrainConfig(compute_path="coo",
                                                    **bad))) == 1


@pytest.mark.parametrize("flags_", [["--attn", "para", "--compute-path", "fused"],
                                    ["--attn", "para", "--method", "mpnn",
                                     "--compute-path", "coo"]])
def test_train_cli_refuses_unported_coattention_before_any_work(tmp_path,
                                                                flags_):
    """Co-attention on ``fused`` is refused before any CSV is read, as in
    the JAX package; MPNN with co-attention on ``coo``, refused until the
    port had it, passes the checks and reads its CSV."""
    argv = ["--train", str(tmp_path / "missing.csv"), "--device", "cpu",
            "--out", str(tmp_path / "run"), *flags_]
    mpnn = "mpnn" in flags_
    with pytest.raises(FileNotFoundError if mpnn else ValueError,
                       match="missing.csv" if mpnn else "attn"):
        train_cli.main(argv)
    assert not (tmp_path / "run").exists()


def test_trainer_fits_the_atom_table_to_its_data():
    train_ds, val_ds = _dataset(16), _dataset(8)
    cfg = TrainConfig(**json.loads(_jax_cfg(attn="lt", conv_layers=1,
                                            fp_hidden_dim=8,
                                            fp_out_dim=8).to_json()))
    trainer = loop.Trainer(cfg, train_ds, val_ds, device="cpu")
    n_max = jpacking.max_atoms_lane_rounded([train_ds, val_ds])
    assert trainer.coattn_n_max == n_max
    assert trainer.model.table_width == n_max
    assert tpacked.fused_form(8, 8, "lt") == tpacked.fused_form(8, 8, "para") \
        != tpacked.fused_form(8, 8)


def test_evaluator_and_predict_cli_match_the_jax_evaluator(tmp_path):
    cfg = _jax_cfg(sim_method="symmlp", attn="nie")
    kwargs = predict.model_kwargs_from_config(json.loads(cfg.to_json()))
    tree = init_params(kwargs, seed=11)
    ds = _dataset(30)
    want = JaxEvaluator(cfg, tree, batch_size=12).evaluate(ds)
    model = from_jax_params(tree, tpacked.make_packed_predictor(**kwargs))
    got = PackedPairEvaluator(model, batch_size=12, device="cpu").evaluate(ds)
    for name in ("logits", "e1", "e2"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    (tmp_path / "config.json").write_text(cfg.to_json())
    save_params_npz(str(tmp_path / "params.npz"), tree)
    pd.read_csv(SAMPLE).head(30).to_csv(tmp_path / "in.csv", index=False)
    assert predict.main([
        "--input", str(tmp_path / "in.csv"), "--out", str(tmp_path / "out.csv"),
        "--config", str(tmp_path / "config.json"),
        "--params", str(tmp_path / "params.npz"),
        "--batch-size", "12", "--device", "cpu"]) == 0
    probs = pd.read_csv(tmp_path / "out.csv")["prob"].to_numpy()
    np.testing.assert_allclose(probs, 1.0 / (1.0 + np.exp(-want.logits)),
                               rtol=RTOL, atol=ATOL)


def test_lt_weights_of_another_table_width_are_refused_as_in_jax(tmp_path):
    ds = _dataset(6)
    width = tpacking.max_atoms_lane_rounded([ds])
    cfg = _jax_cfg(attn="lt")
    kwargs = predict.model_kwargs_from_config(json.loads(cfg.to_json()))
    tree = init_params(dict(kwargs, coattn_n_max=width + 8), seed=2)
    with pytest.raises(flax.errors.ScopeParamShapeError, match="W1"):
        JaxEvaluator(cfg, tree, batch_size=6).evaluate(ds)
    model = from_jax_params(tree, tpacked.make_packed_predictor(
        **kwargs, coattn_n_max=width + 8))
    with pytest.raises(ValueError, match=f"{width + 8} wide.*{width} wide"):
        PackedPairEvaluator(model, batch_size=6, device="cpu").evaluate(ds)
    # weights of the dataset's own width serve in both packages
    tree = init_params(dict(kwargs, coattn_n_max=width), seed=2)
    want = JaxEvaluator(cfg, tree, batch_size=6).evaluate(ds)
    (tmp_path / "config.json").write_text(cfg.to_json())
    save_params_npz(str(tmp_path / "params.npz"), tree)
    pd.read_csv(SAMPLE).head(6).to_csv(tmp_path / "in.csv", index=False)
    assert predict.main([
        "--input", str(tmp_path / "in.csv"), "--out", str(tmp_path / "out.csv"),
        "--config", str(tmp_path / "config.json"),
        "--params", str(tmp_path / "params.npz"), "--device", "cpu"]) == 0
    probs = pd.read_csv(tmp_path / "out.csv")["prob"].to_numpy()
    np.testing.assert_allclose(probs, 1.0 / (1.0 + np.exp(-want.logits)),
                               rtol=RTOL, atol=ATOL)


def _toy_csv(path, n=96):
    """Label 1 when both molecules hold an oxygen."""
    oxy = ["CCO", "CC(=O)O", "OCCO", "C=O", "COC"]
    nox = ["CC", "CCC", "c1ccccc1", "CCN"]
    rng = np.random.default_rng(7)
    rows = []
    for i in range(n):
        if rng.random() < 0.5:
            rows.append([i, i, rng.choice(oxy), rng.choice(oxy), 1])
        else:
            rows.append([i, i, rng.choice(nox),
                         rng.choice(oxy if rng.random() < 0.5 else nox), 0])
    pd.DataFrame(rows, columns=["drugbank_id_1", "drugbank_id_2", "smiles_1",
                                "smiles_2", "label"]).to_csv(path, index=False)


@pytest.mark.parametrize("flags_", [
    ["--attn", "para", "--sim-method", "ntn", "--fp-hidden-dim", "8",
     "--conv-layers", "2", "--epochs", "4", "--lr", "5e-3"],
    # the paper's preset at its full width (L=8, H=D=32)
    ["--preset", "ggnn_coattention", "--epochs", "2", "--lr", "2e-3"]],
    ids=["para-ntn", "preset"])
def test_train_cli_trains_coattention_and_its_params_serve(tmp_path, capsys,
                                                           flags_):
    data = tmp_path / "toy.csv"
    _toy_csv(data)
    out = tmp_path / "run"
    rc = train_cli.main(["--train", str(data), "--val", str(data), *flags_,
                         "--batch-size", "16", "--patience", "100",
                         "--compute-path", "coo", "--device", "cpu",
                         "--out", str(out)])
    assert rc == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    log = json.loads((out / "log.json").read_text())
    assert final == log[-1]
    losses = [e["main/loss"] for e in log]
    assert losses[-1] < losses[0] and np.all(np.isfinite(losses))
    assert np.isfinite(log[-1]["val/loss"]) and log[-1]["val/roc_auc"] > 0.8
    config = json.loads((out / "config.json").read_text())
    assert (config["attn"], config["sim_method"]) == ("para", "ntn")
    kwargs = predict.model_kwargs_from_config(config)
    model = from_jax_params(load_params_npz(str(out / "final" / "params.npz")),
                            tpacked.make_packed_predictor(**kwargs))
    res = PackedPairEvaluator(model, batch_size=16, device="cpu").evaluate(
        CSVPairParser().parse(str(data)).dataset)
    rc = predict.main(["--input", str(data), "--config", str(out / "config.json"),
                       "--params", str(out / "final" / "params.npz"),
                       "--out", str(tmp_path / "preds.csv"), "--device", "cpu"])
    assert rc == 0
    probs = pd.read_csv(tmp_path / "preds.csv")["prob"].to_numpy()
    np.testing.assert_allclose(probs, 1.0 / (1.0 + np.exp(-res.logits)),
                               rtol=1e-5, atol=1e-6)


def test_evaluation_under_twopass_runs_k1(flags, monkeypatch):
    """Under TWOPASS the port's K1 forward writes h_mid (K1m) only when an
    input needs a gradient: the evaluator's forwards, under no_grad, take
    K1 and a train step takes K1m.  (The JAX primal ``_fused_ggnn_fwd``
    launches its mid kernel in both; the per-atom states are the same.)"""
    flags(True, False)
    calls = {"mid": 0}
    real = tfg.fused_ggnn_mid

    def counting(*a):
        calls["mid"] += 1
        return real(*a)

    monkeypatch.setattr(tfg, "fused_ggnn_mid", counting)
    cfg = _pred_cfg("para", "ntn", layers=2, hidden=8)
    model = from_jax_params(init_params(cfg, seed=0),
                            tpacked.make_packed_predictor(**cfg))
    ds = _dataset(8)
    PackedPairEvaluator(model, batch_size=8, device="cpu").evaluate(ds)
    assert calls["mid"] == 0
    batch = _batch(8)
    model.train()
    model(*(torch.as_tensor(np.asarray(a))
            for a in compact_coattn_arrays(batch, PRED_N_MAX))).sum().backward()
    assert calls["mid"] == 1
