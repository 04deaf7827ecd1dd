"""Training on the kernel paths: losses, the optimizer chain, the train
step and the Trainer (port of gcnbmp_tpu/train/loop.py).

- losses        <- :43-126 (labels < 0 are ignored; the mean divides by
                   max(#valid, 1))
- ``build_optimizer`` <- :144-170, the optax chain in its order:
  clip_by_global_norm, add_decayed_weights (coupled L2 on the gradient),
  the Lasso term g + l1 sign(p), then Adam (b1 0.9, b2 0.999, eps 1e-8,
  eps_root 0) at lr = schedule(count) taken before the count increments.
- ``train_step``  <- ``make_packed_coo_train_step`` (:333-355); scan mode
  (``scan_steps`` S > 1) runs S of them back to back on one chunk, the
  semantics of ``make_packed_scan_train_step`` (:358-390); on the padded
  layout it is ``make_train_step`` (:210-248): the padded predictor with
  ``deterministic=False`` and a fresh dropout draw per step from the
  trainer's generator, GWM's supernode rows threaded through
- ``Trainer``     <- :686-1408 for GGNN on ``compute_path="fused"``,
  ``"coo"`` or ``"packed"`` (one kernel path, :799-858), MPNN on ``"coo"``
  or ``"packed"`` (the Set2Set table width fitted to the data, :817-827;
  K5 and K4), GGNN and MPNN with co-attention on ``"coo"`` (the atom
  table width fitted alike, :1089-1098), RelGCN, GIN, NFP and GGNN with
  a layer aggregator on ``"coo"`` or ``"packed"``, and GGNN-GWM on ``"coo"``
  (wire-compact, the supernode table on the wire, :731-737, :1087-1088)
  or ``"packed"`` (plain PyTorch ops for these: the JAX package has no
  kernel for them either), per step or in scan mode (the loop at
  :1185-1263, the guard at :739-745), the batches staged ahead by the
  prefetcher on every layout (``prefetch``, :1207-1247;
  ``data.prefetch``); resume (:786-790),
  ``profile_epoch`` (:1149-1157) and ``debug_checks`` (:1172-1173,
  :183-207); and every encoder on the padded layout (``"padded"``, the
  config's default: ``PairPredictor`` or ``GWMPairPredictor`` over
  ``data.dataset.batch_iterator`` batches ``pad_to`` atoms wide, the
  options only that layout has, :747-756, :1178-1183, :1292-1305; no
  kernel, in either package); ``multi_device`` (:859-1037, :1106-1135,
  :1187-1290) on ``coo`` and ``packed``: graph-sharded training over the
  process group's ranks (``parallel.edgeshard``), every rank running the
  same kernels on its shard.  ``packed`` trains the wire-compact COO predictor, the
  adjacency built on the card from the edges, where the JAX trainer
  ships each batch's dense (P, 4, T, T) adjacency from the host
  (``make_packed_train_step``, :251-286, :302-331): the same pairs in the
  same order, the same parameters and the same logits, without ~93 MB of
  host copy per 2048-pair batch.  The dense layout itself is ported
  (``packed_batch_iterator``, :288-299, over
  ``data.packing.pack_pair_dataset_batch``, and the dense predictors of
  ``make_packed_predictor(..., compact=False)``): ``train_step`` takes
  its batches as it takes any predictor's positional arguments.
- ``packed_config_problems`` <- :532-575, verbatim: which configurations
  the packed layouts take, and so which runs the evaluators score on them
  (``eval.evaluate._packed_eval_eligible``); ``config_problems`` says what
  the port trains, with its reasons; ``kernel_problems`` names the widths
  the card's kernels are not built for.

``compute_dtype="bfloat16"`` is accepted and computed in f32, for GGNN as
the JAX fused path computes it (``_fused_encoder_g_nodes`` ignores
compute_dtype; its bf16 adjacency of 0/1 values is exact) and for MPNN as
its fused kernels do, and for RelGCN and GIN, whose plain stacks run in
f32 too.  NFP ignores it, as the JAX trainer does (it passes
compute_dtype to ggnn, relgcn, gin and mpnn only, loop.py:845-851).  The
JAX **coo** path with bf16 rounds its XLA matmul operands to bf16, so
that pairing is where the port's numbers differ from JAX's; the parity
tests run f32.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gcnbmp_tpu_torch.data.prefetch import four_byte_parts, split_views
from gcnbmp_tpu_torch.models.packed import PORTED_METHODS, model_problems
from gcnbmp_tpu_torch.models.predictor import padded_kwargs_from_config
from gcnbmp_tpu_torch.train.config import TrainConfig
from gcnbmp_tpu_torch.train.schedules import (
    cyclical_schedule,
    exponential_shift_schedule,
)

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# losses


def sigmoid_ce_elements(logits, labels):
    """Element-wise sigmoid CE (optax's ``sigmoid_binary_cross_entropy``)
    and the validity mask (labels < 0 ignored)."""
    labels = labels.to(logits.dtype)
    per = (-labels * torch.nn.functional.logsigmoid(logits)
           - (1.0 - labels) * torch.nn.functional.logsigmoid(-logits))
    return per, (labels >= 0).to(per.dtype)


def _masked_mean(per, valid):
    return (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def sigmoid_cross_entropy(logits, labels):
    """Mean sigmoid CE over the valid elements."""
    return _masked_mean(*sigmoid_ce_elements(logits.reshape(labels.shape),
                                             labels))


def hinge_elements(logits, labels):
    """Element-wise binary hinge over +-1 targets and the validity mask."""
    labels = labels.to(logits.dtype)
    per = torch.clamp(1.0 - (2.0 * labels - 1.0) * logits, min=0.0)
    return per, (labels >= 0).to(logits.dtype)


def hinge_loss(logits, labels):
    return _masked_mean(*hinge_elements(logits.reshape(labels.shape), labels))


def focal_elements(gamma: float = 2.0, alpha: float = 0.25):
    """Element-wise sigmoid focal loss and the validity mask; ignored
    labels are clamped to [0, 1] before the math, as in the JAX package."""

    def fn(logits, labels):
        labels = labels.to(logits.dtype)
        valid = (labels >= 0).to(logits.dtype)
        y = torch.clamp(labels, 0.0, 1.0)
        p = torch.sigmoid(logits)
        ce, _ = sigmoid_ce_elements(logits, y)
        p_t = p * y + (1.0 - p) * (1.0 - y)
        alpha_t = alpha * y + (1.0 - alpha) * (1.0 - y)
        return alpha_t * (1.0 - p_t) ** gamma * ce, valid

    return fn


def sigmoid_focal_loss(logits, labels, gamma: float = 2.0,
                       alpha: float = 0.25):
    return _masked_mean(*focal_elements(gamma, alpha)(
        logits.reshape(labels.shape), labels))


def _loss_kwargs(config) -> dict:
    """The focal loss's parameters from a config; no other loss has any."""
    if config.loss == "focal":
        return {"gamma": config.focal_gamma, "alpha": config.focal_alpha}
    return {}


def make_loss(name: str, **kwargs) -> Callable:
    if name in ("sigmoid_ce", "sigmoid_cross_entropy"):
        return sigmoid_cross_entropy
    if name == "hinge":
        return hinge_loss
    if name == "focal":
        return functools.partial(sigmoid_focal_loss, **kwargs)
    raise ValueError(f"unknown loss {name!r}")


# ---------------------------------------------------------------------------
# optimizer


class ChainedAdam:
    """The JAX package's optax chain, written out for a list of tensors:
    global-norm clip (``g * max_norm / norm`` when norm >= max_norm, as
    optax and unlike ``clip_grad_norm_``), coupled weight decay
    ``g + wd p``, Lasso ``g + l1 sign(p)``, then Adam with lr =
    ``schedule(count)`` before the count increments.  Updates the
    parameters in place; the moments are f32 tensors beside them."""

    # optax.adam's defaults, which the JAX trainer uses (eps_root = 0)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable,
                 grad_clip: float = 0.0, weight_decay: float = 0.0,
                 lasso: float = 0.0):
        self.params = list(params)
        self.schedule = schedule
        self.grad_clip, self.weight_decay, self.lasso = grad_clip, weight_decay, lasso
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _bias_correction(self, decay: float, count: int) -> float:
        # 1 - decay**count in f32, as optax computes it
        return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[torch.Tensor]] = None) -> None:
        """One update from ``grads`` (default: each parameter's ``.grad``;
        a missing gradient counts as zero)."""
        params = self.params
        if grads is None:
            grads = [p.grad for p in params]
        g = [torch.zeros_like(p) if x is None else x
             for x, p in zip(grads, params)]
        if self.grad_clip > 0:
            norm = torch.sqrt(torch.stack(
                [s.sum() for s in torch._foreach_mul(g, g)]).sum())
            keep = norm < self.grad_clip
            g = [torch.where(keep, x, (x / norm) * self.grad_clip) for x in g]
        if self.weight_decay > 0:
            g = torch._foreach_add(g, torch._foreach_mul(params,
                                                         self.weight_decay))
        if self.lasso > 0:
            signs = torch._foreach_mul([torch.sign(p) for p in params],
                                       self.lasso)
            g = torch._foreach_add(g, signs)
        lr = self.schedule(self.count)
        self.count += 1
        # mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - self.b2))
        mu_hat = torch._foreach_div(self.mu, self._bias_correction(self.b1, self.count))
        nu_hat = torch._foreach_div(self.nu, self._bias_correction(self.b2, self.count))
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.eps)
        update = torch._foreach_div(mu_hat, nu_hat)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(params, update)


def build_optimizer(config: TrainConfig, steps_per_epoch: int,
                    params: Sequence[torch.Tensor]
                    ) -> Tuple[ChainedAdam, Callable[[int], float]]:
    if config.clr:
        schedule = cyclical_schedule(
            config.learning_rate, config.clr_max_lr, config.clr_step_size,
            mode=config.clr, gamma=config.clr_gamma)
    else:
        schedule = exponential_shift_schedule(
            config.learning_rate, config.lr_shift_epochs(), steps_per_epoch,
            rate=config.lr_decay_rate)
    opt = ChainedAdam(params, schedule, grad_clip=config.grad_clip,
                      weight_decay=config.weight_decay, lasso=config.lasso)
    return opt, schedule


# ---------------------------------------------------------------------------
# the step


def train_step(model, optimizer: ChainedAdam, args, labels,
               loss_fn: Callable = sigmoid_cross_entropy,
               class_num: int = 1, **model_kwargs) -> torch.Tensor:
    """One step over a wire-compact batch: loss, backward (for GGNN K2b,
    K1b or K3 twice, by ``models.packed.FUSED_READOUT`` and
    ``ops.fused_ggnn.TWOPASS``; K4b and K5b for MPNN; on the card),
    optimizer update; or over a dense batch, ``args`` the dense
    predictor's arguments (``models.packed.dense_batch_args``; GWM's
    supernode table after ``adj``; the same kernels as the compact
    batch's; the JAX ``make_packed_train_step`` and
    ``make_packed_gwm_train_step``); or over a padded batch, ``args``
    the predictor's positional arguments and ``model_kwargs`` its
    supernode rows,
    ``deterministic=False`` and the dropout ``generator``.  Under
    multi-device training ``optimizer`` is a ``parallel.edgeshard.
    SummedGradients``, which steps on the gradients summed over the ranks.
    Returns the loss as a device tensor; the caller fetches losses once
    per epoch."""
    for p in optimizer.params:
        p.grad = None
    logits = model(*args, **model_kwargs)
    if class_num == 1:
        logits = logits.reshape(labels.shape)
    loss = loss_fn(logits, labels)
    loss.backward()
    optimizer.step()
    return loss.detach()


def packed_batch_iterator(ds, batch_size: int, num_tiles: int,
                          rng: np.random.Generator, supernode_fn=None):
    """Shuffled dense packed batches (``data.packing.PackedGraphBatch``)
    with a fixed tile count (:288-299): the pairs of the JAX iterator in
    its order for the same generator; the tail batch is dropped."""
    from gcnbmp_tpu_torch.data.packing import pack_pair_dataset_batch

    order = np.arange(len(ds))
    rng.shuffle(order)
    for start in range(0, len(ds) - batch_size + 1, batch_size):
        idx = order[start:start + batch_size].tolist()
        yield pack_pair_dataset_batch(ds, idx, num_tiles=num_tiles,
                                      supernode_fn=supernode_fn)


# ---------------------------------------------------------------------------
# what the port trains

LAYOUTS = ("padded", "fused", "coo", "packed")


def packed_config_problems(cfg, allow_attn: bool = False) -> List[str]:
    """The JAX package's ``packed_config_problems`` (loop.py:532-575),
    case for case: what the packed layouts (``packed``, ``coo``,
    ``fused``) refuse.  ``cfg`` is a ``TrainConfig`` or a config dict."""
    if not dataclasses.is_dataclass(cfg):
        cfg = TrainConfig.from_dict(cfg)
    problems = []
    if cfg.method == "ggnn-gwm":
        if cfg.compute_path not in ("packed", "coo"):
            problems.append("ggnn-gwm rides compute_path 'packed' or 'coo'")
        if cfg.multi_device and cfg.compute_path != "coo":
            problems.append("ggnn-gwm multi_device rides compute_path='coo' "
                            "(owner-masked edgeshard)")
        if cfg.scan_steps > 1 and cfg.compute_path != "coo":
            problems.append("ggnn-gwm scan mode requires compute_path='coo'")
    elif cfg.method not in PORTED_METHODS:
        problems.append(f"method={cfg.method!r} (only "
                        f"{'/'.join(PORTED_METHODS)}/ggnn-gwm)")
    if cfg.compute_path == "fused" and cfg.method != "ggnn":
        problems.append("fused Pallas kernel is GGNN-only")
    if cfg.attn is not None and not allow_attn:
        problems.append("co-attention (use compute_path='coo')")
    if not cfg.siamese:
        problems.append("siamese=False")
    if cfg.symmetric is not None:
        problems.append("symmetric")
    if cfg.fp_dropout_rate > 0:
        problems.append("dropout")
    if cfg.fp_batch_normalization:
        problems.append("batch normalization")
    if cfg.concat_hidden:
        problems.append("concat_hidden")
    if cfg.layer_aggregator and cfg.method != "ggnn":
        problems.append("layer_aggregator (packed GGNN only)")
    if cfg.layer_aggregator and cfg.compute_path == "fused":
        problems.append("layer_aggregator (not in the fused kernel)")
    return problems


def padded_model_problems(cfg: TrainConfig) -> List[str]:
    """What the padded factory (``models.predictor.set_up_predictor``)
    does not build for ``cfg``, each with its reason: what the JAX
    factory refuses, a layer aggregator mode the JAX module raises on at
    its first call, and a co-attention variant that the JAX module cannot
    run over the encoder's molecule width (``g_width_problem``, the JAX
    error quoted)."""
    from gcnbmp_tpu_torch.models import ENCODERS
    from gcnbmp_tpu_torch.models.coattention import (
        COATTENTION_REGISTRY, g_width_problem)
    from gcnbmp_tpu_torch.models.heads import HEADS
    from gcnbmp_tpu_torch.models.ggnn_extras import MODES

    method = cfg.method
    bad = []
    known = method in ENCODERS
    if method != "ggnn-gwm" and not known:
        bad.append(f"method={method!r} (encoders: {sorted(ENCODERS)} and "
                   "'ggnn-gwm')")
    if cfg.sim_method not in HEADS:
        bad.append(f"sim_method={cfg.sim_method!r} (heads: {sorted(HEADS)})")
    aggregator_ok = not (cfg.layer_aggregator and method == "ggnn"
                         and cfg.layer_aggregator not in MODES)
    if not aggregator_ok:
        bad.append(f"layer_aggregator={cfg.layer_aggregator!r} (modes: "
                   f"{', '.join(MODES)}; the reference's 'self-attn' is "
                   "unfinished)")
    # the JAX factory ignores attn for ggnn-gwm
    if cfg.attn is not None and method != "ggnn-gwm":
        if cfg.attn not in COATTENTION_REGISTRY:
            bad.append(f"attn={cfg.attn!r} (variants: "
                       f"{sorted(COATTENTION_REGISTRY)})")
        elif known and aggregator_ok:
            width = ENCODERS[method](
                cfg.fp_out_dim, cfg.fp_hidden_dim, cfg.conv_layers,
                cfg.concat_hidden, cfg.layer_aggregator, 0.0, False,
                cfg.weight_tying, device="meta").out_width
            problem = g_width_problem(cfg.attn, cfg.fp_hidden_dim,
                                      cfg.fp_out_dim, width)
            if problem:
                bad.append(problem)
    return bad


def multi_device_problems(cfg: TrainConfig) -> List[str]:
    """The JAX trainer's refusals of ``multi_device`` (gcnbmp_tpu/train/
    loop.py:800-802, :859-862, :1012-1017), its text: graph-sharded
    training rides ``coo`` (every option) or ``packed`` (binary sigmoid
    cross-entropy, no scan mode)."""
    if not cfg.multi_device:
        return []
    if cfg.compute_path not in ("packed", "coo"):
        return ["multi_device requires compute_path 'packed' or 'coo'"]
    problems = []
    if cfg.compute_path == "packed":
        if cfg.scan_steps > 1:
            problems.append("multi_device scan mode rides compute_path='coo'")
        if cfg.class_num != 1 or cfg.loss != "sigmoid_ce":
            problems.append("multi_device supports binary sigmoid-CE only")
    return problems


def config_problems(cfg: TrainConfig) -> List[str]:
    """Options of ``cfg`` the port does not train, each with its reason:
    the ROADMAP item that brings it, or the JAX package's own refusal
    (``packed_config_problems``, gcnbmp_tpu/train/loop.py:532-575, on the
    packed layouts; ``multi_device_problems``).  The padded layout takes
    every option the JAX trainer takes there but batch normalization,
    which the JAX trainer cannot step (``models.ggnn.BN_REFUSAL``), and
    multi-device training, which the JAX trainer refuses there too."""
    from gcnbmp_tpu_torch.models.ggnn import BN_REFUSAL

    problems = []
    path, method = cfg.compute_path, cfg.method
    if cfg.fp_batch_normalization:
        problems.append(f"fp_batch_normalization=True: {BN_REFUSAL}")
    problems += [f"multi_device=True on compute_path={path!r}: {p}, as in "
                 "the JAX package" for p in multi_device_problems(cfg)]
    if path not in LAYOUTS:
        problems.append(f"compute_path={path!r}: the layouts are "
                        f"{', '.join(map(repr, LAYOUTS))}")
        return problems
    if path == "padded":
        return problems + padded_model_problems(cfg)
    problems += model_problems(cfg.method, cfg.sim_method, cfg.attn,
                               cfg.layer_aggregator)
    by_field = {}
    for entry in packed_config_problems(cfg, allow_attn=path == "coo"):
        field, hint = (("method", None) if entry.startswith("method=")
                       else _PACKED_REFUSALS[entry])
        if hint is not None:
            by_field.setdefault(field, []).append(
                f"{entry}, as in the JAX package"
                + hint.format(method=method))
    for field, reasons in by_field.items():
        problems.append(f"{field}={getattr(cfg, field)!r} on "
                        f"compute_path={path!r}: {'; '.join(reasons)}")
    return problems


# each refusal of ``packed_config_problems``: the TrainConfig field it
# names and what the port adds to the JAX reason; a hint of None where
# another check of ``config_problems`` names it already (batch
# normalization on every layout, ``model_problems`` the method and the
# layer aggregator's encoder)
_TO_PADDED = "; use compute_path='padded'"
_PACKED_REFUSALS = {
    "ggnn-gwm rides compute_path 'packed' or 'coo'": ("method", ""),
    "ggnn-gwm multi_device rides compute_path='coo' (owner-masked "
    "edgeshard)": ("multi_device", ""),
    "ggnn-gwm scan mode requires compute_path='coo'": ("scan_steps", ""),
    "fused Pallas kernel is GGNN-only":
        ("method", "; {method} trains on 'coo', 'packed' or 'padded'"),
    "co-attention (use compute_path='coo')": ("attn", ""),
    "siamese=False": ("siamese", _TO_PADDED),
    "symmetric": ("symmetric", _TO_PADDED),
    "dropout": ("fp_dropout_rate", _TO_PADDED),
    "batch normalization": ("fp_batch_normalization", None),
    "concat_hidden": ("concat_hidden", _TO_PADDED),
    "layer_aggregator (packed GGNN only)": ("layer_aggregator", None),
    "layer_aggregator (not in the fused kernel)": (
        "layer_aggregator",
        ": the fused kernels keep no per-layer states (use "
        "compute_path='coo'; a layer-range kernel forward is ROADMAP "
        'queue 2, "Open: JKNet")'),
}


def kernel_problems(cfg, device) -> List[str]:
    """Widths of ``cfg`` (a ``TrainConfig`` or a run config dict) that the
    card's kernels are not built for, when ``device`` is CUDA; none on the
    CPU, where the wrappers run their plain versions at any width.  The
    train, predict and evaluate CLIs ask alike: every width built has its
    forward and its reverse kernels.  A GGNN whose readout width differs
    from its hidden width runs K1 with the plain readout
    (``models.packed.fused_form``), so only H is checked.  RelGCN, GIN,
    NFP, GGNN with a layer aggregator, GGNN-GWM and every model on the
    padded layout run no kernel, so none of their widths is refused."""
    from gcnbmp_tpu_torch.models.packed import SET2SET_STEPS
    from gcnbmp_tpu_torch.ops import fused_ggnn, fused_mpnn, set2set_kernel

    if torch.device(device).type != "cuda":
        return []
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    if cfg.get("compute_path", TrainConfig.compute_path) == "padded":
        return []
    method = cfg.get("method", "ggnn")
    hidden = int(cfg.get("fp_hidden_dim", TrainConfig.fp_hidden_dim))
    item = 'ROADMAP queue 2, "Open: hidden widths"'
    # MPNN runs K5 and K4 (Set2Set over H channels)
    held = {"ggnn": fused_ggnn.KERNEL_HIDDEN,
            "mpnn": [h for h in fused_mpnn.KERNEL_HIDDEN
                     if h in set2set_kernel.KERNEL_HIDDEN]}.get(method, [])
    if cfg.get("layer_aggregator"):
        held = []
    problems = []
    if held and hidden not in held:
        problems.append(
            f"fp_hidden_dim={hidden} with method={method!r}: the card's "
            f"kernels are built for {list(held)}; other widths are {item}")
    if method == "mpnn" and SET2SET_STEPS > set2set_kernel.KERNEL_MAX_STEPS:
        problems.append(f"{SET2SET_STEPS} Set2Set steps: the card's kernel "
                        f"takes at most {set2set_kernel.KERNEL_MAX_STEPS}; "
                        f"more are {item}")
    return problems


def chunk_parts(stacked, labels) -> List[np.ndarray]:
    """The arrays of a chunk as ``stage_chunk`` lays them out: the stacked
    wire arrays (all 4-byte types: the int32 wire arrays, GWM's f32
    supernode table), then the labels as f32."""
    return four_byte_parts([*stacked, np.asarray(labels, np.float32)])


def stage_chunk(stacked, labels, device):
    """Copy a chunk of S stacked wire batches and their labels to
    ``device`` in one transfer: the arrays of ``chunk_parts`` laid side by
    side in one int32 buffer, each f32 array by its bits (``view``, no
    conversion).
    Returns (the wire arrays, the labels) as views of the copy, each with
    its leading (S,) axis."""
    parts = chunk_parts(stacked, labels)
    flat = torch.from_numpy(np.concatenate(
        [p.view(np.int32).reshape(-1) for p in parts])).to(device)
    views = split_views(flat, parts)
    return views[:-1], views[-1]


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: ChainedAdam
    step: int
    epoch: int
    best_val_loss: float
    epochs_since_best: int


class Trainer:
    """Binary / multi-label DDI trainer over the kernel paths.

    Usage::

        t = Trainer(config, train_ds, val_ds, device="cuda")
        result = t.fit()

    Initial weights come from ``convert.init_params(cfg, seed)``: seeded
    numpy draws from the flax initializers' distributions, so their
    values differ from a JAX run's (jax.random) with the same seed.
    ``compute_path="packed"`` trains the same wire-compact COO predictor
    as ``"coo"``; a GWM model's batches carry the supernode table of its
    ``supernode_fn`` (``models.gwm.default_supernode_fn``).
    Each step runs the GGNN kernel path in the form
    ``models.packed.fused_form`` names (K2 and K2b by default; K1 and K1b,
    or K1m and K3 twice, with co-attention) or K5, K4, K4b and K5b (MPNN)
    on the card.  A co-attention model's batches carry each pair side's
    atom slot table, ``coattn_n_max`` wide (the run's largest molecule,
    rounded up to 8), and its evaluations use the same width.  Batches
    reach the device in chunks
    of ``max(scan_steps, 1)``, one host-to-device copy per chunk
    (``stage_chunk``), and the chunk's steps run back to back on slices of
    it: the batches, order and updates of the JAX scan mode, whose tail
    chunk is dropped likewise.  With ``prefetch`` > 0 (the default, 2) a
    ``data.prefetch.PrefetchIterator`` packs, encodes and stages the
    chunks (padded: builds the batches) that many ahead on threads of its
    own, ``prefetch_workers`` transfers at once (padded: one), through a
    pinned ring and a side stream on the card (loop.py:1207-1247): the
    same batches in the same order, the same device layout, so the same
    losses as ``prefetch=0``, which stages on the step's thread.
    ``compute_path="padded"`` (the default) trains the padded predictor
    of ``models.predictor.set_up_predictor`` on ``data.dataset`` batches
    ``pad_to`` atoms wide, one step per batch, dropout drawn from
    ``dropout_gen`` (seeded ``seed + 1``); no kernel runs there.  Epoch ends evaluate train and val through
    ``PackedPairEvaluator`` (``PairEvaluator`` on the padded layout), stop
    early on val loss, and save
    ``snapshot_epoch_*``, ``best`` and ``final`` checkpoints
    (``train.checkpoints``).

    ``multi_device``: one process per rank of a ``torch.distributed``
    group (one is set up for a lone process), ``device`` the rank's card;
    each rank packs the same batches, keeps its tiles and pairs of each
    (co-attention packed pair-local), runs the step's kernels on them and
    takes the same optimizer step on the gradients summed over the ranks,
    so the replicas stay equal; rank 0 alone evaluates and writes the run
    directory."""

    def __init__(self, config: TrainConfig, train_ds, val_ds=None,
                 device="cuda"):
        problems = config_problems(config) + kernel_problems(config, device)
        if problems:
            raise ValueError("configuration outside the ported training "
                             "path: " + "; ".join(problems))
        self.config = config
        self.device = torch.device(device)
        self.rank, self.world, self.mesh = 0, 1, None
        if config.multi_device:
            from gcnbmp_tpu_torch.parallel.mesh import (
                graph_mesh, init_distributed, rank_device)

            self.rank, self.world = init_distributed(self.device)
            self.device = rank_device(self.device)
            self.mesh = graph_mesh(self.device.type)
            if config.scan_steps > 1 and config.batch_size % self.world:
                raise ValueError(
                    "multi_device scan mode requires batch_size divisible "
                    f"by the device count ({self.world})")
        rng = np.random.default_rng(config.seed)
        if config.augment:
            train_ds = train_ds.augment_swap()
        if config.balance:
            train_ds = train_ds.rebalance(rng)
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.np_rng = rng
        dss = [train_ds] + ([val_ds] if val_ds is not None
                            and len(val_ds) else [])
        self.padded = config.compute_path == "padded"
        self.coattn_n_max = None
        if self.padded:
            self.model = self._padded_model(config, dss)
        else:
            self.model = self._packed_model(config, dss)
        self.supernode_fn = getattr(self.model, "supernode_fn", None)
        # the JAX trainer's dropout key is PRNGKey(seed + 1), split per
        # step (loop.py:1141, :1314)
        self.dropout_gen = torch.Generator(device=self.device)
        self.dropout_gen.manual_seed(config.seed + 1)
        self.steps_per_epoch = max(1, len(self.train_ds) // config.batch_size)
        if config.scan_steps > 1 and config.scan_steps > self.steps_per_epoch:
            raise ValueError(
                f"scan_steps={config.scan_steps} exceeds the "
                f"{self.steps_per_epoch} batches per epoch (dataset "
                f"{len(self.train_ds)} pairs / batch_size "
                f"{config.batch_size}): every epoch would train zero steps; "
                "lower scan_steps or batch_size")
        self.optimizer, self.schedule = build_optimizer(
            config, self.steps_per_epoch, list(self.model.parameters()))
        self.loss_fn = make_loss(config.loss, **_loss_kwargs(config))
        self.log: List[Dict[str, Any]] = []
        # per epoch with the prefetcher: items, the producer's, the
        # transfers' and the step thread's waiting seconds
        self.prefetch_log: List[Dict[str, Any]] = []
        self._ring = None  # the prefetcher's pinned ring, on the card

    def _packed_model(self, config, dss):
        """The wire-compact predictor, with the Set2Set (MPNN) and
        co-attention atom table widths of the largest molecule of the
        run's datasets, rounded up to 8 (loop.py:817-827, :1089-1098)."""
        from gcnbmp_tpu_torch.convert import from_jax_params, init_params
        from gcnbmp_tpu_torch.data.packing import max_atoms_lane_rounded
        from gcnbmp_tpu_torch.models.packed import (
            make_packed_predictor, model_kwargs_from_config)

        kwargs = model_kwargs_from_config(dataclasses.asdict(config))
        if config.method == "mpnn":
            kwargs["s2s_n_max"] = max_atoms_lane_rounded(dss)
        if config.attn is not None:
            self.coattn_n_max = kwargs["coattn_n_max"] = \
                max_atoms_lane_rounded(dss)
        return from_jax_params(init_params(kwargs, config.seed),
                               make_packed_predictor(**kwargs)).to(self.device)

    def _padded_model(self, config, dss):
        """The padded predictor of ``set_up_predictor``; the run's pad
        size ``pad_to`` is ``max_pad``, or the bucket of the largest
        molecule of the run's datasets (loop.py:747-756), which also sizes
        the ``lt`` co-attention's weights."""
        from gcnbmp_tpu_torch.convert import from_jax_params, init_params
        from gcnbmp_tpu_torch.data.dataset import bucket_size
        from gcnbmp_tpu_torch.models.predictor import set_up_predictor

        self.pad_to = config.max_pad or bucket_size(
            max(ds.max_atoms() for ds in dss))
        kwargs = padded_kwargs_from_config(dataclasses.asdict(config))
        if config.attn == "lt":
            kwargs["coattn_n_max"] = self.pad_to
        return from_jax_params(init_params(kwargs, config.seed, padded=True),
                               set_up_predictor(**kwargs)).to(self.device)

    def _eval(self, ds):
        from gcnbmp_tpu_torch.eval.evaluate import (
            PackedPairEvaluator, PairEvaluator)

        if self.padded:
            # the JAX trainer's collect_logits at the run's pad size
            evaluator = PairEvaluator(
                self.model, batch_size=self.config.batch_size,
                pad_to=self.pad_to, class_num=self.config.class_num,
                device=self.device)
        else:
            evaluator = PackedPairEvaluator(
                self.model, batch_size=self.config.batch_size,
                class_num=self.config.class_num, device=self.device,
                n_max=self.coattn_n_max)
        res = evaluator.evaluate(ds)
        self.model.train()
        return res

    def _stage(self, item):
        """One host item on the device, on the calling thread: a padded
        batch's (args, supernode kwargs, labels, edges) through
        ``padded_args``, or a chunk's (wire arrays, labels, edges) through
        ``stage_chunk``, one pageable copy each."""
        from gcnbmp_tpu_torch.data.dataset import padded_args

        if self.padded:
            return (*padded_args(item, self.device,
                                 self.supernode_fn is not None),
                    item.num_edges)
        stacked, labels, edges = item
        return (*stage_chunk(stacked, labels, self.device), edges)

    def _prefetch_workers(self) -> int:
        """The prefetcher's transfer threads: ``prefetch_workers`` on the
        packed layouts, one on the padded layout (loop.py:1246)."""
        return 1 if self.padded else self.config.prefetch_workers

    def _padded_epoch(self, epoch: int, state, epoch_losses: list) -> int:
        """One epoch on the padded layout: shuffled batches ``pad_to``
        atoms wide, the tail dropped (loop.py:1178-1183), one step each
        with a fresh dropout draw; scan_steps groups nothing here, as in
        the JAX trainer.  Returns the epoch's directed edges."""
        from gcnbmp_tpu_torch.data.dataset import batch_iterator

        return self._epoch(epoch, state, epoch_losses, batch_iterator(
            self.train_ds, self.config.batch_size, shuffle=True,
            rng=self.np_rng, pad_to=self.pad_to, drop_remainder=True,
            supernode_fn=self.supernode_fn))

    def _epoch(self, epoch: int, state, epoch_losses: list, batches,
               packed_step=None) -> int:
        """The steps of one epoch over ``batches``, the host items (padded
        batches, or chunks of ``max(scan_steps, 1)`` wire batches, whose
        steps run ``packed_step``: the forward, the optimizer and the
        loss), each staged on the step's thread (``prefetch=0``) or ahead
        of it by the prefetcher, which is stopped and joined before this
        returns or raises.  Appends each step's loss to ``epoch_losses``;
        returns the epoch's directed edges."""
        from gcnbmp_tpu_torch.data.prefetch import PinnedRing, PrefetchIterator

        cfg = self.config
        prefetcher = None
        if cfg.prefetch > 0:
            workers = self._prefetch_workers()
            if self._ring is None and self.device.type == "cuda":
                # allocated once; its slots grow to the run's item size
                self._ring = PinnedRing(self.device,
                                        cfg.prefetch + workers + 1)
            batches = prefetcher = PrefetchIterator(
                batches, depth=cfg.prefetch,
                transfer=self._transfer(self._ring), workers=workers,
                device=self.device)
        steps_per_chunk = max(cfg.scan_steps, 1)
        edges = 0
        try:
            for item in batches:
                staged = (item.get() if prefetcher is not None
                          else self._stage(item))
                edges += staged[-1]
                if self.padded:
                    args, kwargs, labels, _ = staged
                    epoch_losses.append(train_step(
                        self.model, self.optimizer, args, labels,
                        self.loss_fn, cfg.class_num, deterministic=False,
                        generator=self.dropout_gen, **kwargs))
                    if cfg.debug_checks:
                        self._check_finite(epoch, state.step)
                    state.step += 1
                    continue
                forward, optimizer, step_loss = packed_step
                args, labels, _ = staged
                for i in range(steps_per_chunk):
                    epoch_losses.append(train_step(
                        forward, optimizer, [a[i] for a in args], labels[i],
                        step_loss, cfg.class_num))
                    if cfg.debug_checks:
                        self._check_finite(epoch, state.step + i)
                state.step += steps_per_chunk
        finally:
            if prefetcher is not None:
                prefetcher.close()
        if prefetcher is not None:
            self.prefetch_log.append(dict(
                epoch=epoch + 1, items=prefetcher.count,
                produce_s=prefetcher.produce_s,
                transfer_s=prefetcher.transfer_s, wait_s=prefetcher.wait_s))
        return edges

    def _transfer(self, ring):
        """The prefetcher's transfer: ``_stage``'s result, with the same
        device layout (one buffer per chunk, one tensor per padded array),
        copied from ``ring``'s pinned slots on its side stream (on the
        CPU, ``_stage`` itself)."""
        from gcnbmp_tpu_torch.data.dataset import (
            padded_arrays, padded_tensors)
        from gcnbmp_tpu_torch.data.prefetch import Staged

        if ring is None:
            return lambda item: Staged(self._stage(item))
        supers = self.supernode_fn is not None

        def transfer(item):
            if self.padded:
                parts = four_byte_parts(padded_arrays(item, supers))
                tensors, event = ring.copy(parts, one_buffer=False)
                value = (*padded_tensors(tensors, supers), item.num_edges)
            else:
                stacked, labels, edges = item
                tensors, event = ring.copy(chunk_parts(stacked, labels))
                value = (tensors[:-1], tensors[-1], edges)
            return Staged(value, event, ring.consumer)

        return transfer

    def _start_profile(self, epoch: int):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        logger.info("profiling epoch %d", epoch)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler, epoch: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        out = os.path.join(self.config.out_dir, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"epoch_{epoch}.trace.json")
        profiler.export_chrome_trace(path)
        logger.info("epoch %d trace: %s", epoch, path)

    def _check_finite(self, epoch: int, step: int) -> None:
        """Raise FloatingPointError naming the first parameter whose
        gradient or updated value holds a NaN or an infinity (one device
        sync)."""
        checks = []
        for name, p in self.model.named_parameters():
            if p.grad is not None:
                checks.append((f"the gradient of {name}", p.grad))
            checks.append((name, p))
        ok = torch.stack([torch.isfinite(t).all() for _, t in checks]).cpu()
        if not bool(ok.all()):
            what = checks[int(torch.argmin(ok.to(torch.int8)))][0]
            raise FloatingPointError(f"non-finite values in {what} at "
                                     f"epoch {epoch} step {step}")

    def _multi_device_batches(self, datasets):
        """(the batch iterator's arguments to change, the RankBatch maker) of
        graph-sharded
        training (gcnbmp_tpu/train/loop.py:863-1037, :1060-1079): each
        rank packs the same global batches (the same generator), pads and
        partitions them, and keeps its block as its wire.  Co-attention
        packs pair-local (both molecules of each pair on one rank; the
        parts' capacities are the worst ``batch_size / world``-pair
        batch's); the other forms pad each shard's edges to the global
        capacity rounded to 128, which no batch can exceed."""
        from gcnbmp_tpu_torch.data import estimate_coo_capacities
        from gcnbmp_tpu_torch.data.packing import PairLocalMeta
        from gcnbmp_tpu_torch.parallel import edgeshard

        cfg, n = self.config, self.world
        cap = ((self.edge_capacity + 127) // 128) * 128
        if cfg.attn is not None:
            ppp = -(-cfg.batch_size // n)
            tpp, ecpp = estimate_coo_capacities(datasets, ppp)
            meta = PairLocalMeta(n_parts=n, tiles_per_part=tpp,
                                 pairs_per_part=ppp,
                                 edge_capacity_per_part=((ecpp + 127)
                                                         // 128) * 128)
            iterator = dict(num_tiles=tpp, edge_capacity=
                            meta.edge_capacity_per_part, pairlocal_parts=n)
            partition = lambda b: edgeshard.pad_partition_coattn_pairlocal(
                b, meta, self.coattn_n_max)
        else:
            iterator = {}
            pad = (edgeshard.pad_partition_gwm if self.supernode_fn
                   else edgeshard.pad_partition_coo)
            partition = lambda b: pad(b, n, edge_capacity_per_shard=cap)

        def rank_batch(b):
            wire, labels = edgeshard.local_wire(partition(b), self.rank, n)
            return edgeshard.RankBatch(wire, labels, b.num_edges)

        return iterator, rank_batch

    def _shared(self, value: Optional[float]) -> Optional[float]:
        """Rank 0's ``value`` on every rank (multi-device training: only
        rank 0 evaluates, and every rank must take its early-stopping
        decision)."""
        if not self.config.multi_device:
            return value
        t = torch.tensor([np.nan if value is None else value],
                         dtype=torch.float64, device=self.device)
        torch.distributed.broadcast(t, src=0,
                                    group=self.mesh.get_group("graph"))
        return float(t.item())

    def fit(self, max_epochs: Optional[int] = None) -> Dict[str, Any]:
        """Train to ``max_epochs`` (default ``config.epochs``).  Under
        ``multi_device`` every rank trains its shard of each batch
        (``parallel.edgeshard``) with the same parameters and steps; rank
        0 alone evaluates, logs and writes the run directory, and
        broadcasts the validation loss so that every rank stops early at
        the same epoch."""
        from gcnbmp_tpu_torch.data import estimate_coo_capacities
        from gcnbmp_tpu_torch.data.wire import (
            packed_coo_batch_iterator, scan_chunk_iterator)
        from gcnbmp_tpu_torch.models.packed import fused_form
        from gcnbmp_tpu_torch.train.checkpoints import save_checkpoint

        cfg = self.config
        main = self.rank == 0
        state = TrainState(self.model, self.optimizer, 0, 0, float("inf"), 0)
        if cfg.resume:
            from gcnbmp_tpu_torch.train.checkpoints import restore_checkpoint

            restore_checkpoint(cfg.resume, state)
            logger.info("resumed from %s at epoch %d", cfg.resume, state.epoch)
        datasets = [self.train_ds]
        if self.val_ds is not None and len(self.val_ds):
            datasets.append(self.val_ds)
        iterator = {}
        if not self.padded:
            self.num_tiles, self.edge_capacity = estimate_coo_capacities(
                datasets, cfg.batch_size)
            iterator = dict(num_tiles=self.num_tiles,
                            edge_capacity=self.edge_capacity)
        pack_cache = [] if cfg.reuse_packs else None
        if cfg.prefetch > 0:
            logger.info("prefetch=%d: each %s staged ahead on a producer "
                        "thread, %d transfer thread(s)%s", cfg.prefetch,
                        "batch" if self.padded else "chunk",
                        self._prefetch_workers(),
                        ", a pinned ring and side-stream copies"
                        if self.device.type == "cuda" else "")
        if cfg.plot_reports:
            logger.info("plot_reports: the port writes no loss/accuracy PNGs "
                        "(ROADMAP queue 1, item 6); log.json holds the curves")
        if self.padded:
            logger.info("padded layout, %d atoms per molecule: no kernel "
                        "(PyTorch ops, as the JAX padded path runs XLA ops)",
                        self.pad_to)
        elif cfg.method == "ggnn":
            logger.info("GGNN kernel path: %s",
                        fused_form(cfg.fp_hidden_dim, cfg.fp_out_dim, cfg.attn,
                                   cfg.layer_aggregator))
        args_fn = (None if self.padded
                   else self.model.wire_encoder(n_max=self.coattn_n_max))
        forward, step_loss, optimizer = (self.model, self.loss_fn,
                                         self.optimizer)
        rank_batch = None
        if cfg.multi_device:
            from gcnbmp_tpu_torch.parallel import edgeshard

            changed, rank_batch = self._multi_device_batches(datasets)
            iterator.update(changed)
            forward = edgeshard.edgeshard_forward(
                self.model, self.mesh, pair_local=cfg.attn is not None)
            step_loss = edgeshard.global_mean_loss(
                self.mesh, elementwise_loss=edgeshard.elementwise_loss_for(
                    cfg.loss, **_loss_kwargs(cfg)))
            optimizer = edgeshard.SummedGradients(self.optimizer, self.mesh)
            args_fn = lambda rb: rb.wire
            logger.info("multi_device: graph-sharded training, rank %d of %d "
                        "on %s (scan_steps=%d, loss=%s, attn=%s%s, gwm=%s)",
                        self.rank, self.world, self.device, cfg.scan_steps,
                        cfg.loss, cfg.attn,
                        " pair-local" if cfg.attn else "",
                        self.supernode_fn is not None)
        steps_per_chunk = max(cfg.scan_steps, 1)
        if main:
            os.makedirs(cfg.out_dir, exist_ok=True)
        max_epochs = max_epochs or cfg.epochs
        self.model.train()
        t0 = time.time()
        for epoch in range(state.epoch, max_epochs):
            profiler = None
            if main and cfg.profile_epoch is not None \
                    and epoch == cfg.profile_epoch:
                profiler = self._start_profile(epoch)
            epoch_losses: List[torch.Tensor] = []
            epoch_t0 = time.time()
            if self.padded:
                epoch_edges = self._padded_epoch(epoch, state, epoch_losses)
            else:
                batches = packed_coo_batch_iterator(
                    self.train_ds, cfg.batch_size, rng=self.np_rng,
                    supernode_fn=self.supernode_fn,
                    pack_workers=cfg.pack_workers, pack_cache=pack_cache,
                    **iterator)
                if cfg.debug_checks:
                    batches = (b.validate() for b in batches)
                if rank_batch is not None:
                    batches = map(rank_batch, batches)
                batches = scan_chunk_iterator(batches, steps_per_chunk,
                                              args_fn)
                epoch_edges = self._epoch(epoch, state, epoch_losses, batches,
                                          (forward, optimizer, step_loss))
            losses = (torch.stack(epoch_losses).double().cpu().numpy().tolist()
                      if epoch_losses else [])
            if profiler is not None:
                self._stop_profile(profiler, epoch)
            if cfg.check_numerics and not np.all(np.isfinite(losses)):
                bad = int(np.argmax(~np.isfinite(losses)))
                raise FloatingPointError(f"non-finite loss {losses[bad]} at "
                                         f"epoch {epoch} step {bad}")
            epoch_dt = max(time.time() - epoch_t0, 1e-9)
            state.epoch = epoch + 1
            val_loss = None
            if main:
                entry: Dict[str, Any] = {
                    "epoch": state.epoch,
                    "main/loss": float(np.mean(losses)) if losses else None,
                    "lr": float(self.schedule(state.step)),
                    "elapsed_time": time.time() - t0,
                    "edges_per_s": epoch_edges / epoch_dt,
                }
                if cfg.eval_train:
                    for k, v in self._eval(self.train_ds).metrics.items():
                        entry[f"train/{k}"] = v
                if self.val_ds is not None and len(self.val_ds):
                    va = self._eval(self.val_ds)
                    val_loss = float(self.loss_fn(
                        torch.as_tensor(va.logits.reshape(va.labels.shape)),
                        torch.as_tensor(va.labels.astype(np.float32))))
                    entry["val/loss"] = val_loss
                    for k, v in va.metrics.items():
                        entry[f"val/{k}"] = v
                self.log.append(entry)
                logger.info("%s", json.dumps(entry))
                with open(os.path.join(cfg.out_dir, "log.json"), "w") as f:
                    json.dump(self.log, f, indent=2)
                if state.epoch % cfg.snapshot_interval == 0:
                    save_checkpoint(os.path.join(
                        cfg.out_dir, f"snapshot_epoch_{state.epoch}"), state)
            if self.val_ds is not None and len(self.val_ds):
                val_loss = self._shared(val_loss)
            # early stopping on val loss
            if val_loss is not None:
                if val_loss < state.best_val_loss - 1e-12:
                    state.best_val_loss = val_loss
                    state.epochs_since_best = 0
                    if main:
                        save_checkpoint(os.path.join(cfg.out_dir, "best"),
                                        state)
                else:
                    state.epochs_since_best += 1
                    if state.epochs_since_best >= cfg.early_stop_patience:
                        logger.info("early stop at epoch %d (best val loss "
                                    "%.5f)", state.epoch, state.best_val_loss)
                        break
        if main:
            save_checkpoint(os.path.join(cfg.out_dir, "final"), state)
        return {"state": state, "log": self.log}
