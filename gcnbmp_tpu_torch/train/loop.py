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
  semantics of ``make_packed_scan_train_step`` (:358-390)
- ``Trainer``     <- :686-1408 for GGNN on ``compute_path="fused"`` or
  ``"coo"`` (one kernel path, :799-858) and MPNN on ``compute_path="coo"``
  (the Set2Set table width fitted to the data, :817-827), per step or in
  scan mode (the loop at :1185-1263, the guard at :739-745)
- ``config_problems`` <- ``packed_config_problems`` (:532-575), for what
  the port trains; ``kernel_problems`` names the widths the card's
  kernels are not built for.

``compute_dtype="bfloat16"`` is accepted and computed in f32, for GGNN as
the JAX fused path computes it (``_fused_encoder_g_nodes`` ignores
compute_dtype; its bf16 adjacency of 0/1 values is exact) and for MPNN as
its fused kernels do.  The JAX **coo** path with bf16 rounds its XLA
matmul operands to bf16, so that pairing is where the port's numbers
differ from JAX's; the parity tests run f32.
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
               class_num: int = 1) -> torch.Tensor:
    """One step over a wire-compact batch: loss, backward (for GGNN K2b,
    K1b or K3 twice, by ``models.packed.FUSED_READOUT`` and
    ``ops.fused_ggnn.TWOPASS``; K4b and K5b for MPNN; on the card),
    optimizer update.  Returns the loss as a device tensor; the caller
    fetches losses once per epoch."""
    for p in optimizer.params:
        p.grad = None
    logits = model(*args)
    if class_num == 1:
        logits = logits.reshape(labels.shape)
    loss = loss_fn(logits, labels)
    loss.backward()
    optimizer.step()
    return loss.detach()


# ---------------------------------------------------------------------------
# what the port trains


def config_problems(cfg: TrainConfig) -> List[str]:
    """Options of ``cfg`` the port does not train yet, each naming the
    ROADMAP item that brings it."""
    problems = []
    if cfg.method == "mpnn":
        # as in the JAX package, MPNN trains on the coo path (its fused
        # path is GGNN-only), which runs K5 and K4 on the card
        if cfg.compute_path != "coo":
            problems.append(f"compute_path={cfg.compute_path!r} with "
                            "method='mpnn': MPNN trains on 'coo', as in the "
                            "JAX package; its other layouts come with "
                            "ROADMAP queue 1, items 4 and 7")
    elif cfg.compute_path not in ("fused", "coo"):
        # GGNN on coo trains through the same kernel path as fused: the
        # JAX coo path runs XLA's stack, which has no Pallas kernel
        problems.append(f"compute_path={cfg.compute_path!r}: the port trains "
                        "GGNN on 'fused' and 'coo'; the other layouts come "
                        "with ROADMAP queue 1, items 4 and 7")
    if cfg.method not in ("ggnn", "mpnn"):
        problems.append(f"method={cfg.method!r}: other encoders are ROADMAP "
                        "queue 1, item 9")
    if cfg.sim_method != "hole":
        problems.append(f"sim_method={cfg.sim_method!r}: other heads are "
                        "ROADMAP queue 1, item 7")
    if cfg.attn is not None:
        problems.append(f"attn={cfg.attn!r}: co-attention is ROADMAP queue 1, "
                        "item 8")
    if cfg.layer_aggregator:
        problems.append(f"layer_aggregator={cfg.layer_aggregator!r}: "
                        "ROADMAP queue 1, item 9")
    for flag, value in (("siamese", not cfg.siamese),
                        ("symmetric", cfg.symmetric is not None),
                        ("fp_dropout_rate", cfg.fp_dropout_rate > 0),
                        ("fp_batch_normalization", cfg.fp_batch_normalization),
                        ("concat_hidden", cfg.concat_hidden)):
        if value:
            problems.append(f"{flag}={getattr(cfg, flag)!r}: the packed "
                            "layout has none; the padded layout is ROADMAP "
                            "queue 1, item 7")
    if cfg.multi_device:
        problems.append("multi_device: ROADMAP queue 1, item 11")
    if cfg.resume:
        problems.append("resume: checkpoint restore is ROADMAP queue 1, "
                        "item 6")
    if cfg.profile_epoch is not None:
        problems.append("profile_epoch: tracing is ROADMAP queue 1, item 6")
    if cfg.debug_checks:
        problems.append("debug_checks: ROADMAP queue 1, item 6")
    return problems


def kernel_problems(cfg, device) -> List[str]:
    """Widths of ``cfg`` (a ``TrainConfig`` or a run config dict) that the
    card's kernels are not built for, when ``device`` is CUDA; none on the
    CPU, where the wrappers run their plain versions at any width.  A GGNN
    whose readout width differs from its hidden width runs K1 with the
    plain readout (``models.packed.fused_form``), so only H is checked."""
    from gcnbmp_tpu_torch.models.packed import SET2SET_STEPS
    from gcnbmp_tpu_torch.ops import fused_ggnn, fused_mpnn, set2set_kernel

    if torch.device(device).type != "cuda":
        return []
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    method = cfg.get("method", "ggnn")
    hidden = int(cfg.get("fp_hidden_dim", TrainConfig.fp_hidden_dim))
    item = 'ROADMAP queue 2, "Open: hidden widths"'
    # MPNN runs K5 and K4 (Set2Set over H channels)
    held = {"ggnn": fused_ggnn.KERNEL_HIDDEN,
            "mpnn": [h for h in fused_mpnn.KERNEL_HIDDEN
                     if h in set2set_kernel.KERNEL_HIDDEN]}.get(method, [])
    problems = []
    if held and hidden not in held:
        problems.append(f"fp_hidden_dim={hidden} with method={method!r}: the "
                        f"card's kernels are built for {list(held)}; other "
                        f"widths are {item}")
    if method == "mpnn" and SET2SET_STEPS > set2set_kernel.KERNEL_MAX_STEPS:
        problems.append(f"{SET2SET_STEPS} Set2Set steps: the card's kernel "
                        f"takes at most {set2set_kernel.KERNEL_MAX_STEPS}; "
                        f"more are {item}")
    return problems


def stage_chunk(stacked, labels, device):
    """Copy a chunk of S stacked wire batches and their labels to
    ``device`` in one transfer: the arrays (all 4-byte types: the int32
    wire arrays, the f32 labels) laid side by side in one int32 buffer.
    Returns (the wire arrays, the labels) as views of the copy, each with
    its leading (S,) axis."""
    parts = [np.ascontiguousarray(a) for a in stacked]
    parts.append(np.ascontiguousarray(labels, np.float32))
    if any(p.dtype.itemsize != 4 for p in parts):
        raise TypeError("stage_chunk takes 4-byte arrays, got "
                        f"{[str(p.dtype) for p in parts]}")
    flat = torch.from_numpy(np.concatenate(
        [p.view(np.int32).reshape(-1) for p in parts])).to(device)
    views, start = [], 0
    for p in parts:
        dtype = torch.from_numpy(p[:0].reshape(-1)).dtype
        views.append(flat[start:start + p.size].view(dtype).view(p.shape))
        start += p.size
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
    Each step runs the GGNN kernel path in the form
    ``models.packed.fused_form`` names (K2 and K2b by default) or K5, K4,
    K4b and K5b (MPNN) on the card.  Batches reach the device in chunks
    of ``max(scan_steps, 1)``, one host-to-device copy per chunk
    (``stage_chunk``), and the chunk's steps run back to back on slices of
    it: the batches, order and updates of the JAX scan mode, whose tail
    chunk is dropped likewise.  Epoch ends evaluate train and val through
    ``PackedPairEvaluator``, stop early on val loss, and save
    ``snapshot_epoch_*``, ``best`` and ``final`` checkpoints
    (``train.checkpoints``)."""

    def __init__(self, config: TrainConfig, train_ds, val_ds=None,
                 device="cuda"):
        from gcnbmp_tpu_torch.convert import from_jax_params, init_params
        from gcnbmp_tpu_torch.models.packed import (
            make_packed_predictor, model_kwargs_from_config)

        problems = config_problems(config) + kernel_problems(config, device)
        if problems:
            raise ValueError("configuration outside the ported training "
                             "path: " + "; ".join(problems))
        self.config = config
        self.device = torch.device(device)
        rng = np.random.default_rng(config.seed)
        if config.augment:
            train_ds = train_ds.augment_swap()
        if config.balance:
            train_ds = train_ds.rebalance(rng)
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.np_rng = rng
        kwargs = model_kwargs_from_config(dataclasses.asdict(config))
        if config.method == "mpnn":
            # the Set2Set table width: the largest molecule of the run's
            # datasets, rounded up to 8 (loop.py:817-827)
            from gcnbmp_tpu_torch.data.packing import max_atoms_lane_rounded

            dss = [train_ds] + ([val_ds] if val_ds is not None
                                and len(val_ds) else [])
            kwargs["s2s_n_max"] = max_atoms_lane_rounded(dss)
        self.model = from_jax_params(
            init_params(kwargs, config.seed),
            make_packed_predictor(**kwargs)).to(self.device)
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
        self.loss_fn = make_loss(
            config.loss, **({"gamma": config.focal_gamma,
                             "alpha": config.focal_alpha}
                            if config.loss == "focal" else {}))
        self.log: List[Dict[str, Any]] = []

    def _eval(self, ds):
        from gcnbmp_tpu_torch.eval.evaluate import PackedPairEvaluator

        res = PackedPairEvaluator(self.model, batch_size=self.config.batch_size,
                                  class_num=self.config.class_num,
                                  device=self.device).evaluate(ds)
        self.model.train()
        return res

    def fit(self, max_epochs: Optional[int] = None) -> Dict[str, Any]:
        from gcnbmp_tpu_torch.data import estimate_coo_capacities
        from gcnbmp_tpu_torch.data.wire import (
            compact_coo_arrays, packed_coo_batch_iterator, scan_chunk_iterator)
        from gcnbmp_tpu_torch.models.packed import fused_form
        from gcnbmp_tpu_torch.train.checkpoints import save_checkpoint

        cfg = self.config
        state = TrainState(self.model, self.optimizer, 0, 0, float("inf"), 0)
        datasets = [self.train_ds]
        if self.val_ds is not None and len(self.val_ds):
            datasets.append(self.val_ds)
        self.num_tiles, self.edge_capacity = estimate_coo_capacities(
            datasets, cfg.batch_size)
        pack_cache = [] if cfg.reuse_packs else None
        if cfg.prefetch > 0:
            logger.info("prefetch=%d: the port stages each batch on the step's "
                        "thread; the pinned-memory prefetcher is ROADMAP "
                        "queue 1, item 1", cfg.prefetch)
        if cfg.plot_reports:
            logger.info("plot_reports: the port writes no loss/accuracy PNGs "
                        "(ROADMAP queue 1, item 6); log.json holds the curves")
        if cfg.method == "ggnn":
            logger.info("GGNN kernel path: %s",
                        fused_form(cfg.fp_hidden_dim, cfg.fp_out_dim))
        steps_per_chunk = max(cfg.scan_steps, 1)
        os.makedirs(cfg.out_dir, exist_ok=True)
        max_epochs = max_epochs or cfg.epochs
        self.model.train()
        t0 = time.time()
        for epoch in range(state.epoch, max_epochs):
            epoch_losses: List[torch.Tensor] = []
            epoch_edges = 0
            epoch_t0 = time.time()
            batches = packed_coo_batch_iterator(
                self.train_ds, cfg.batch_size, self.num_tiles,
                self.edge_capacity, self.np_rng,
                pack_workers=cfg.pack_workers, pack_cache=pack_cache)
            for stacked, labels, edges in scan_chunk_iterator(
                    batches, steps_per_chunk, compact_coo_arrays):
                args, labels = stage_chunk(stacked, labels, self.device)
                for i in range(steps_per_chunk):
                    epoch_losses.append(train_step(
                        self.model, self.optimizer, [a[i] for a in args],
                        labels[i], self.loss_fn, cfg.class_num))
                epoch_edges += edges
                state.step += steps_per_chunk
            losses = (torch.stack(epoch_losses).double().cpu().numpy().tolist()
                      if epoch_losses else [])
            if cfg.check_numerics and not np.all(np.isfinite(losses)):
                bad = int(np.argmax(~np.isfinite(losses)))
                raise FloatingPointError(f"non-finite loss {losses[bad]} at "
                                         f"epoch {epoch} step {bad}")
            epoch_dt = max(time.time() - epoch_t0, 1e-9)
            state.epoch = epoch + 1
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
            val_loss = None
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
            # early stopping on val loss
            if val_loss is not None:
                if val_loss < state.best_val_loss - 1e-12:
                    state.best_val_loss = val_loss
                    state.epochs_since_best = 0
                    save_checkpoint(os.path.join(cfg.out_dir, "best"), state)
                else:
                    state.epochs_since_best += 1
                    if state.epochs_since_best >= cfg.early_stop_patience:
                        logger.info("early stop at epoch %d (best val loss "
                                    "%.5f)", state.epoch, state.best_val_loss)
                        break
        save_checkpoint(os.path.join(cfg.out_dir, "final"), state)
        return {"state": state, "log": self.log}
