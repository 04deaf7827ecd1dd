"""Typed training configuration (port of gcnbmp_tpu/train/config.py:18-183).

The JAX module imports no jax, but ``gcnbmp_tpu.train``'s ``__init__``
imports the trainer, so the port carries its own copy.  Every field and
default is the same, ``compute_path="padded"`` included, so a JAX run's
``config.json`` loads unchanged; ``train.loop.config_problems`` says
which values the port trains.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class TrainConfig:
    # model
    method: str = "ggnn"                      # encoder family
    sim_method: str = "hole"                  # scoring head
    attn: Optional[str] = None                # co-attention variant
    fp_hidden_dim: int = 16
    fp_out_dim: int = 16
    conv_layers: int = 4
    concat_hidden: bool = False
    layer_aggregator: Optional[str] = None
    fp_dropout_rate: float = 0.0
    fp_batch_normalization: bool = False
    weight_tying: bool = True
    net_hidden_dims: Tuple[int, ...] = ()
    class_num: int = 1                        # 1 = binary; >1 = multi-label
    siamese: bool = True
    symmetric: Optional[str] = None           # 'or' | 'and'
    mask_padding: bool = True

    # data
    augment: bool = False                     # swap-pair augmentation
    balance: bool = False                     # pos/neg rebalance
    max_pad: Optional[int] = None             # padded layout's pad size
    compute_path: str = "padded"              # padded | packed | coo | fused
    prefetch: int = 2                         # batches staged ahead (0 = off)
    prefetch_workers: int = 4                 # concurrent device transfers
    pack_workers: int = 4                     # host pack lookahead threads
    reuse_packs: bool = False                 # epoch-1 batches, reshuffled
    scan_steps: int = 0                       # train steps per dispatch

    # optimization
    loss: str = "sigmoid_ce"                  # sigmoid_ce | hinge | focal
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    batch_size: int = 32
    learning_rate: float = 1e-3
    lr_shift_strategy: int = 1                # 1|2|3
    lr_decay_rate: float = 0.5
    weight_decay: float = 0.0                 # coupled L2 on the gradient
    lasso: float = 0.0                        # L1: g + lasso * sign(p)
    grad_clip: float = 0.0                    # global-norm clip, 0 = off
    clr: Optional[str] = None                 # triangular|triangular2|exp_range
    clr_max_lr: float = 6e-3
    clr_step_size: int = 2000                 # iterations per half-cycle
    clr_gamma: float = 0.99994
    epochs: int = 500
    early_stop_patience: int = 10             # epochs
    seed: int = 2018

    # precision
    compute_dtype: str = "float32"

    # io / observability
    out_dir: str = "results"
    snapshot_interval: int = 2                # epochs
    resume: Optional[str] = None
    plot_reports: bool = True                 # loss.png / accuracy.png
    eval_train: bool = True                   # per-epoch train-set metrics
    profile_epoch: Optional[int] = None
    multi_device: bool = False
    debug_checks: bool = False
    check_numerics: bool = False              # fail on a nan/inf epoch loss

    def lr_shift_epochs(self) -> Tuple[int, ...]:
        """The epochs at which the exponential-shift schedule multiplies
        the learning rate by ``lr_decay_rate``."""
        return {
            1: (10, 20, 30, 40, 50, 60),
            2: (10, 20, 30, 40, 50, 60, 70, 80, 90, 100),
            3: (25, 50, 75, 100),
        }[self.lr_shift_strategy]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        d = json.loads(s)
        if d.get("net_hidden_dims") is not None:
            d["net_hidden_dims"] = tuple(d["net_hidden_dims"])
        return TrainConfig(**d)

    @staticmethod
    def from_dict(d: dict) -> "TrainConfig":
        """The config of a run config dict's fields (a ``config.json``, the
        port's or a JAX run's), defaults where it omits one, keys that are
        no field ignored."""
        fields = {f.name for f in dataclasses.fields(TrainConfig)}
        return TrainConfig(**{k: v for k, v in d.items() if k in fields})


# The JAX package's presets, field for field.
PRESETS = {
    "ggnn_hole_binary": TrainConfig(
        method="ggnn", sim_method="hole", conv_layers=8, fp_hidden_dim=32,
        fp_out_dim=32, weight_tying=False, learning_rate=1e-3,
        lr_shift_strategy=1, batch_size=32, augment=True,
    ),
    "ggnn_coattention": TrainConfig(
        method="ggnn", sim_method="ntn", attn="para", conv_layers=8,
        fp_hidden_dim=32, fp_out_dim=32, weight_tying=False,
        early_stop_patience=50,
    ),
    "relgcn_binary": TrainConfig(
        method="relgcn", sim_method="hole", fp_hidden_dim=32, fp_out_dim=64,
    ),
    "gin_binary": TrainConfig(
        method="gin", sim_method="hole", conv_layers=8, fp_hidden_dim=32,
        fp_out_dim=32,
    ),
    "ggnn_multilabel_x37": TrainConfig(
        method="ggnn", sim_method="hole", class_num=37, conv_layers=8,
        fp_hidden_dim=32, fp_out_dim=32, layer_aggregator="concat",
    ),
    "ggnn_multilabel_x86": TrainConfig(
        method="ggnn", sim_method="hole", class_num=86, conv_layers=8,
        fp_hidden_dim=32, fp_out_dim=32, weight_tying=False,
        compute_path="coo", compute_dtype="bfloat16", scan_steps=10,
        batch_size=512, learning_rate=2e-3, lr_shift_strategy=3,
        loss="focal", focal_alpha=0.75, epochs=120,
        early_stop_patience=25,
    ),
    "ggnn_hole_production": TrainConfig(
        method="ggnn", sim_method="hole", conv_layers=8, fp_hidden_dim=32,
        fp_out_dim=32, weight_tying=False, compute_path="coo",
        compute_dtype="bfloat16", scan_steps=10, reuse_packs=True,
        batch_size=2048, learning_rate=2e-3, augment=True,
    ),
}
