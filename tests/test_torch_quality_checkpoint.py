"""A quality row's checkpoint scored by both packages on the CPU.

``tests/data/scaffold_seed0_best/`` holds the ``best`` checkpoint
(``params.npz``), ``config.json`` and the evaluate CLI's
``eval_result.json`` of the ``ref_scale_scafsplit`` row, trained and
scored with the port on an NVIDIA H100
(``python3 chip_quality.py --rows scaffold --seeds 0``).  The JAX
``PackedPairEvaluator``, on the same weights through
``convert.to_jax_params``, and the port's evaluator score it over the
whole committed scaffold test split: their metrics agree within 1e-5,
and the port's agree with those written on the card within 1e-4 (the
card sums in another order, so a logit near 0.5 may cross the accuracy
threshold; one pair is 2.7e-5 of ACC).  The row's test AUROC is thus
the checkpoint's, whichever package scores it."""

import json
import os

import numpy as np
import torch

from gcnbmp_tpu.eval import evaluate as jeval
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.convert import to_jax_params
from gcnbmp_tpu_torch.data import CSVPairParser
from gcnbmp_tpu_torch.eval.evaluate import PackedPairEvaluator
from gcnbmp_tpu_torch.train.checkpoints import load_run

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(ROOT, "tests", "data", "scaffold_seed0_best")
TEST = os.path.join(ROOT, "dataset", "synth546", "scaffold",
                    "ddi_scaffold_test.csv")
BATCH = 2048


def _assert_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=tol,
                                   err_msg=key)


def test_scaffold_checkpoint_scores_the_same_in_both_packages(tmp_path):
    # load_run reads <run>/<checkpoint>/params.npz
    os.makedirs(tmp_path / "best")
    os.symlink(os.path.join(RUN, "params.npz"),
               tmp_path / "best" / "params.npz")
    os.symlink(os.path.join(RUN, "config.json"), tmp_path / "config.json")
    config, model = load_run(str(tmp_path), "best", "cpu")
    ds = CSVPairParser().parse(TEST).dataset
    assert len(ds) == 37037
    got = PackedPairEvaluator(model, batch_size=BATCH,
                              device="cpu").evaluate(ds).metrics
    cfg = JaxTrainConfig.from_json(json.dumps(config))
    want = jeval.PackedPairEvaluator(cfg, to_jax_params(model),
                                     batch_size=BATCH).evaluate(ds).metrics
    print("port", json.dumps(got), "\njax ", json.dumps(want))
    _assert_close(got, want, 1e-5)
    with open(os.path.join(RUN, "eval_result.json")) as f:
        _assert_close(got, json.load(f), 1e-4)
