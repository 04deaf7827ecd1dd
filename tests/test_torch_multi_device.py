"""Multi-device training through the port's trainer and train CLI on the
CPU, over gloo ranks in processes of their own.

- ``--multi-device`` over 2 ranks (``tests/torch_parallel_ranks.py``
  ``cli_runs``) against the port's single-device run of the same flags,
  step for step (losses 1e-5): GGNN on ``coo``, co-attention (pair-local
  packing) in scan mode, GWM on ``coo`` (owner-masked), GGNN on
  ``packed``, multi-hot focal; the ranks' final parameters equal bit for
  bit; rank 0 alone writes checkpoints and logs; a resumed run and an
  early stop complete on both ranks; scan mode with a batch the ranks do
  not divide is refused, as in the JAX package;
- the CLI alone (no process group) on the CPU: one rank, the
  single-device run's losses;
- the JAX package's multi-device refusals, case for case;
- ``entry.dryrun_multichip(4)`` on 4 CPU ranks, and the multi-host demo:
  two processes print the one-process loss and checksum.
"""

import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.parallel.mesh import launch
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import TrainConfig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = ATOL = 1e-5


def _toy_csv(path, n=64, classes=False):
    """Label 1 when both molecules hold an oxygen (multi-label: also
    a nitrogen, a ring)."""
    oxy = ["CCO", "CC(=O)O", "OCCO", "C=O", "COC"]
    nox = ["CC", "CCC", "c1ccccc1", "CCN"]
    rng = np.random.default_rng(7)
    rows = []
    for i in range(n):
        a = str(rng.choice(oxy if rng.random() < 0.5 else nox))
        b = str(rng.choice(oxy if rng.random() < 0.5 else nox))
        if classes:
            lab = "||".join(c for c, hit in (
                ("oxy", a in oxy and b in oxy), ("nit", "N" in a + b),
                ("ring", "1" in a + b)) if hit) or "oxy"
        else:
            lab = int(a in oxy and b in oxy)
        rows.append(f"{i},{i},{a},{b},{lab}")
    with open(path, "w") as f:
        f.write("drugbank_id_1,drugbank_id_2,smiles_1,smiles_2,label\n")
        f.write("\n".join(rows) + "\n")
    return path


BASE = ["--fp-hidden-dim", "8", "--fp-out-dim", "8", "--conv-layers", "2",
        "--batch-size", "16", "--lr", "5e-3", "--epochs", "2",
        "--patience", "100", "--device", "cpu", "--seed", "3"]
# (name, flags); the multi-device run adds --multi-device
RUNS = [
    ("ggnn-coo", ["--compute-path", "coo"]),
    ("coattn-scan", ["--compute-path", "coo", "--attn", "para",
                     "--sim-method", "ntn", "--scan-steps", "2"]),
    ("gwm-coo", ["--compute-path", "coo", "--method", "ggnn-gwm"]),
    ("ggnn-packed", ["--compute-path", "packed"]),
    ("multilabel-focal", ["--compute-path", "coo", "--loss", "focal",
                          "--labels-csv", "LABELS"]),
]


def _argv(tmp, name, flags, multi, extra=()):
    train = os.path.join(tmp, "multi.csv" if "LABELS" in flags
                         else "toy.csv")
    flags = [os.path.join(tmp, "labels.csv") if f == "LABELS" else f
             for f in flags]
    out = os.path.join(tmp, f"{name}-{'multi' if multi else 'single'}")
    return (["--train", train, "--val", train, *BASE, *flags, "--out", out,
             *extra] + (["--multi-device"] if multi else []))


def _single(argv):
    """The port's single-device run in this process: its step losses and
    final epoch."""
    rec = {"losses": []}
    real_step, real_fit = loop.train_step, loop.Trainer.fit

    def step(*args, **kwargs):
        loss = real_step(*args, **kwargs)
        rec["losses"].append(float(loss))
        return loss

    def fit(self, *args, **kwargs):
        out = real_fit(self, *args, **kwargs)
        rec["epoch"] = out["state"].epoch
        return out

    loop.train_step, loop.Trainer.fit = step, fit
    try:
        assert train_cli.main(argv) == 0
    finally:
        loop.train_step, loop.Trainer.fit = real_step, real_fit
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("multi_device"))
    _toy_csv(os.path.join(tmp, "toy.csv"))
    _toy_csv(os.path.join(tmp, "multi.csv"), classes=True)
    with open(os.path.join(tmp, "labels.csv"), "w") as f:
        f.write("label\noxy\nnit\nring\n")
    specs = [(name, _argv(tmp, name, flags, True)) for name, flags in RUNS]
    snapshot = os.path.join(tmp, "ggnn-coo-multi", "snapshot_epoch_2")
    specs += [
        ("resume", _argv(tmp, "resume", ["--compute-path", "coo"], True,
                         ["--resume", snapshot, "--epochs", "3"])),
        ("early-stop", _argv(tmp, "early", ["--compute-path", "coo"], True,
                             ["--lr", "0", "--patience", "1",
                              "--epochs", "5"])),
        ("scan-undivided", _argv(tmp, "undivided", [
            "--compute-path", "coo", "--scan-steps", "2",
            "--batch-size", "15"], True)),
    ]
    path = os.path.join(tmp, "spec.pkl")
    with open(path, "wb") as f:
        pickle.dump(specs, f)
    launch(torch_parallel_ranks.cli_runs, 2, (path, tmp), timeout=400)
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return tmp, ranks


@pytest.mark.parametrize("name,flags", RUNS, ids=[r[0] for r in RUNS])
def test_multi_device_cli_matches_single_device(runs, name, flags):
    tmp, ranks = runs
    want = _single(_argv(tmp, name, flags, False))
    for r in ranks:
        got = r[name]
        assert got["rc"] == 0 and got["epoch"] == 2
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                                   atol=ATOL)
    for k, v in ranks[0][name]["params"].items():
        np.testing.assert_array_equal(ranks[1][name]["params"][k], v,
                                      err_msg=k)
    # rank 0 alone evaluates, logs and writes the run directory
    assert ranks[1][name]["saves"] == 0 and ranks[1][name]["log"] == []
    # best twice (each epoch improves), snapshot_epoch_2, final
    assert ranks[0][name]["saves"] == 4
    assert [e["epoch"] for e in ranks[0][name]["log"]] == [1, 2]
    out = os.path.join(tmp, f"{name}-multi")
    assert sorted(os.listdir(out)) == [
        "best", "config.json", "final", "log.json", "snapshot_epoch_2"]


def test_multi_device_resume_and_early_stop(runs):
    tmp, ranks = runs
    want = _single(_argv(tmp, "resume", ["--compute-path", "coo"], False,
                         ["--resume", os.path.join(
                             tmp, "ggnn-coo-multi", "snapshot_epoch_2"),
                          "--epochs", "3"]))
    for r in ranks:
        assert r["resume"]["epoch"] == 3 and len(r["resume"]["losses"]) == 4
        np.testing.assert_allclose(r["resume"]["losses"], want["losses"],
                                   rtol=RTOL, atol=ATOL)
        # lr 0: the val loss stays, and both ranks stop after epoch 2
        assert r["early-stop"]["epoch"] == 2
        assert "multi_device scan mode requires batch_size divisible by " \
            "the device count (2)" in r["scan-undivided"]["error"]


def test_multi_device_cli_alone_runs_one_rank(tmp_path):
    """Without a process group or torchrun's environment the CPU run is
    one rank: the single-device losses, and the group it set up is
    closed."""
    train = _toy_csv(str(tmp_path / "toy.csv"), n=32)
    argv = ["--train", train, *BASE, "--compute-path", "coo", "--epochs",
            "1", "--out", str(tmp_path / "run")]
    want = _single(argv)
    got = _single(argv + ["--multi-device"])
    assert got["losses"] == want["losses"]
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kw,reason", [
    (dict(compute_path="fused"),
     "multi_device requires compute_path 'packed' or 'coo'"),
    (dict(compute_path="padded"),
     "multi_device requires compute_path 'packed' or 'coo'"),
    (dict(compute_path="packed", scan_steps=2),
     "multi_device scan mode rides compute_path='coo'"),
    (dict(compute_path="packed", loss="focal"),
     "multi_device supports binary sigmoid-CE only"),
    (dict(compute_path="packed", class_num=3),
     "multi_device supports binary sigmoid-CE only"),
    (dict(compute_path="packed", method="ggnn-gwm"),
     "ggnn-gwm multi_device rides compute_path='coo' (owner-masked "
     "edgeshard)"),
    (dict(compute_path="coo", scan_steps=2, loss="hinge", class_num=3,
          attn="para"), None),
])
def test_multi_device_refusals_are_the_jax_ones(kw, reason):
    from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
    from gcnbmp_tpu.train.loop import packed_config_problems

    cfg = TrainConfig(multi_device=True, **kw)
    problems = loop.config_problems(cfg)
    if reason is None:
        assert problems == []
        return
    assert len(problems) == 1 and reason in problems[0], problems
    assert "multi_device" in problems[0]
    if "ggnn-gwm" in reason:  # the JAX check names it the same
        assert reason in packed_config_problems(JaxTrainConfig(
            multi_device=True, **kw))


def test_dryrun_multichip_on_four_cpu_ranks(capfd):
    from gcnbmp_tpu_torch import entry

    entry.dryrun_multichip(4, device="cpu", timeout=240)
    out = capfd.readouterr().out
    assert "4 ranks, mesh {'data': 2, 'model': 2}" in out
    assert "edgeshard over 4-rank graph axis" in out


def test_multihost_demo_two_processes_match_one(tmp_path):
    store = f"file://{tmp_path / 'store'}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gcnbmp_tpu_torch.parallel.multihost_demo",
         str(i), "2", store, "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            assert p.returncode == 0, out[-3000:]
            m = re.search(r"MULTIHOST loss=([\d.eE+-]+) checksum=([\d.eE+-]+)",
                          out)
            assert m, out[-3000:]
            results.append((float(m.group(1)), float(m.group(2))))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert results[0] == results[1]
    from gcnbmp_tpu_torch.parallel.multihost_demo import (
        reference_loss_and_checksum)

    loss, checksum = reference_loss_and_checksum("cpu")
    np.testing.assert_allclose(results[0][0], loss, rtol=1e-6)
    np.testing.assert_allclose(results[0][1], checksum, rtol=1e-5)
