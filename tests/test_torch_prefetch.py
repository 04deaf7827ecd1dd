"""The port's prefetcher (``gcnbmp_tpu_torch.data.prefetch``) and the
trainer's use of it, on the CPU:

- every case of tests/test_prefetch.py (order, overlap, exceptions, the
  pool's order, overlap and transfer exceptions) run on both packages'
  ``PrefetchIterator`` with the same inputs; ``device_put_batch`` on a
  dataclass and on a nested tuple; ``close`` with the consumer stopped
  early;
- the port's ``Trainer`` with ``prefetch=2`` against ``prefetch=0``, step
  losses bit for bit: ``coo`` at scan 1 and 2, ``packed``, ``padded``
  (with dropout), ``reuse_packs`` over 2 epochs, an early stop, and
  ``multi_device`` over 2 gloo ranks;
- the port's ``Trainer`` against the JAX ``Trainer``, both at
  ``prefetch=2``, from the JAX initial tree: epoch losses within 1e-5;
- a producer that raises mid-epoch: ``fit`` raises it and leaves no
  prefetch thread alive.

On the CPU the prefetcher stages through ``stage_chunk`` / ``padded_args``
on its threads; the pinned ring and the side stream run on the card
(``chip_smoke.py`` phase 18)."""

import dataclasses
import os
import pickle
import sys
import threading
import time

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.data import prefetch as jprefetch
from gcnbmp_tpu.data.parsers import CSVPairParser as JaxParser
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu.train.loop import Trainer as JaxTrainer
from gcnbmp_tpu_torch.convert import from_jax_params
from gcnbmp_tpu_torch.data import CSVPairParser, prefetch
from gcnbmp_tpu_torch.data import wire
from gcnbmp_tpu_torch.parallel.mesh import launch
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import TrainConfig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
PACKAGES = {"jax": jprefetch.PrefetchIterator,
            "port": prefetch.PrefetchIterator}
TOL = 1e-5  # tests/test_torch_packed_train.py's


# ---------------------------------------------------------------------------
# the iterator: tests/test_prefetch.py's cases on both packages


def _order(cls):
    items = list(range(20))
    assert list(cls(iter(items), depth=3)) == items


def _overlap(cls):
    def slow_producer():
        for i in range(6):
            time.sleep(0.05)
            yield i

    it = cls(slow_producer(), depth=2)
    time.sleep(0.2)  # let the worker run ahead
    t0 = time.perf_counter()
    first_three = [next(it), next(it), next(it)]
    dt = time.perf_counter() - t0
    assert first_three == [0, 1, 2]
    assert dt < 0.15  # already staged (loose: CI scheduler noise)


def _exceptions(cls):
    def bad():
        yield 1
        raise RuntimeError("boom")

    it = cls(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def _pool_order(cls):
    def jittery_transfer(x):
        time.sleep(0.01 * ((x * 7) % 3))  # out-of-order completion
        return x * 10

    items = list(range(24))
    out = list(cls(iter(items), depth=4, transfer=jittery_transfer,
                   workers=4))
    assert out == [x * 10 for x in items]


def _pool_overlap(cls):
    def slow_transfer(x):
        time.sleep(0.05)
        return x

    items = list(range(8))
    t0 = time.perf_counter()
    out = list(cls(iter(items), depth=8, transfer=slow_transfer, workers=4))
    dt = time.perf_counter() - t0
    assert out == items
    assert dt < 8 * 0.05  # serial would take >=0.4s


def _pool_transfer_exceptions(cls):
    def bad_transfer(x):
        if x == 2:
            raise ValueError("transfer boom")
        return x

    it = cls(iter(range(5)), depth=4, transfer=bad_transfer, workers=3)
    with pytest.raises(ValueError, match="transfer boom"):
        list(it)


CASES = [_order, _overlap, _exceptions, _pool_order, _pool_overlap,
         _pool_transfer_exceptions]


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("case", CASES, ids=[c.__name__[1:] for c in CASES])
def test_prefetch_iterator_cases_on_both_packages(case, package):
    case(PACKAGES[package])


@pytest.mark.parametrize("workers", [1, 3])
def test_port_iterator_gives_the_jax_items_and_order(workers):
    def transfer(x):
        time.sleep(0.002 * (x % 3))
        return (x, x * x)

    items = list(range(30))
    want = list(jprefetch.PrefetchIterator(iter(items), depth=2,
                                           transfer=transfer,
                                           workers=workers))
    got = prefetch.PrefetchIterator(iter(items), depth=2, transfer=transfer,
                                    workers=workers)
    assert list(got) == want
    assert got.count == len(items)


def test_device_put_batch_dataclass_and_tuple():
    from gcnbmp_tpu_torch.chem import GGNNFeaturizer, mol_from_smiles
    from gcnbmp_tpu_torch.data.dataset import PairDataset, make_batch

    f = GGNNFeaturizer()
    ds = PairDataset()
    ds.append(f(mol_from_smiles("CCO")), f(mol_from_smiles("CC")),
              np.float32(1))
    batch = make_batch(ds, [0])
    placed = prefetch.device_put_batch(batch, "cpu")
    assert isinstance(placed.atoms1, torch.Tensor)
    np.testing.assert_array_equal(placed.atoms1.numpy(), batch.atoms1)
    np.testing.assert_array_equal(placed.adj2.numpy(), batch.adj2)
    assert placed.super1 is None and placed.num_edges == batch.num_edges
    nested = (batch.atoms1, [batch.mask1, {"labels": batch.labels}], 3)
    got = prefetch.device_put_batch(nested, torch.device("cpu"))
    assert isinstance(got, tuple) and isinstance(got[1], list)
    assert got[2] == 3
    np.testing.assert_array_equal(got[0].numpy(), batch.atoms1)
    np.testing.assert_array_equal(got[1][0].numpy(), batch.mask1)
    np.testing.assert_array_equal(got[1][1]["labels"].numpy(), batch.labels)


@pytest.mark.parametrize("workers", [1, 4])
def test_close_stops_a_producer_blocked_on_a_full_queue(workers):
    produced = []

    def endless():
        try:
            i = 0
            while True:
                produced.append(i)
                yield i
                i += 1
        finally:
            produced.append("closed")

    it = prefetch.PrefetchIterator(endless(), depth=2,
                                   transfer=lambda x: x, workers=workers)
    assert [next(it), next(it)] == [0, 1]
    time.sleep(0.05)  # the producer fills the queue and blocks
    it.close()
    assert not it._thread.is_alive()
    assert produced[-1] == "closed"  # the upstream generator was closed
    with pytest.raises(StopIteration):
        next(it)
    it.close()  # twice is fine


# ---------------------------------------------------------------------------
# the trainer: prefetch=2 against prefetch=0


@pytest.fixture(scope="module")
def sample():
    df = pd.read_csv(SAMPLE)
    return (CSVPairParser().parse(df.head(96)).dataset,
            CSVPairParser().parse(df.tail(32)).dataset, df)


def _fit(tmp_path, sample, prefetch_depth, **kw):
    """The trainer's step losses (floats, in order) and final epoch."""
    train_ds, val_ds, _ = sample
    base = dict(fp_hidden_dim=8, fp_out_dim=8, conv_layers=2,
                batch_size=16, learning_rate=5e-3, epochs=2,
                eval_train=False, seed=3, prefetch=prefetch_depth,
                out_dir=str(tmp_path / f"run{prefetch_depth}"))
    base.update(kw)
    losses = []
    real_step = loop.train_step

    def step(*args, **kwargs):
        loss = real_step(*args, **kwargs)
        losses.append(float(loss))
        return loss

    loop.train_step = step
    try:
        trainer = loop.Trainer(TrainConfig(**base), train_ds, val_ds,
                               device="cpu")
        before = set(threading.enumerate())
        state = trainer.fit()["state"]
    finally:
        loop.train_step = real_step
    # no thread of the prefetcher or the packer outlives fit
    assert not set(threading.enumerate()) - before
    return losses, state.epoch, trainer


TRAINER_RUNS = [
    ("coo-scan1", dict(compute_path="coo")),
    ("coo-scan2", dict(compute_path="coo", scan_steps=2)),
    ("packed", dict(compute_path="packed")),
    ("padded", dict(compute_path="padded")),
    ("padded-dropout", dict(compute_path="padded", fp_dropout_rate=0.2)),
    ("reuse-packs", dict(compute_path="coo", reuse_packs=True)),
    ("coattn-workers1", dict(compute_path="coo", attn="para",
                             sim_method="ntn", prefetch_workers=1)),
    ("early-stop", dict(compute_path="coo", learning_rate=0.0,
                        early_stop_patience=1, epochs=5)),
]


@pytest.mark.parametrize("kw", [r[1] for r in TRAINER_RUNS],
                         ids=[r[0] for r in TRAINER_RUNS])
def test_trainer_prefetch_gives_the_unprefetched_losses(tmp_path, sample,
                                                        kw):
    want, want_epoch, _ = _fit(tmp_path, sample, 0, **kw)
    got, got_epoch, trainer = _fit(tmp_path, sample, 2, **kw)
    assert got == want and got_epoch == want_epoch
    assert len(got) == 12 * want_epoch // 2
    if kw.get("early_stop_patience"):
        assert got_epoch == 2  # lr 0: the val loss never improves
    # one entry per epoch, every item taken
    steps = 2 if kw.get("scan_steps") else 1
    assert [e["items"] for e in trainer.prefetch_log] == \
        [6 // steps] * got_epoch


def test_a_producer_that_raises_mid_epoch_stops_fit_and_its_threads(
        tmp_path, sample, monkeypatch):
    real = wire.packed_coo_batch_iterator
    steps = []
    real_step = loop.train_step

    def failing(*args, **kwargs):
        for i, b in enumerate(real(*args, **kwargs)):
            if i == 3:
                raise RuntimeError("packing failed")
            yield b

    monkeypatch.setattr(wire, "packed_coo_batch_iterator", failing)
    monkeypatch.setattr(loop, "train_step",
                        lambda *a, **k: steps.append(1) or real_step(*a, **k))
    train_ds, val_ds, _ = sample
    cfg = TrainConfig(fp_hidden_dim=8, fp_out_dim=8, conv_layers=2,
                      batch_size=16, compute_path="coo", epochs=2,
                      eval_train=False, prefetch=2, prefetch_workers=4,
                      out_dir=str(tmp_path / "run"))
    trainer = loop.Trainer(cfg, train_ds, val_ds, device="cpu")
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="packing failed"):
        trainer.fit()
    assert len(steps) == 3  # the batches before the failure, in order
    # neither the prefetcher's threads nor the packer's pool outlive fit
    assert not set(threading.enumerate()) - before


def test_a_step_that_raises_leaves_no_prefetch_thread(tmp_path, sample,
                                                      monkeypatch):
    def failing_step(*args, **kwargs):
        raise FloatingPointError("step failed")

    monkeypatch.setattr(loop, "train_step", failing_step)
    train_ds, val_ds, _ = sample
    for path in ("coo", "padded"):
        cfg = TrainConfig(fp_hidden_dim=8, fp_out_dim=8, conv_layers=2,
                          batch_size=16, compute_path=path, epochs=1,
                          eval_train=False, prefetch=1,
                          out_dir=str(tmp_path / path))
        trainer = loop.Trainer(cfg, train_ds, val_ds, device="cpu")
        before = set(threading.enumerate())
        with pytest.raises(FloatingPointError, match="step failed"):
            trainer.fit()
        assert not set(threading.enumerate()) - before, path


def test_multi_device_prefetch_gives_the_unprefetched_losses(tmp_path,
                                                             sample):
    """Two gloo ranks, each training its shard: the same step losses on
    each rank with and without the prefetcher, and the same on both
    ranks."""
    csv_path = str(tmp_path / "pairs.csv")
    sample[2].head(64).to_csv(csv_path, index=False)
    base = dict(fp_hidden_dim=8, fp_out_dim=8, conv_layers=2, batch_size=16,
                learning_rate=5e-3, epochs=2, eval_train=False, seed=3)
    flavours = {"coo": dict(compute_path="coo"),
                "coattn-scan": dict(compute_path="coo", attn="para",
                                    sim_method="ntn", scan_steps=2)}
    spec = [(f"{name}-p{depth}", csv_path,
             dict(base, **kw, prefetch=depth))
            for name, kw in flavours.items() for depth in (0, 2)]
    path = str(tmp_path / "spec.pkl")
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    launch(torch_parallel_ranks.prefetch_runs, 2, (path, str(tmp_path)),
           timeout=300)
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    for name in flavours:
        for r in ranks:
            assert len(r[f"{name}-p0"]) == 8
            assert r[f"{name}-p2"] == r[f"{name}-p0"], name
        assert ranks[0][f"{name}-p2"] == ranks[1][f"{name}-p2"]


def test_trainer_follows_the_jax_trainer_with_both_prefetching(tmp_path):
    """GGNN on ``coo`` from the JAX trainer's initial tree, both trainers
    at ``prefetch=2`` (the JAX one staging on its prefetch thread through
    ``jax.device_put``): every epoch's train and val loss within 1e-5."""
    df = pd.read_csv(SAMPLE)
    kw = dict(method="ggnn", conv_layers=2, fp_hidden_dim=8, fp_out_dim=32,
              weight_tying=False, compute_path="coo", batch_size=16,
              learning_rate=5e-3, epochs=3, early_stop_patience=100,
              eval_train=False, seed=0, prefetch=2, prefetch_workers=4,
              plot_reports=False)
    jtrainer = JaxTrainer(JaxTrainConfig(**kw, out_dir=str(tmp_path / "j")),
                          JaxParser().parse(df.head(96)).dataset,
                          JaxParser().parse(df.tail(32)).dataset)
    tree = jax.tree_util.tree_map(np.asarray, jtrainer._init_state().params)
    want = jtrainer.fit()["log"]
    trainer = loop.Trainer(TrainConfig(**kw, out_dir=str(tmp_path / "t")),
                           CSVPairParser().parse(df.head(96)).dataset,
                           CSVPairParser().parse(df.tail(32)).dataset,
                           device="cpu")
    from_jax_params(tree, trainer.model)
    got = trainer.fit()["log"]
    assert len(got) == len(want) == 3
    assert [e["items"] for e in trainer.prefetch_log] == [6, 6, 6]
    for g, w in zip(got, want):
        for key in ("main/loss", "val/loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=TOL, atol=TOL,
                                       err_msg=f"epoch {w['epoch']} {key}")


def test_trainer_config_default_prefetches(tmp_path, sample):
    """The JAX defaults, ``prefetch=2`` and ``prefetch_workers=4``, are the
    port's too, and a trainer on them logs each epoch's prefetcher."""
    assert (TrainConfig().prefetch, TrainConfig().prefetch_workers) == \
        (JaxTrainConfig().prefetch, JaxTrainConfig().prefetch_workers) == \
        (2, 4)
    train_ds, val_ds, _ = sample
    cfg = TrainConfig(fp_hidden_dim=8, fp_out_dim=8, conv_layers=2,
                      batch_size=16, compute_path="coo", epochs=1,
                      eval_train=False, out_dir=str(tmp_path / "run"))
    trainer = loop.Trainer(cfg, train_ds, val_ds, device="cpu")
    trainer.fit()
    (entry,) = trainer.prefetch_log
    assert entry["items"] == 6 and entry["produce_s"] > 0
    assert dataclasses.asdict(cfg)["prefetch"] == 2


def test_threads_enter_the_card_a_bare_cuda_device_names(monkeypatch):
    """``cuda`` without an index is the constructing thread's current
    card (the train CLI passes ``cuda``); each prefetch thread sets that
    index, which ``torch.cuda.set_device`` needs."""
    entered = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device", entered.append)
    assert prefetch._cuda_index("cuda") == 3
    assert prefetch._cuda_index(torch.device("cuda", 1)) == 1
    assert prefetch._cuda_index("cpu") is None
    prefetch._thread_device("cuda")()
    prefetch._thread_device("cuda:2")()
    prefetch._thread_device("cpu")()
    assert entered == [3, 2]
