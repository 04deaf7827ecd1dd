"""The port's padded batches against the JAX package's, bit for bit, on
dataset/sample/sample200.csv: ``bucket_size``, ``make_batch`` (fill rows
of atom id 0 and label -1, GWM supernode rows, ``n_edges`` from the
graphs' metadata, an explicit and a bucketed pad) and ``batch_iterator``
(shuffled by the same numpy generator, ``drop_remainder``, the filled
tail)."""

import os

import numpy as np
import pytest

from gcnbmp_tpu.data import dataset as jdataset
from gcnbmp_tpu.data.parsers import CSVPairParser as JCSVPairParser
from gcnbmp_tpu.models.gwm import default_supernode_fn as jsupernode_fn
from gcnbmp_tpu_torch.data import CSVPairParser, dataset
from gcnbmp_tpu_torch.models.gwm import default_supernode_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
FIELDS = ("atoms1", "adj1", "mask1", "atoms2", "adj2", "mask2", "labels",
          "super1", "super2")


@pytest.fixture(scope="module")
def datasets():
    return (CSVPairParser().parse(SAMPLE).dataset,
            JCSVPairParser().parse(SAMPLE).dataset)


def _assert_batches_equal(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert want.atom_feats1 is None and want.atom_feats2 is None
    assert got.num_edges == want.num_edges
    assert got.batch_size == want.batch_size


def test_bucket_size_matches_jax():
    for n in (0, 1, 8, 9, 20, 24, 25, 100, 256, 257, 300, 700):
        assert dataset.bucket_size(n) == jdataset.bucket_size(n)
    assert dataset.DEFAULT_BUCKETS == jdataset.DEFAULT_BUCKETS


@pytest.mark.parametrize("pad_to,fill,supers", [
    (None, None, False), (32, 16, False), (None, 16, True), (64, None, True)],
    ids=["bucketed", "pad32-filled", "filled-gwm", "pad64-gwm"])
def test_make_batch_matches_jax(datasets, pad_to, fill, supers):
    ds, jds = datasets
    idx = [3, 0, 17, 42, 5, 199, 100, 77, 150, 9]
    got = dataset.make_batch(ds, idx, pad_to=pad_to, fill_batch_to=fill,
                             supernode_fn=default_supernode_fn()
                             if supers else None)
    want = jdataset.make_batch(jds, idx, pad_to=pad_to, fill_batch_to=fill,
                               supernode_fn=jsupernode_fn()
                               if supers else None)
    _assert_batches_equal(got, want)
    if fill:
        assert (got.labels[len(idx):] == -1).all()
        assert (got.mask1[len(idx):].sum(1) == 1).all()
        if supers:
            assert not got.super1[len(idx):].any()


def test_make_batch_refuses_a_graph_wider_than_the_pad(datasets):
    ds, _ = datasets
    with pytest.raises(ValueError, match="does not fit pad size"):
        dataset.make_batch(ds, list(range(len(ds))), pad_to=8)


@pytest.mark.parametrize("drop,supers", [(True, False), (False, True)],
                         ids=["drop-remainder", "filled-tail-gwm"])
def test_batch_iterator_matches_jax(datasets, drop, supers):
    ds, jds = datasets
    kw = dict(shuffle=True, pad_to=24, drop_remainder=drop)
    got = list(dataset.batch_iterator(
        ds, 48, rng=np.random.default_rng(5),
        supernode_fn=default_supernode_fn() if supers else None, **kw))
    want = list(jdataset.batch_iterator(
        jds, 48, rng=np.random.default_rng(5),
        supernode_fn=jsupernode_fn() if supers else None, **kw))
    assert len(got) == len(want) == (4 if drop else 5)
    for a, b in zip(got, want):
        _assert_batches_equal(a, b)
    ordered = list(dataset.batch_iterator(ds, 64, shuffle=False))
    assert [b.batch_size for b in ordered] == [64] * 4
    assert (ordered[-1].labels[200 - 192:] == -1).all()
