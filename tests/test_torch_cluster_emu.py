"""The CPU stand-in's thread-block clusters (``tests/cuda_emu/cuda_runtime.h``),
on which the H=128 forward body (``fused_ggnn128_fwd.cuh``: a cluster of
two CTAs per tile) runs in the emulated tests.

``tests/cuda_emu/cluster_harness.cu`` is built with g++ against the
stand-in: its kernels run as clusters of two CTAs, each with its own
shared memory, reading the peer's through ``cluster_map`` and meeting at
the cluster barrier.  The cases hold a peer read, the barrier's ordering
over rounds that reuse two buffers (as the forward's hw_e does), the NaN
poison a CTA's shared memory takes when the CTA leaves (so that a read
after the peer has left shows in the results), and a grid that the
clusters do not divide, refused."""

import ctypes
import os

import numpy as np
import pytest

from cuda_emu.emulate import build_emulated

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")
N, ROUNDS = 256, 8  # the harness's buffer words and rounds


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_emulated(
        "cluster_harness.cu", str(tmp_path_factory.mktemp("emu_cluster")),
        entries={"cluster_peer": [ctypes.c_void_p, ctypes.c_int],
                 "cluster_leave": [ctypes.c_void_p],
                 "cluster_smem": [ctypes.c_void_p, ctypes.c_int],
                 "cluster_odd_grid": [ctypes.c_void_p]},
        src_dir=HERE)


def _peer(lib, clusters=2):
    out = np.full((2 * clusters, ROUNDS, N), np.nan, np.float32)
    assert lib.cluster_peer(out.ctypes.data, clusters) == 0
    return out


def _want(clusters=2):
    """Block b's read of round r, word i: its peer's value r 1e5 + rank 1e4 + i."""
    peer_rank = (np.arange(2 * clusters) % 2) ^ 1
    r, i = np.arange(ROUNDS), np.arange(N)
    return (r[None, :, None] * 100000 + peer_rank[:, None, None] * 10000
            + i[None, None, :]).astype(np.float32)


def test_emulated_cluster_peer_read(lib):
    """Each CTA reads the words its peer wrote, through cluster_map."""
    got = _peer(lib)
    assert np.array_equal(got[:, 0], _want()[:, 0])


def test_emulated_cluster_barrier_orders_rounds(lib):
    """Over eight rounds on two buffers used in turns, one cluster barrier
    a round: every read sees the round's words, none the round before's
    or two rounds before's, in every cluster."""
    got = _peer(lib, clusters=3)
    assert np.array_equal(got, _want(clusters=3))


def test_emulated_cluster_poisons_shared_memory_at_exit(lib):
    """A CTA's shared memory turns NaN when the CTA leaves: the peer that
    reads it after the cluster barrier reads the word written before it
    (or NaN, when the CTA has already left) and, once the CTA has left,
    NaN; after the launch both CTAs' are NaN."""
    out = np.zeros(2, np.float32)
    assert lib.cluster_leave(out.ctypes.data) == 0
    assert out[0] == 1.0 or np.isnan(out[0])
    assert np.isnan(out[1])
    _peer(lib)
    for rank in (0, 1):
        smem = np.zeros(2 * N, np.float32)
        assert lib.cluster_smem(smem.ctypes.data, rank) == 0
        assert np.isnan(smem).all()


def test_emulated_cluster_launch_refuses_a_partial_cluster(lib):
    """Three CTAs in clusters of two: refused (cudaErrorInvalidValue), no
    block runs."""
    out = np.full((3, ROUNDS, N), -1.0, np.float32)
    assert lib.cluster_odd_grid(out.ctypes.data) == 1
    assert (out == -1.0).all()
