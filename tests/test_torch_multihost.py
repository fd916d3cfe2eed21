"""The port's multi-host pieces (blp_tpu_torch/parallel/multihost.py)
against the TPU package's (tests/test_multihost.py): the edge partition and
the host-local batcher give JAX's indices; a world of 2 gloo ranks
reassembles each global batch from the ranks' rows; `initialize` keeps
JAX's guards (no address: no-op; a world already up: no-op) and passes the
keys through otherwise."""

import numpy as np
import pytest
import torch.distributed as dist

import torch_dist_workers as workers
from blp_tpu.parallel import multihost as j_mh
from blp_tpu_torch.parallel import comm
from blp_tpu_torch.parallel import multihost as t_mh


@pytest.mark.parametrize("n,hosts", [(1003, 4), (16, 16), (7, 3), (0, 2)])
def test_partition_edges_equal_jax(n, hosts):
    parts = [t_mh.partition_edges(n, hosts, h) for h in range(hosts)]
    for h in range(hosts):
        np.testing.assert_array_equal(parts[h], j_mh.partition_edges(n, hosts, h))
    allidx = np.concatenate(parts)
    assert len(allidx) == n and len(np.unique(allidx)) == n
    sizes = [len(p) for p in parts]
    assert max(sizes) - min(sizes) <= 1
    with pytest.raises(ValueError):
        t_mh.partition_edges(n, hosts, hosts)


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_local_batcher_equals_jax_and_reassembles(hosts):
    n, gbs = 200, 16
    single = list(t_mh.LocalBatcher(n, gbs, 1, 0).epoch(seed=7))
    per_host = [list(t_mh.LocalBatcher(n, gbs, hosts, h).epoch(seed=7))
                for h in range(hosts)]
    for h in range(hosts):
        want = list(j_mh.LocalBatcher(n, gbs, hosts, h).epoch(seed=7))
        assert len(per_host[h]) == len(want) == n // gbs
        for (bi, rows), (bj, wrows) in zip(per_host[h], want):
            assert bi == bj
            np.testing.assert_array_equal(rows, wrows)
    for bi, (_, full_rows) in enumerate(single):
        parts = [per_host[h][bi][1] for h in range(hosts)]
        np.testing.assert_array_equal(np.concatenate(parts), full_rows)
        assert len(np.unique(np.concatenate(parts))) == gbs
    with pytest.raises(ValueError, match="divide"):
        t_mh.LocalBatcher(n, 10, 4, 0)


def test_global_batch_assembly_two_ranks(tmp_path):
    got = workers.run_world(workers.local_batches, 2, tmp_path, 100, 16, 3)
    want = [rows for _, rows in t_mh.LocalBatcher(100, 16, 1, 0).epoch(3)]
    for rank in got:
        assert len(rank) == len(want)
        for g, w in zip(rank, want):
            np.testing.assert_array_equal(g, w)


def test_initialize_guards(monkeypatch):
    calls = []
    monkeypatch.setattr(comm, "init_world",
                        lambda device, **kw: calls.append((device, kw)))
    # single host: a no-op whatever the world's state
    t_mh.initialize(None)
    assert calls == []
    # already up: short-circuit
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    t_mh.initialize("host:1234", 2, 0)
    assert calls == []
    # not up: the keys go through, the address as a tcp:// rendezvous
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    t_mh.initialize("host:1234", 2, 0, device="cpu")
    assert calls == [("cpu", dict(init_method="tcp://host:1234",
                                  world_size=2, rank=0))]
    with pytest.raises(ValueError, match="num_processes and process_id"):
        t_mh.initialize("host:1234")
