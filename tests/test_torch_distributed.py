"""The port's cluster bootstrap (``parallel/distributed.py``) on the CPU.

Mirrors tests/test_distributed.py: 2 "hosts" x 2 local ranks, each rank
a process that joins the cluster from the ART_* variables (gloo, a file
store), run the sharded forward over the hosts-major mesh, and rank 0's
settings must match the one-process dense forward on the same workload.
Beside it: the mesh layout keeps every 'prims' group inside one host,
the ray slices, the deadline and failure handling of the spawned ranks,
the kernels' cross-process build lock, and conformance config 5 at
``--fast`` sizes. NCCL is not exercised here (it needs a card per rank).
"""

import multiprocessing
import os
import time

import jax
import numpy as np
import pytest
import torch

from audio_raytracer_tpu.parallel import distributed as jdist
from audio_raytracer_tpu_torch import conformance
from audio_raytracer_tpu_torch.ops.cuda import build
from audio_raytracer_tpu_torch.parallel import distributed

torch.set_num_threads(1)

RAY_COUNT = 64
PRIM_SHARDS = 2
LOCAL_RANKS = 2
RAY_SHARDS = 2  # 2 hosts x 2 local ranks / 2 prim shards
TIMEOUT = 240.0


@pytest.fixture(scope="module")
def reference():
    return distributed.dense_check_reference(RAY_COUNT, PRIM_SHARDS,
                                             RAY_SHARDS, device="cpu")


class TestTwoHostCluster:
    @pytest.mark.parametrize("backend", ["dense", "kernel"])
    def test_matches_one_process(self, reference, backend):
        got = distributed.run_two_process_check(
            ray_count=RAY_COUNT, local_ranks=LOCAL_RANKS,
            prim_shards=PRIM_SHARDS, timeout=TIMEOUT, backend=backend,
            device="cpu")
        for k in ("muffle", "reverb_strength", "reverb_volume"):
            np.testing.assert_allclose(got[k], reference[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)

    def test_reference_discriminates(self, reference):
        # A muffle saturated to 0 or 1 would match a broken sum that
        # clamps.
        assert ((reference["muffle"] > 0.0)
                & (reference["muffle"] < 1.0)).all()
        cfg, scene = distributed.check_workload(RAY_COUNT, PRIM_SHARDS,
                                                RAY_SHARDS, device="cpu")
        assert cfg.num_accum_batches == RAY_SHARDS
        for p in (scene.spheres, scene.aabbs, scene.obbs):
            assert p.count % PRIM_SHARDS == 0

    def test_a_failing_worker_fails_the_check(self):
        with pytest.raises(RuntimeError, match="worker .* failed"):
            distributed.run_two_process_check(
                ray_count=RAY_COUNT + 1, local_ranks=LOCAL_RANKS,
                prim_shards=PRIM_SHARDS, timeout=TIMEOUT, device="cpu")


class TestMeshLayout:
    @pytest.mark.parametrize("world,local,prims", [
        (4, 2, 2), (8, 4, 2), (8, 4, 4), (8, 4, 1), (2, 1, 1), (16, 8, 2)])
    def test_prims_never_cross_a_host(self, world, local, prims):
        grid = distributed.mesh_layout(world, local, prims)
        assert len(grid) == world // prims
        assert sorted(r for row in grid for r in row) == list(range(world))
        for row in grid:
            assert len(row) == prims
            assert len({r // local for r in row}) == 1

    @pytest.mark.parametrize("world,local,prims", [
        (4, 1, 2), (8, 4, 8), (6, 3, 2), (6, 4, 2)])
    def test_prims_across_hosts_are_refused(self, world, local, prims):
        with pytest.raises(ValueError):
            distributed.mesh_layout(world, local, prims)

    def test_hosts_major_like_jax(self):
        # The JAX mesh of 8 devices on one host, 2 prim shards, is the
        # same row-major grid.
        jmesh = jdist.make_distributed_mesh(prim_shards=2,
                                            devices=jax.devices()[:8])
        ids = [[d.id for d in row] for row in np.asarray(jmesh.devices)]
        assert distributed.mesh_layout(8, 8, 2) == ids

    def test_local_ray_slice_single_process(self):
        assert distributed.local_ray_slice(128) == slice(0, 128)

    def test_initialize_without_a_cluster_is_single_process(self,
                                                            monkeypatch):
        for k in ("ART_NUM_PROCESSES", "ART_PROCESS_ID", "WORLD_SIZE",
                  "RANK"):
            monkeypatch.delenv(k, raising=False)
        assert distributed.initialize(device="cpu") is False
        monkeypatch.setenv("ART_NUM_PROCESSES", "1")
        assert distributed.initialize(device="cpu") is False


# ---------------------------------------------------------------------------
# Spawned ranks: deadlines and failures
# ---------------------------------------------------------------------------


def _rank_and_world():
    return torch.distributed.get_rank(), torch.distributed.get_world_size()


def _rank_1_raises():
    if torch.distributed.get_rank() == 1:
        raise ValueError("injected failure")
    # Rank 0 waits in a collective that rank 1 never joins.
    torch.distributed.all_reduce(torch.zeros(1))


def _sleeps():
    time.sleep(60)


class TestSpawn:
    def test_results_in_rank_order(self):
        assert distributed.spawn(_rank_and_world, 3, timeout=TIMEOUT) == [
            (0, 3), (1, 3), (2, 3)]

    def test_a_failing_rank_fails_the_run(self):
        with pytest.raises(RuntimeError, match="injected failure"):
            distributed.spawn(_rank_1_raises, 2, timeout=TIMEOUT)

    def test_the_deadline_kills_every_rank(self):
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="timed out"):
            distributed.spawn(_sleeps, 2, timeout=8.0)
        assert time.monotonic() - t0 < 50.0
        assert not multiprocessing.active_children()


# ---------------------------------------------------------------------------
# The kernels' build lock across processes
# ---------------------------------------------------------------------------


def _hold_build_lock(directory, log, rounds):
    for _ in range(rounds):
        with build.build_lock(directory):
            with open(log, "a") as fh:
                fh.write(f"enter {os.getpid()}\n")
            time.sleep(0.02)
            with open(log, "a") as fh:
                fh.write(f"leave {os.getpid()}\n")


def test_build_lock_is_held_by_one_process_at_a_time(tmp_path):
    log = str(tmp_path / "log")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_hold_build_lock,
                         args=(str(tmp_path / "_build"), log, 10))
             for _ in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert all(p.exitcode == 0 for p in procs)
    lines = open(log).read().split()
    events = list(zip(lines[0::2], lines[1::2]))
    assert len(events) == 40
    assert len({pid for _, pid in events}) == 2
    # Every enter is followed by the same process's leave.
    for (a, pa), (b, pb) in zip(events[0::2], events[1::2]):
        assert (a, b) == ("enter", "leave") and pa == pb


def test_conformance_config_5_fast(capsys):
    rc = conformance.main(["--fast", "--device", "cpu", "--only", "5"])
    out = capsys.readouterr().out
    assert rc == 0 and "conformance: 1/1 PASS" in out, out
    assert "4x2 mesh == 1 process" in out, out
