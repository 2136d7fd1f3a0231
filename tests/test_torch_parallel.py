"""The port's pose split across processes (`perception_tpu_torch.parallel`)
against the one-process scorer and against the JAX package's sharded
scorer on its 8-device virtual CPU mesh.

The ranks are processes of `perception_tpu_torch.parallel.run` (which
imports torch and the port only), over gloo with a file:// rendezvous under
the test's tmp_path, each on one PyTorch thread. On the box scene of
tests/test_parallel.py (10 candidates, ICP off and on; also the first 7,
which pads differently) every rank's gathered result equals the
one-process `score_pose_batch` on every field, bit for bit, and its
total_cost equals JAX's sharded total_cost.
"""

import dataclasses

import numpy as np
import pytest
import torch

from perception_tpu.parallel import dist as jdist
from perception_tpu.parallel import sharding as jsharding
from perception_tpu_torch import convert, parallel
from perception_tpu_torch.parallel import dist as pdist
from perception_tpu_torch.parallel import run, sharding
from perception_tpu_torch.pipeline.scorer import PoseScores, score_pose_batch

from tests.test_parallel import _aux_banks, _candidate_problem
from tests.test_pipeline import gt_states, make_env

COUNTS = (10, 7)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def box_batches(tmp_path_factory):
    """The box scene's candidates as the port's inputs, ICP off and on
    (saved for the ranks), with JAX's sharded total_cost for each count."""
    env = make_env()
    env.set_observation_from_states(gt_states())
    _, poses, ids, labels, totals = _candidate_problem(env)
    aux = _aux_banks(env)
    t = convert.tensor
    root = tmp_path_factory.mktemp("shard")
    batches = []
    for do_icp in (False, True):
        cfg = env._scorer_config(do_icp=do_icp)
        jax_totals = {k: np.asarray(jsharding.score_pose_batch_multichip(
            jsharding.make_pose_mesh(), env._bank_tri_verts, env._bank_tri_colors,
            env._bank_tri_valid, poses[:k], ids[:k], labels[:k], totals[:k],
            env._proj, env._scene, cfg, **aux).total_cost) for k in COUNTS}
        args = (t(env._bank_tri_verts), t(env._bank_tri_colors),
                t(env._bank_tri_valid), t(poses), t(ids).long(),
                t(labels).long(), t(totals), t(env._proj),
                convert.scene_from_jax(env._scene))
        port_aux = {k: t(v) for k, v in aux.items()}
        path = str(root / f"icp{int(do_icp)}.pt")
        run.save_batch(path, args, convert.scorer_config_from_jax(cfg),
                       **port_aux)
        batches.append((path, jax_totals))
    return batches


def _one_process(path: str, k: int) -> PoseScores:
    args, cfg, aux = run.load_batch(path)
    return score_pose_batch(*args[:3], *[x[:k] for x in args[3:7]],
                            *args[7:], cfg, **aux)


@pytest.mark.parametrize("ranks", [2, 3])
def test_gloo_ranks_match_one_process_and_jax(box_batches, ranks, tmp_path):
    """2 and 3 ranks (10 poses pad to 10 / 12, 7 to 8 / 9): every rank
    returns every pose's scores, equal to one process's on every field, and
    total_cost equal to JAX's sharded result; the padding never shows."""
    code, lines = run.launch(
        ranks, "gloo", device="cpu", inputs=[p for p, _ in box_batches],
        counts=",".join(map(str, COUNTS)), out=str(tmp_path), threads=1,
        timeout=300, rendezvous_dir=str(tmp_path))
    assert code == 0, lines
    assert len(lines) == ranks * len(box_batches) * len(COUNTS)
    assert all(l["equal_to_one_process"] for l in lines), lines
    assert {l["world_size"] for l in lines} == {ranks}
    for r in range(ranks):
        saved = torch.load(tmp_path / f"rank{r}.pt")
        for b, (path, jax_totals) in enumerate(box_batches):
            for k in COUNTS:
                got = saved[b, k]
                ref = _one_process(path, k)
                for f in dataclasses.fields(ref):
                    assert torch.equal(got[f.name], getattr(ref, f.name)), \
                        (r, b, k, f.name)
                np.testing.assert_array_equal(got["total_cost"].numpy(),
                                              jax_totals[k])
                assert (got["total_cost"] >= 0).any()
    # ICP on moves some candidates and not others: the costs differ.
    assert np.ptp(box_batches[1][1][10]) > 0


def test_padding_rows_score_minus_one(box_batches):
    """Zero poses of model 0, label 0 and total 0 (the padding) reach the
    raster's perspective divide and the ICP: every field finite, total
    -1, with ICP on; the real poses beside them score as without them."""
    args, cfg, aux = run.load_batch(box_batches[1][0])
    per = [x[:7] for x in args[3:7]]
    padded = [torch.cat([x, torch.zeros((3, *x.shape[1:]), dtype=x.dtype)])
              for x in per]
    out = score_pose_batch(*args[:3], *padded, *args[7:], cfg, **aux)
    ref = _one_process(box_batches[1][0], 7)
    for f in dataclasses.fields(out):
        v = getattr(out, f.name)
        assert torch.isfinite(v.float()).all(), f.name
        assert torch.equal(v[:7], getattr(ref, f.name)), f.name
    assert (out.total_cost[7:] == -1).all()


def test_world_size_one_calls_no_collective(box_batches, monkeypatch):
    """Without torch.distributed the mesh is this process alone: no
    collective runs and the result is score_pose_batch's own."""
    def refuse(*a, **k):
        raise AssertionError("a collective ran")

    monkeypatch.setattr(torch.distributed, "all_gather", refuse)
    mesh = pdist.make_global_pose_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    assert mesh.device == torch.device("cpu")
    path = box_batches[1][0]
    args, cfg, aux = run.load_batch(path)
    timings = {}
    got = sharding.score_pose_batch_multichip(mesh, *args, cfg,
                                              timings=timings, **aux)
    ref = _one_process(path, 10)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name))
    assert timings["gather_ms"] == 0.0 and timings["batch_ms"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_pose_mesh("cuda")


def test_exports_and_pad_to_multiple_match_jax():
    from perception_tpu import parallel as jparallel

    assert {n for n in dir(parallel) if not n.startswith("_")} >= {
        n for n in dir(jparallel) if not n.startswith("_")
        and n not in ("sharding", "dist")}
    for n in range(0, 20):
        for m in (1, 2, 3, 8):
            assert sharding.pad_to_multiple(n, m) == \
                jsharding.pad_to_multiple(n, m)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_local_pose_slice_matches_jax(world, monkeypatch):
    """Each rank's [start, end) equals JAX's for the same process count
    and index (the last ranks short or empty)."""
    import jax

    for n in (0, 1, 7, 10, 2047, 2048):
        for rank in range(world):
            monkeypatch.setattr(jax, "process_count", lambda: world)
            monkeypatch.setattr(jax, "process_index", lambda: rank)
            monkeypatch.setattr(torch.distributed, "is_initialized",
                                lambda: world > 1)
            monkeypatch.setattr(torch.distributed, "get_world_size",
                                lambda: world)
            monkeypatch.setattr(torch.distributed, "get_rank", lambda: rank)
            assert pdist.local_pose_slice(n) == jdist.local_pose_slice(n), \
                (n, world, rank)


def test_initialize_multihost_env_fallbacks(monkeypatch):
    """PT_NUM_PROCESSES, PT_COORDINATOR and PT_PROCESS_ID reach the process
    group as they reach jax.distributed.initialize; one process is a no-op;
    the backend is the caller's."""
    import jax

    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: jax_calls.append(kw))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: port_calls.append(kw))
    for var in ("PT_NUM_PROCESSES", "PT_COORDINATOR", "PT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    jdist.initialize_multihost()
    pdist.initialize_multihost("gloo")
    assert jax_calls == port_calls == []
    monkeypatch.setenv("PT_NUM_PROCESSES", "4")
    monkeypatch.setenv("PT_COORDINATOR", "node0:2345")
    monkeypatch.setenv("PT_PROCESS_ID", "3")
    jdist.initialize_multihost()
    pdist.initialize_multihost("nccl")
    assert jax_calls == [dict(coordinator_address="node0:2345",
                              num_processes=4, process_id=3)]
    assert port_calls == [dict(backend="nccl",
                               init_method="tcp://node0:2345",
                               world_size=4, rank=3)]
    monkeypatch.delenv("PT_COORDINATOR")
    jdist.initialize_multihost(process_id=1)
    pdist.initialize_multihost("gloo", process_id=1,
                               init_method="file:///shared/rendezvous")
    pdist.initialize_multihost("gloo", num_processes=2)
    assert jax_calls[-1] == dict(coordinator_address="localhost:12345",
                                 num_processes=4, process_id=1)
    assert port_calls[1:] == [
        dict(backend="gloo", init_method="file:///shared/rendezvous",
             world_size=4, rank=1),
        dict(backend="gloo", init_method="tcp://localhost:12345",
             world_size=2, rank=3)]
