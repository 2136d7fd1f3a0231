"""PERCH 2.0's GICP refinement in the port (`icp_mode` "gicp"): its scores
against the benchmark's plain GICP reference, the configured iteration
count passed through, and the loop iterations a reply reports.

The scorer comparison runs both sides on the CPU, on one thread, at the
benchmark's tiny size (160x120, stride 4, ROI 16) over random blobs and
Kinect-degraded frames made from each seed, at the configuration's 150
iterations, in batches of 16 slots whose last batch is padded. Each side's
refinement sums the same batched products over the same slot count, so
they round alike: costs are compared exactly, and the adjusted poses, each
taken to the world frame through a quaternion as the service's replies
are, within 1e-6 mm (float64 rounding of the conversion, ~1e-13 mm)."""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from perception_tpu_torch.pipeline import scorer
from perception_tpu_torch.pipeline.env import RecognitionInput
from perception_tpu_torch.serve import LocalizerService
from portbench import compare, harness
from portbench.reference.geometry import Candidate, Pose
from portbench.scenes import frames, sensor
from portbench.tests.tiny import tiny

from tests.test_torch_serve import jax_env  # noqa: F401  (the fixture)

CELL = "ycbv6d-gicp-kinect.depth-robot"
BATCH = 16
# Corner displacement (mm) allowed between the two sides' adjusted poses.
POSE_MM = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread: beside the other test workers, several
    intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cell() -> harness.Cell:
    """The cell at the tiny size, over three random 256-triangle blobs."""
    cell = tiny(harness.load_cell(CELL))
    cfg = cell.config
    cfg["models"] = {"kind": "bumpy", "names": ["blob_a", "blob_b", "blob_c"],
                     "radii": [0.045, 0.055, 0.05], "n_seg": 16,
                     "n_rings": 10}
    cfg["perch"]["gpu_batch_size"] = BATCH
    cfg["scene"]["min_visible_pixels"] = 150
    return cell


def _frame(cfg, bank, seed):
    rng = np.random.default_rng([seed, 19])
    _, depth, label, trio = frames.place_6dof(cfg, bank, rng, "cpu")
    depth = sensor.KINECT.apply_depth(depth, rng)
    frame = frames.request_6dof(cfg, "greedy", np.rint(depth * 1000.0),
                                label, trio)
    # A seeded dozen of each object's rows: three batches, the last padded.
    frame["pose_lists"] = {
        name: rows[np.sort(rng.choice(len(rows), min(12, len(rows)),
                                      replace=False))]
        for name, rows in frame["pose_lists"].items()}
    return frame


@pytest.mark.parametrize("seed", [3, 1017, 2**31 + 5])
def test_gicp_scores_match_the_plain_reference(seed):
    cell = _cell()
    cfg = cell.config
    mesh_list = frames.meshes(cfg, seed)
    bank = frames.reference_bank(cfg, mesh_list)
    frame = _frame(cfg, bank, seed)

    env = harness.build_program(cfg, mesh_list, True, "cpu").env
    env.set_input(RecognitionInput(
        depth_image=frame["depth_image"].astype(np.float64),
        label_mask=frame["label_mask"], depth_factor=frame["depth_factor"],
        cam_to_world=frame["cam_to_world"],
        segmented_object_names=frame["segmented_object_names"]))
    assert env._scorer_config().icp_mode == "gicp"
    states = env.generate_successors_6dof(frame["pose_lists"])
    got = env.score_object_states(states, do_icp=True)

    ref = harness.reference_for(cell, bank, "cpu")
    ref.set_input(frame)
    names = frame["segmented_object_names"]
    models = [m.name for m in bank.models]
    cands = [Candidate(models.index(name), Pose(*row[:7]),
                       names.index(name) + 1)
             for name, rows in frame["pose_lists"].items() for row in rows]
    want = ref.score([c for c in cands if ref.valid_6dof(c)], do_icp=True)

    assert 2 * BATCH < len(got) == len(want) < 3 * BATCH
    assert env.icp_iterations > 0
    c2w = frame["cam_to_world"]
    for su, w in zip(got, want):
        assert (su.state.id, su.state.segmentation_label_id) == (
            w.cand.model, w.cand.label)
        assert (su.cost, su.target_cost, su.source_cost) == (
            w.cost, w.target, w.source)
        pre = bank.models[w.cand.model].preprocessing
        world = Pose.from_matrix(c2w @ su.adjusted_pose_cam.astype(
            np.float64) @ np.linalg.inv(pre)).transform()
        corners = compare._corners(bank.models[w.cand.model])
        assert compare.corner_gap_mm(world, w.world, corners) <= POSE_MM


@pytest.mark.parametrize("iterations", [10, 20, 60, 61, 150])
def test_scorer_config_passes_the_iteration_count_through(jax_env,
                                                          iterations):
    """The configured count: 60 or fewer alike in both packages (above 60
    the JAX package's env caps it and the port's does not), and nothing
    else of the scorer's configuration moves with it."""
    from tests.test_torch_serve import _port_env

    jenv = copy.copy(jax_env)
    jenv.perch = dataclasses.replace(jax_env.perch,
                                     max_icp_iterations=iterations)
    env = _port_env(jenv)
    env._input = RecognitionInput(depth_image=None)
    got = env._scorer_config()
    assert got.icp_max_iterations == iterations
    assert jenv._scorer_config().icp_max_iterations == min(iterations, 60)
    env.perch = dataclasses.replace(env.perch, max_icp_iterations=20)
    assert dataclasses.replace(got, icp_max_iterations=20) == (
        env._scorer_config())


@pytest.mark.parametrize("mode", ["gicp", "fused"])
def test_reply_counts_the_loop_iterations_of_every_batch(mode, monkeypatch):
    """`stats.icp_iterations`: the request's batches' loop counts summed
    (each count the refiner's own `loops`), anew for each request; 0 on
    the fused kernel's path."""
    seed = 29
    cell = _cell()
    cfg = cell.config
    cfg["env"]["icp_mode"] = mode
    mesh_list = frames.meshes(cfg, seed)
    bank = frames.reference_bank(cfg, mesh_list)
    service = LocalizerService(
        harness.build_program(cfg, mesh_list, True, "cpu"))
    loops = []
    gicp = scorer.icp_gicp_batch

    def counted(*args, **kwargs):
        out = gicp(*args, **kwargs)
        loops.append(out.loops)
        return out
    monkeypatch.setattr(scorer, "icp_gicp_batch", counted)
    for k in range(2):
        del loops[:]
        frame = _frame(cfg, bank, seed + k)
        reply = service.handle(json.loads(frames.encode(frame)))
        assert reply["detections"]
        assert reply["stats"]["icp_iterations"] == sum(loops)
        if mode == "fused":
            assert loops == []
            continue
        assert len(loops) == 3 and reply["stats"]["icp_iterations"] > 0
        assert all(0 < n <= cfg["perch"]["max_icp_iterations"]
                   for n in loops)


def test_the_card_graph_replays_the_eager_loop():
    """On the card each GICP iteration is a replay of a CUDA graph captured
    once a call: the same kernels in the same order as the eager loop, so
    every output is equal bit for bit, for the first capture (after its
    eager warm-up) and for later ones sharing its memory pool, and the
    loop stops as the eager one does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perception_tpu_torch.ops import icp

    gen = torch.Generator().manual_seed(41)
    n, p, s = 48, 64, 96

    def clouds(shift):
        tgt = torch.rand((n, s, 3), generator=gen) * 0.1 + torch.tensor(
            [0.0, 0.0, 0.7])
        src = tgt[:, :p] + shift + 0.002 * torch.randn(
            (n, p, 3), generator=gen)
        out = (src, torch.rand((n, p), generator=gen) > 0.1,
               icp.cloud_normals(src, torch.ones((n, p), dtype=torch.bool)),
               tgt, torch.rand((n, s), generator=gen) > 0.1,
               icp.cloud_normals(tgt, torch.ones((n, s), dtype=torch.bool)))
        return [t.cuda() for t in out]

    for shift, iterations in ((0.01, 150), (0.004, 150), (0.02, 7)):
        args = clouds(torch.tensor([shift, -shift, shift / 2]))
        kw = dict(max_iterations=iterations, crop_k=64)
        want = icp.icp_gicp_batch(*args, graph=False, **kw)
        got = icp.icp_gicp_batch(*args, **kw)
        assert got.loops == want.loops
        for name in ("delta", "fitness", "rmse", "iterations"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert icp._CAPTURES["cuda:0"].last is not None
