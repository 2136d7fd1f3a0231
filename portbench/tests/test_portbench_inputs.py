"""The benchmark's inputs are made from the seed alone: the same seed gives
the same meshes, frames and candidate rows, another seed other frames; the
6-DoF rows follow the source's rule from each frame."""

import numpy as np
import pytest
import torch

from portbench.scenes.frames import (
    encode,
    make_frames,
    meshes,
    reference_bank,
)
from portbench.tests.tiny import CELLS, tiny_cell


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(cell, seed):
    ml = meshes(cell.config, seed)
    return ml, make_frames(cell.config, cell.traffic,
                           reference_bank(cell.config, ml), seed, "cpu")


@pytest.mark.parametrize("name", CELLS[:2])
def test_frames_are_deterministic_by_seed(name):
    cell = tiny_cell(name)
    seed = 2**33 + 17          # larger than 32 signed bits hold
    m1, f1 = _frames(cell, seed)
    m2, f2 = _frames(cell, seed)
    assert [encode(f) for f in f1] == [encode(f) for f in f2]
    for a, b in zip(m1, m2):
        np.testing.assert_array_equal(a["verts"], b["verts"])
    _, f3 = _frames(cell, seed + 1)
    assert [encode(f) for f in f3] != [encode(f) for f in f1]
    assert len(f3) == len(f1) == cell.traffic["frames"]


def test_candidate_rows_follow_the_masks_depth_span():
    from portbench.scenes.frames import rotation_samples

    cell = tiny_cell("ycbv6d.depth-robot")
    rule = cell.config["candidates"]
    counts = set()
    for seed in (1, 2, 3):
        _, frames = _frames(cell, seed)
        for f in frames:
            names = f["segmented_object_names"]
            assert len(set(names)) == 3
            depth = f["depth_image"] / f["depth_factor"]
            for i, name in enumerate(names):
                nz = depth[(f["label_mask"] == i + 1) & (depth > 0)]
                layers = len(np.arange(nz.min(), nz.max() + rule["resolution"],
                                       rule["resolution"]))
                rots = len(rotation_samples(name, rule["num_samples"]))
                assert len(f["pose_lists"][name]) == layers * rots
            counts.add(sum(len(v) for v in f["pose_lists"].values()))
    assert len(counts) > 1


def test_blobs_are_closed_1024_triangle_meshes():
    from portbench.harness import load_cell

    cell = load_cell("table3dof.greedyicp-robot")
    bank = reference_bank(cell.config, meshes(cell.config, 5))
    assert bank.tri_valid.sum(axis=1).tolist() == [1024] * 3
    assert bank.cullable.all()
