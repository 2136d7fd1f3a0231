"""A configuration that sets none of the optional keys (`reference`, a scene
kind of its own, limits of its own) gets, for a seed, the same request
bytes and the same reference answers and work counts as before those keys
existed: the digests below were taken from the harness before them, on the
CPU at the tests' tiny size."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.scenes.frames import (
    encode,
    make_frames,
    meshes,
    reference_bank,
)
from portbench.tests.tiny import tiny_cell

# (cell, seed) -> (sha256 of the frames' request bytes, of the answers and
# work counts), one cell of each built-in scene kind.
PINNED = {
    ("ycbv6d.depth-robot", 1017): (
        "8b1bd735925fad08371365dc1149965e57edd4055b93f8a2ee424f6a5f3499c3",
        "fef5e0a91bfc90592b4065975a634510b6d06eaf9c04dc32d77b6d44570bd9e3"),
    ("ycbv6d.depth-robot", 2**33 + 17): (
        "4d54c8cb6e5bd9d801f24346a2941fc33419f77033bdb3333e38b9151399ca57",
        "10cc48ca0fdf845d75c664dcd217c007de91421710757f7e83b87390fda33b8a"),
    ("ycbv6d.depth-robot", 3100000001): (
        "93f3e8d5ba0afb096b5295d052e69f36d44e780294d341d6ee55be439cd7a1ac",
        "3474e95e0ea2c1f105b8dfb703c6721d120688cc9890af85acf654b6b490ab40"),
    ("table3dof.greedyicp-robot", 1017): (
        "853b2e0414292bb6706e94fa1d68030cafdfaa1bd3d8474a55c11343fb16e1ec",
        "e65416e5a819c0d0904b693b243155dae3ff0135867bbd352d009eb28f3eb978"),
    ("table3dof.greedyicp-robot", 2**33 + 17): (
        "75bc4be2bcf7aa66a4cdf5ff71194214a60ac8afd191ad1a0fdc67c66089a8e1",
        "76377a6a01ed560f838e0063deaf437ffa2a891558490440f26ed4f7b15731e0"),
    ("table3dof.greedyicp-robot", 3100000001): (
        "826c13ab4f389efb48ce83a3fb4fe6205539d8cdfb302ed5d72940e5a5852546",
        "980a76417faa4817a5c99616ff4bf6bb3de2b676873cdcef1bb3cfd88164d923"),
    ("table3dof.tree-robot", 1017): (
        "b5d0796a00a6485d329bd48eba11c00e83fe6cd2522ec24b3820114e1d968d4d",
        "bedb823175ecc116135a1675e283b2321aaf476d750607ad5963b8907eec093a"),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames_digest(frames) -> str:
    h = hashlib.sha256()
    for f in frames:
        h.update(encode(f))
    return h.hexdigest()


def answers_digest(answers, work) -> str:
    h = hashlib.sha256()

    def arr(a):
        h.update(np.ascontiguousarray(a, np.float64).tobytes())

    def scored(su):
        h.update(repr((dataclasses.astuple(su.cand), su.cost, su.target,
                       su.source)).encode())
        arr(su.world)

    for ans, w in zip(answers, work):
        h.update(repr((ans.names, ans.keys)).encode())
        for p in ans.poses:
            arr(p)
        for key in sorted(ans.scored):
            h.update(repr(key).encode())
            for su in ans.scored[key]:
                scored(su)
        for key in sorted(ans.best):
            scored(ans.best[key])
        h.update(repr(dataclasses.astuple(w)).encode())
    return h.hexdigest()


def digests(cell, seed, reference):
    ml = meshes(cell.config, seed)
    bank = reference_bank(cell.config, ml)
    frames = make_frames(cell.config, cell.traffic, bank, seed, "cpu")
    ref = reference(cell, bank)
    answers, work = [], []
    for f in frames:
        ref.work = type(ref.work)()
        answers.append(ref.answer(f))
        work.append(ref.work)
    return frames_digest(frames), answers_digest(answers, work)


@pytest.mark.parametrize("name,seed", list(PINNED))
def test_no_new_key_moves_frames_answers_or_work(name, seed):
    cell = tiny_cell(name)
    got = digests(cell, seed,
                  lambda c, bank: harness.reference_for(c, bank, "cpu"))
    assert got == PINNED[name, seed]
