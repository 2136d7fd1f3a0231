"""The colour cost kernels' cull (`csrc/cost_fused_color.cu` over
`csrc/cost_cull.cuh`), emulated in plain PyTorch, against their twins.

Per pose the kernels compact the valid targets (w == 0) and, chunk by chunk
of CHUNK points, the valid points (cadd <= 0), both in ascending order; they
cut each chunk's compacted points into groups of GROUP consecutive points,
take each group's bounding box and keep, per group, the targets whose
per-axis gap g to the box has g_x^2 + g_y^2 + g_z^2 <= res^2 (float32, no
margin). Each point scans only its group's survivors in ascending index
order with a strict '<', and a close real point then runs the CIEDE2000
gate on its winner. The emulation does the same in the same float32 order
and returns (dmin, winner) per point: for every close valid point they must
be the dense scan's (`cost_fused.nearest`), and `_gated_counts` on them must
give each twin's three counts exactly. Both forms (the Lab form at the
colour full-frame batch, the face-id form at the colour ROI batch) run on
the bench's own inputs, on adversarial poses (no valid target, no valid
point, only explain-only points, targets at res and one ulp either side
along an axis and a diagonal, every target duplicated with the copy's Lab
failing the gate where the original's passes and the reverse, face ids -1
and >= T), at N = 1, at P = 77 / S = 45 and at a P of several chunks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from perception_tpu_torch.eval.bench_scene import build_bench_problem
from perception_tpu_torch.ops import cost
from perception_tpu_torch.ops import cost_fused as cf
from perception_tpu_torch.ops import cost_fused_color as ccf
from perception_tpu_torch.ops.color import ciede2000_components

GROUP = 16                 # csrc/cost_cull.cuh kGroup
CHUNK = 2048               # csrc/cost_cull.cuh kChunk, at S = 256


@dataclasses.dataclass(frozen=True)
class Form:
    full_frame: bool      # the batch scored without an ROI (roi_size=0)
    wrapper: str          # the ops/cost wrapper the batch calls
    prepare: object
    twin: object
    fields: tuple         # names of the prepared arguments
    per_point: tuple      # those with one row per cloud point


FORMS = {
    "face ids (colour ROI)": Form(
        False, "nn_cost_fused_color_tri", ccf.prepare_inputs_tri,
        ccf.nn_cost_fused_color_tri_twin,
        ("cloud", "cadd", "tri", "mids", "bank_lab", "tgt4", "tlab"),
        ("cloud", "cadd", "tri")),
    "Lab (colour full frame)": Form(
        True, "nn_cost_fused_color", ccf.prepare_inputs,
        ccf.nn_cost_fused_color_twin, ("cloud", "cadd", "lab", "tgt4", "tlab"),
        ("cloud", "cadd", "lab")),
}
CASES = ["bench", "edges", "edges N=1", "P=77 S=45", "large P"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bench_calls():
    """Per form, the prepared inputs the colour scoring batch hands the
    kernel (bumpy models at 256 triangles, 48 poses, CPU): the colour ROI
    batch, and the same problem scored over the full frame."""
    bp = build_bench_problem(n_poses=48, t_cap=256, model_kind="bumpy1024",
                             use_color=True, device="cpu")
    out = {}
    for name, form in FORMS.items():
        cfg = (dataclasses.replace(bp.cfg, roi_shape=None) if form.full_frame
               else bp.cfg)
        args, kwargs = bp.first_call(cost, form.wrapper, cfg=cfg)
        out[name] = form.prepare(*args, **kwargs)
    return out


def _fields(form, args) -> dict:
    return dict(zip(FORMS[form].fields, args))


def _args(form, f: dict) -> tuple:
    return tuple(f[k].contiguous() for k in FORMS[form].fields)


def _rendered_lab(f: dict) -> torch.Tensor:
    """Each point's rendered Lab as the kernel reads it (zeros for a face id
    outside [0, T))."""
    if "lab" in f:
        return f["lab"]
    t = f["bank_lab"].shape[1]
    tri = f["tri"].long()
    lab = f["bank_lab"][f["mids"].long()[:, None], tri.clamp(0, t - 1)]
    return torch.where(((tri >= 0) & (tri < t))[..., None], lab, 0.0)


def _ulp_steps(v: np.ndarray, steps: int) -> np.ndarray:
    """The nonzero entries of v moved by `steps` float32 ulps away from zero
    (towards it if steps < 0)."""
    out = v.copy()
    for _ in range(abs(steps)):
        out = np.where(out == 0, out, np.nextafter(
            out, np.where(out > 0, np.inf, -np.inf) if steps > 0 else 0.0,
            dtype=np.float32))
    return out.astype(np.float32)


def _boundary_rows(points: torch.Tensor, radius: float) -> torch.Tensor:
    """Targets at `radius` from each of 8 points, along an axis and along the
    diagonal, exactly and one ulp either side (two per point, mirrored)."""
    axis = np.array([radius, 0, 0], np.float32)
    diag = np.full(3, radius / np.sqrt(3.0), np.float32)
    offs = [_ulp_steps(o, k) for o in (axis, diag) for k in (0, 1, -1)]
    offs += [np.array([0, -radius, 0], np.float32),
             np.array([0, 0, radius], np.float32)]
    rows = [torch.stack([points[k] + torch.as_tensor(o),
                         points[k] - torch.as_tensor(o)])
            for k, o in enumerate(offs)]
    return torch.cat(rows)


def _edge_fields(form, args, kw) -> dict:
    """Seven bench poses made adversarial: 0 no valid target, 1 no valid
    point, 2 only explain-only points, 3 targets at res +-1 ulp from its real
    points, 4 / 5 every target twice with one rendered Lab for the whole
    pose, the original's Lab passing the gate and the copy's failing (4) or
    the reverse (5), 6 face ids -1, T and T + 7 on its real points (zero Lab
    in the Lab form)."""
    f = _fields(form, args)
    keep = torch.nonzero(((f["cadd"] == 0).sum(dim=1) > 64)
                         & (f["tgt4"][..., 3] == 0).any(dim=1)).flatten()[:7]
    assert len(keep) == 7
    f = {k: v if k == "bank_lab" else v[keep].clone() for k, v in f.items()}
    real = f["cadd"] == 0.0
    f["tgt4"][0, :, 3] = float("inf")
    f["cadd"][1] = float("inf")
    f["cadd"][2] = torch.where(f["cadd"][2] <= 0, -1.0, float("inf"))
    if "tri" in f:
        f["tri"][1:3] = -1                           # as prepare_inputs_tri
    first = torch.nonzero(real[3]).flatten()[:8]
    f["tgt4"][3, :16, :3] = _boundary_rows(f["cloud"][3, first],
                                           float(np.sqrt(kw["max_dist_sq"])))
    f["tgt4"][3, :16, 3] = 0.0
    f["tlab"][3, :16:2] = _rendered_lab(f)[3, first]   # these pass
    for i, orig_passes in ((4, True), (5, False)):
        f["tgt4"][i, 1::2] = f["tgt4"][i, 0:-1:2]
        if "tri" in f:
            face = int(f["tri"][i][real[i]][0])
            f["tri"][i] = torch.where(real[i], face, -1)
            lab0 = f["bank_lab"][f["mids"][i], face]
        else:
            lab0 = f["lab"][i][real[i]][0].clone()
            f["lab"][i] = lab0
        far = lab0 + torch.tensor([40.0 if lab0[0] < 50 else -40.0, 30.0,
                                   -30.0])
        assert ciede2000_components(*lab0, *far) > kw["thresh"]
        passes, fails = (0, 1) if orig_passes else (1, 0)
        f["tlab"][i, passes::2] = lab0
        f["tlab"][i, fails::2] = far
    rows = torch.nonzero(real[6]).flatten()
    if "tri" in f:
        t = f["bank_lab"].shape[1]
        for k, bad in enumerate((-1, t, t + 7)):
            f["tri"][6, rows[k::3]] = bad
    else:
        f["lab"][6, rows[::3]] = 0.0
    return f


def _poses(form, f: dict, sel, per_point) -> dict:
    """f cut to the poses `sel`, with per_point applied to every per-point
    tensor (cloud, cadd, Lab or face ids) after the cut."""
    out = {k: v if k == "bank_lab" else v[sel] for k, v in f.items()}
    return {**out, **{k: per_point(out[k]) for k in FORMS[form].per_point}}


def _case(form, case, bench_calls):
    args, kw = bench_calls[form]
    if case == "bench":
        return args, kw
    f = _edge_fields(form, args, kw)
    if case == "edges N=1":
        f = _poses(form, f, slice(4, 5), lambda a: a)
    elif case == "P=77 S=45":
        f = _poses(form, f, slice(None), lambda a: a[:, :77])
        f["tgt4"], f["tlab"] = f["tgt4"][:, :45], f["tlab"][:, :45]
    elif case == "large P":
        # Poses 3-4 with P = 15000 points (7.3 chunks): each pose's points
        # repeated, each copy of the cloud shifted by 3 mm along x, then cut.
        reps, p = 12, f["cloud"].shape[1]
        f = _poses(form, f, slice(3, 5), lambda a: a.repeat(
            1, reps, *([1] * (a.dim() - 2)))[:, :15000])
        shift = (torch.arange(15000) // p).float() * 0.003
        f["cloud"] = f["cloud"] + shift[:, None] * torch.tensor([1.0, 0, 0])
    return _args(form, f), kw


def _emulate(cloud, cadd, tgt4, max_dist_sq, last_tie=False):
    """The kernels' compacted, chunked group-box cull and ascending scan:
    (dmin [N, P], winner [N, P]) per point, (inf, 0) where a point is not
    staged or keeps no target; and the (point, target) pairs it kept, the
    dense pairs, and the pairs with d <= res^2 that it dropped. last_tie
    keeps the highest index among equal minima instead of the lowest."""
    n, p, _ = cloud.shape
    inf = float("inf")
    dmin = torch.full((n, p), inf)
    win = torch.zeros((n, p), dtype=torch.long)
    kept = dropped = 0
    for i in range(n):
        tidx = torch.nonzero(tgt4[i, :, 3] == 0.0).flatten()
        vidx = torch.nonzero(cadd[i] <= 0.0).flatten()
        nv, nt = len(vidx), len(tidx)
        if nv == 0 or nt == 0:
            continue
        t, c = tgt4[i, tidx, :3], cloud[i, vidx]
        # Groups of GROUP consecutive compacted points within a chunk of
        # CHUNK points, and their boxes (fminf / fmaxf skip a NaN).
        part = vidx // CHUNK
        rank = torch.arange(nv) - torch.searchsorted(vidx, part * CHUNK)
        gid = torch.unique(part * (CHUNK // GROUP) + rank // GROUP,
                           return_inverse=True)[1]
        index = gid[:, None].expand(-1, 3)
        n_groups = int(gid.max()) + 1
        lo = torch.full((n_groups, 3), inf).scatter_reduce(
            0, index, torch.where(torch.isnan(c), inf, c), "amin")
        hi = torch.full((n_groups, 3), -inf).scatter_reduce(
            0, index, torch.where(torch.isnan(c), -inf, c), "amax")
        g = torch.fmax(torch.fmax(lo[:, None] - t[None], t[None] - hi[:, None]),
                       torch.zeros(()))                            # [G, nt, 3]
        keep = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]
                + g[..., 2] * g[..., 2]) <= max_dist_sq
        keep = keep[gid]                                           # [nv, nt]
        dx = t[None, :, 0] - c[:, None, 0]
        dy = t[None, :, 1] - c[:, None, 1]
        dz = t[None, :, 2] - c[:, None, 2]
        d = dx * dx + dy * dy + dz * dz                            # [nv, nt]
        kept += int(keep.sum())
        dropped += int(((d <= max_dist_sq) & ~keep).sum())
        # A strict '<' over the survivors in ascending order: the lowest
        # surviving index attaining the minimum (a NaN never wins).
        ds = torch.where(keep & ~torch.isnan(d), d, inf)
        dm = ds.amin(dim=1)
        hit = (ds == dm[:, None]).to(torch.int8)
        pick = (nt - 1 - torch.argmax(hit.flip(1), dim=1) if last_tie
                else torch.argmax(hit, dim=1))
        dmin[i, vidx] = dm
        win[i, vidx] = torch.where(dm < inf, tidx[pick], 0)
    return dmin, win, (kept, n * p * tgt4.shape[1], dropped)


def _counts(form, args, kw, dmin, win):
    f = _fields(form, args)
    return torch.stack(ccf._gated_counts(
        f["cadd"], dmin, win, _rendered_lab(f), f["tlab"],
        f["tgt4"].shape[1], kw["max_dist_sq"], kw["thresh"]), dim=1)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("form", list(FORMS))
def test_color_cull_keeps_the_dense_winner_and_counts(form, case,
                                                      bench_calls):
    args, kw = _case(form, case, bench_calls)
    f = _fields(form, args)
    cloud, cadd, tgt4 = f["cloud"], f["cadd"], f["tgt4"]
    mds = kw["max_dist_sq"]
    if case == "large P":
        assert cloud.shape[1] > 7 * CHUNK
    dmin, win, (kept, dense, dropped) = _emulate(cloud, cadd, tgt4, mds)
    # (a) Every close valid point keeps the dense (dmin, winner).
    dref, wref = cf.nearest(cloud, tgt4)
    close = (dref <= mds) & (cadd <= 0.0)
    assert torch.equal((dmin <= mds) & (cadd <= 0.0), close)
    assert torch.equal(dmin[close], dref[close])
    assert torch.equal(win[close], wref[close])
    assert dropped == 0                  # no close pair leaves its group
    # (b) The gate on the emulated winners gives the twin's counts.
    twin = torch.stack(FORMS[form].twin(*args, **kw), dim=1)
    torch.testing.assert_close(_counts(form, args, kw, dmin, win), twin,
                               rtol=0, atol=0)
    gated = close & (cadd == 0.0)
    assert gated.any()
    if case == "bench":
        assert (twin[:, 2] > 0).any() and (twin[:, 1] > 0).any()
        assert kept < 0.15 * dense       # the cull does cull
    elif case == "edges":
        assert twin[0, 2] == 0 and twin[0, 1] == twin[0, 0] > 0  # no target
        assert twin[1].tolist() == [0.0, 0.0, 0.0]               # no point
        assert twin[2, 0] == 0 and twin[2, 1] == 0 and twin[2, 2] > 0
    if case in ("edges", "edges N=1"):
        # The ties decide the gate: keeping the last of equal minima
        # changes the counts of the duplicated poses.
        dl, wl, _ = _emulate(cloud, cadd, tgt4, mds, last_tie=True)
        assert not torch.equal(_counts(form, args, kw, dl, wl), twin)


@pytest.mark.parametrize("form", list(FORMS))
def test_color_edges_exercise_the_boundary_and_the_gate(form, bench_calls):
    """Pose 3's targets straddle res^2 in the kernels' own arithmetic; the
    tied poses have close real points that pass the gate (4) and that fail
    it (5) on the lowest-index winner."""
    args, kw = _case(form, "edges", bench_calls)
    f = _fields(form, args)
    cloud, cadd, tgt4 = f["cloud"], f["cadd"], f["tgt4"]
    first = torch.nonzero(cadd[3] == 0).flatten()[:8]
    d = ((tgt4[3, :16, :3] - cloud[3, first].repeat_interleave(2, dim=0))
         ** 2)
    d = d[:, 0] + d[:, 1] + d[:, 2]
    assert (d <= kw["max_dist_sq"]).any() and (d > kw["max_dist_sq"]).any()
    twin = torch.stack(FORMS[form].twin(*args, **kw), dim=1)
    dref, _ = cf.nearest(cloud, tgt4)
    gated = ((dref <= kw["max_dist_sq"]) & (cadd == 0.0)).sum(dim=1)
    # Pose 4: every gated point passes; pose 5: every gated point fails.
    assert gated[4] > 0 and gated[5] > 0
    assert twin[4, 1] == twin[4, 0] - gated[4]
    assert twin[5, 1] == twin[5, 0]


def test_kernel_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """The cull lives in csrc/cost_cull.cuh: an edit there names a new
    kernel library, so a cached build of the old header is not loaded."""
    from perception_tpu_torch.kernels import build

    for path in build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build._source_hash()
    header = tmp_path / "cost_cull.cuh"
    header.write_text(header.read_text() + "\n")
    assert build._source_hash() != before
