"""The port's colour maths and colour-gated cost twins against the JAX
package.

Inputs come from a numpy seed. The JAX colour kernels run in interpret mode.
Tolerances:
  * Lab: the port converts in float64 and rounds once; the JAX package
    converts in float32, so values agree to 2e-3 (L*, a*, b* span ~100);
  * CIEDE2000: the port takes sqrt / sin / cos / exp in float64 rounded
    once, XLA in float32 with fused multiply-adds, so distances agree to
    2e-3; against the JAX branch with exact atan2 as well, since the port's
    polynomial atan2 is within 1e-6 rad of it;
  * cost counts: equal, on inputs whose gated distances all sit more than
    1e-2 from the threshold (checked first): the JAX kernels recover the
    winner's Lab from a bf16 hi/lo pair, exact only to ~2^-16, so a gate at
    its threshold could flip.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from perception_tpu.ops import color as jcolor
from perception_tpu.ops.pallas_cost import (
    nn_cost_fused_color_pallas,
    nn_cost_fused_color_tri_pallas,
    pack_bank_lab,
)
from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops import color as pcolor
from perception_tpu_torch.ops import cost_fused_color as pcf
from perception_tpu_torch.ops.cost import compute_costs_fused

THRESH = 18.0
RES = 0.03


def _rgb_cases(rng):
    """Random colours, a grey ramp across both knees (sRGB 0.04045 at
    ~10.3/255, XYZ 0.008856 at L* = 8), the knees themselves and the
    extremes."""
    grey = np.repeat(np.linspace(0, 255, 256)[:, None], 3, axis=1)
    knee = 0.04045 * 255
    knees = np.array([[knee, knee, knee], [knee - 1e-3] * 3, [knee + 1e-3] * 3,
                      [0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0],
                      [0, 0, 255], [9.0, 10.0, 11.0]])
    return np.concatenate([rng.uniform(0, 255, (500, 3)), grey,
                           knees]).astype(np.float32)


def test_rgb_to_lab_matches_jax():
    rgb = _rgb_cases(np.random.default_rng(0))
    ref = np.asarray(jcolor.rgb_to_lab(jnp.asarray(rgb)))
    out = pcolor.rgb_to_lab(torch.as_tensor(rgb))
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3)
    # Numpy in, the same Lab out.
    np.testing.assert_array_equal(pcolor.rgb_to_lab(rgb).numpy(), out.numpy())


def _lab_pairs(rng, n=2000):
    """Random Lab pairs, achromatic pairs (a = b = 0), achromatic against
    chromatic, and identical pairs."""
    lab1 = np.c_[rng.uniform(0, 100, n), rng.uniform(-80, 80, (n, 2))]
    lab2 = np.c_[rng.uniform(0, 100, n), rng.uniform(-80, 80, (n, 2))]
    achrom = np.c_[rng.uniform(0, 100, (50, 1)), np.zeros((50, 2))]
    lab1 = np.concatenate([lab1, achrom, achrom, lab1[:50]])
    lab2 = np.concatenate([lab2, achrom[::-1], lab2[:50], lab1[:50]])
    return lab1.astype(np.float32), lab2.astype(np.float32)


@pytest.mark.parametrize("kernel_safe", [False, True])
def test_ciede2000_matches_jax(kernel_safe):
    """The port's CIEDE2000 (the kernels' branch: polynomial atan2) against
    both of the JAX package's branches, `kernel_safe` naming the JAX one."""
    lab1, lab2 = _lab_pairs(np.random.default_rng(1))
    ref = np.asarray(jcolor.ciede2000_components(
        *(jnp.asarray(x) for x in (*lab1.T, *lab2.T)),
        kernel_safe=kernel_safe))
    out = pcolor.ciede2000_components(
        *(torch.as_tensor(np.ascontiguousarray(x)) for x in (*lab1.T, *lab2.T)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3)
    np.testing.assert_allclose(out.numpy()[-50:], 0.0, atol=1e-3)
    # The [..., 3] form gives the same distances, bit for bit.
    both = pcolor.ciede2000(torch.as_tensor(lab1),
                            torch.as_tensor(lab2)).numpy()
    np.testing.assert_array_equal(both, out.numpy())


def test_ciede2000_identical_and_achromatic():
    """Identical colours are 0 apart; achromatic pairs differ in L only and
    their distance grows with |dL|."""
    lab = torch.tensor([[50.0, 20.0, -30.0], [70.0, 0.0, 0.0]])
    d = pcolor.ciede2000(lab, lab)
    np.testing.assert_allclose(d.numpy(), 0.0, atol=1e-6)
    grey = torch.tensor([[50.0, 0.0, 0.0]] * 3)
    other = torch.tensor([[55.0, 0.0, 0.0], [60.0, 0.0, 0.0],
                          [70.0, 0.0, 0.0]])
    d = pcolor.ciede2000(grey, other).numpy()
    assert (np.diff(d) > 0).all()


def test_atan2_poly_matches_jax():
    rng = np.random.default_rng(2)
    y = np.concatenate([rng.normal(0, 50, 3000), [0, 0, 1, -1, 0, 3, -3]])
    x = np.concatenate([rng.normal(0, 50, 3000), [0, 1, 0, 0, -1, 3, -3]])
    y, x = y.astype(np.float32), x.astype(np.float32)
    ref = np.asarray(jcolor.atan2_poly(jnp.asarray(y), jnp.asarray(x)))
    out = pcolor.atan2_poly(torch.as_tensor(y), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_allclose(out, np.arctan2(y, x), atol=2e-6)


def _cost_problem(seed, n=4, p=64, s=80, m=2, t=24):
    """Clouds near their targets; half the points copy their nearest
    target's Lab (plus noise) so the gate passes as often as it fails;
    some points explain-only."""
    rng = np.random.default_rng(seed)
    tgt = rng.normal(0, 0.05, (n, s, 3)).astype(np.float32)
    tgt[..., 2] += 0.6
    tvalid = rng.random((n, s)) > 0.25
    pick = rng.integers(0, s, (n, p))
    cloud = (np.take_along_axis(tgt, pick[..., None], axis=1)
             + rng.normal(0, 0.015, (n, p, 3))).astype(np.float32)
    cvalid = rng.random((n, p)) > 0.2
    aug = rng.random((n, p)) > 0.8
    tgt_lab = np.c_[rng.uniform(0, 100, (n * s, 1)),
                    rng.uniform(-60, 60, (n * s, 2))].reshape(n, s, 3)
    bank_lab = np.c_[rng.uniform(0, 100, (m * t, 1)),
                     rng.uniform(-60, 60, (m * t, 2))].reshape(m, t, 3)
    tri_id = rng.integers(0, t, (n, p)).astype(np.int32)
    tri_id[~cvalid] = -1
    model_ids = (np.arange(n) % m).astype(np.int32)
    # Half the faces take the Lab of the target nearest some point.
    for i in range(n):
        for j in range(0, p, 2):
            bank_lab[model_ids[i], tri_id[i, j]] = (
                tgt_lab[i, pick[i, j]] + rng.normal(0, 4, 3))
    cloud_lab = np.where(tri_id[..., None] >= 0,
                         bank_lab[model_ids[:, None], np.maximum(tri_id, 0)],
                         0.0)
    f32 = np.float32
    return dict(cloud=cloud, cvalid=cvalid, aug=aug, tgt=tgt, tvalid=tvalid,
                tgt_lab=tgt_lab.astype(f32), bank_lab=bank_lab.astype(f32),
                tri_id=tri_id, model_ids=model_ids,
                cloud_lab=cloud_lab.astype(f32))


def _assert_gates_clear(pb):
    """Precondition of an exact comparison: no gated distance within 1e-2
    of the threshold."""
    t = {k: torch.as_tensor(v) for k, v in pb.items()}
    args, kw = pcf.prepare_inputs(
        t["cloud"], t["cvalid"], t["cloud_lab"], t["tgt"], t["tvalid"],
        t["tgt_lab"], RES, THRESH, t["aug"])
    cloud, cadd, clab, tgt4, tlab = args
    from perception_tpu_torch.ops.cost_fused import nearest

    dmin, win = nearest(cloud, tgt4)
    wlab = torch.gather(tlab, 1, win.clamp(max=tgt4.shape[1] - 1)[..., None]
                        .expand(-1, -1, 3))
    de = pcolor.ciede2000(wlab, clab)
    gated = (dmin <= kw["max_dist_sq"]) & (cadd == 0.0)
    assert gated.sum() > 20
    assert ((de[gated] <= THRESH).float().mean() - 0.5).abs() < 0.45
    assert ((de[gated] - THRESH).abs() > 1e-2).all()


@pytest.mark.parametrize("seed", [3, 4])
def test_color_twin_matches_pallas(seed):
    pb = _cost_problem(seed)
    _assert_gates_clear(pb)
    j = {k: jnp.asarray(v) for k, v in pb.items()}
    ref = nn_cost_fused_color_pallas(
        j["cloud"], j["cvalid"], j["cloud_lab"], j["tgt"], j["tvalid"],
        j["tgt_lab"], sensor_resolution=RES, color_distance_threshold=THRESH,
        interpret=True, cloud_explain_only=j["aug"])
    t = {k: torch.as_tensor(v) for k, v in pb.items()}
    build.reset_counts()
    out = pcf.nn_cost_fused_color(
        t["cloud"], t["cvalid"], t["cloud_lab"], t["tgt"], t["tvalid"],
        t["tgt_lab"], RES, THRESH, cloud_explain_only=t["aug"])
    assert dict(build.TWIN_CALLS) == {"cost_fused_color": 1}
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("seed", [5, 6])
def test_color_tri_twin_matches_pallas(seed):
    pb = _cost_problem(seed)
    _assert_gates_clear(pb)
    j = {k: jnp.asarray(v) for k, v in pb.items()}
    ref = nn_cost_fused_color_tri_pallas(
        j["cloud"], j["cvalid"], j["tri_id"], j["model_ids"],
        pack_bank_lab(j["bank_lab"]), j["tgt"], j["tvalid"], j["tgt_lab"],
        sensor_resolution=RES, color_distance_threshold=THRESH,
        interpret=True, cloud_explain_only=j["aug"])
    t = {k: torch.as_tensor(v) for k, v in pb.items()}
    build.reset_counts()
    out = pcf.nn_cost_fused_color_tri(
        t["cloud"], t["cvalid"], t["tri_id"], t["model_ids"], t["bank_lab"],
        t["tgt"], t["tvalid"], t["tgt_lab"], RES, THRESH,
        cloud_explain_only=t["aug"])
    assert dict(build.TWIN_CALLS) == {"cost_fused_color_tri": 1}
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_tri_twin_matches_lab_twin_given_gathered_colours():
    """The face-id form equals the Lab form fed the gathered face colours
    (bit for bit: both are the same twin arithmetic), ids outside [0, T)
    reading (0, 0, 0)."""
    pb = _cost_problem(7)
    pb["tri_id"][0, :5] = pb["bank_lab"].shape[1] + 3   # out of range
    t = {k: torch.as_tensor(v) for k, v in pb.items()}
    tri = pcf.nn_cost_fused_color_tri(
        t["cloud"], t["cvalid"], t["tri_id"], t["model_ids"], t["bank_lab"],
        t["tgt"], t["tvalid"], t["tgt_lab"], RES, THRESH)
    tri_id = pb["tri_id"]
    inside = (tri_id >= 0) & (tri_id < pb["bank_lab"].shape[1])
    lab = np.where(inside[..., None], pb["bank_lab"][
        pb["model_ids"][:, None], np.clip(tri_id, 0, None) % 24], 0.0)
    labf = pcf.nn_cost_fused_color(
        t["cloud"], t["cvalid"], torch.as_tensor(lab.astype(np.float32)),
        t["tgt"], t["tvalid"], t["tgt_lab"], RES, THRESH)
    for a, b in zip(tri, labf):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_gate_counts_against_a_direct_loop():
    """The Lab twin's three counts against a per-point Python loop over the
    definition (lowest-index winner, the gate, distinct explained
    targets)."""
    pb = _cost_problem(8, n=2, p=40, s=30)
    t = {k: torch.as_tensor(v) for k, v in pb.items()}
    out = pcf.nn_cost_fused_color(
        t["cloud"], t["cvalid"], t["cloud_lab"], t["tgt"], t["tvalid"],
        t["tgt_lab"], RES, THRESH, cloud_explain_only=t["aug"])
    for i in range(2):
        num = unexp = 0
        won = set()
        for p in range(40):
            if not pb["cvalid"][i, p]:
                continue
            d = ((pb["tgt"][i] - pb["cloud"][i, p]) ** 2).sum(axis=1)
            d = np.where(pb["tvalid"][i], d, np.inf)
            w = int(np.argmin(d))
            aug = bool(pb["aug"][i, p])
            close = d[w] <= np.float32(RES * RES)
            if not aug:
                num += 1
                unexp += not close
            if close:
                de = pcolor.ciede2000(
                    torch.as_tensor(pb["tgt_lab"][i, w]),
                    torch.as_tensor(pb["cloud_lab"][i, p])).item()
                if aug or de <= THRESH:
                    won.add(w)
                else:
                    unexp += 1
        assert [out[0][i].item(), out[1][i].item(), out[2][i].item()] == \
            [num, unexp, len(won)]


def test_compute_costs_fused_color_percentages():
    """compute_costs_fused with use_color: the gate's counts become the
    percentage costs; occluded poses get the -1 sentinel."""
    pb = _cost_problem(9)
    t = {k: torch.as_tensor(v) for k, v in pb.items()}
    occl = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    totals = torch.full((4,), 60.0)
    out = compute_costs_fused(
        t["cloud"], t["cvalid"], occl, t["tgt"], t["tvalid"], totals,
        sensor_resolution=RES, cloud_lab=t["cloud_lab"], tgt_lab=t["tgt_lab"],
        color_distance_threshold=THRESH, use_color=True)
    num, unexp, expl = pcf.nn_cost_fused_color(
        t["cloud"], t["cvalid"], t["cloud_lab"], t["tgt"], t["tvalid"],
        t["tgt_lab"], RES, THRESH)
    assert out.rendered_cost[1].item() == -1.0
    keep = torch.tensor([0, 2, 3])
    np.testing.assert_allclose(out.rendered_cost[keep].numpy(),
                               (unexp / num * 100.0)[keep].numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        out.observed_cost[keep].numpy(),
        np.clip((60.0 - expl[keep].numpy()) / 60.0 * 100.0, 0, 100),
        rtol=1e-6)
