"""The port's tracing (`utils.stats`: `StageTimer` as the process's
recorder, `span`, `set_tracing`) and its spans in the service, env, scorer
and search, on the CPU at the service tests' sizes (tests/test_torch_serve.py:
the box scene's greedy request, the crate and post 3-DoF scene's greedy ICP
request), PyTorch on one thread."""

import dataclasses
import gc
import itertools
import json
import threading
import tracemalloc
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from perception_tpu.core.pose import CAM_TO_BODY
from perception_tpu_torch import convert
from perception_tpu_torch.pipeline.recognizer import ObjectRecognizer
from perception_tpu_torch.serve import serve
from perception_tpu_torch.utils import stats
from perception_tpu_torch.utils.stats import TRACE, StageTimer, span

from tests.test_torch_serve import (
    PCAM,
    _payload,
    _port_env,
    _port_recognizer,
    _pose_lists,
    _table_recognizer,
    jax_env,  # noqa: F401  (the fixture)
)

STATS_KEYS = {"scenes_rendered", "time", "gpu_time", "decode_time",
              "expands", "icp_iterations", "request_id"}

GREEDY_TREE = {
    ("service.request", "service.read"), ("service.request", "service.json"),
    ("service.request", "service.decode"),
    ("service.request", "recognizer.localize"),
    ("service.request", "service.reply"),
    ("recognizer.localize", "env.set_input"),
    ("env.set_input", "env.set_input.scene"),
    ("env.set_input", "env.set_input.kdtree"),
    ("recognizer.localize", "env.candidates"),
    ("recognizer.localize", "env.score"),
    ("env.score", "scorer.prepare"), ("env.score", "scorer.batch"),
    ("env.score", "scorer.results"), ("scorer.batch", "scorer.icp"),
    ("recognizer.localize", "env.argmin"),
}
GREEDY_ICP_TREE = GREEDY_TREE | {
    ("env.candidates", "env.candidates.grid"),
    ("env.candidates", "env.candidates.valid"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def tracing_off():
    """Each test starts and ends with tracing off and an empty recorder."""
    stats.set_tracing(False)
    TRACE.clear()
    yield
    stats.set_tracing(False)
    TRACE.clear()


class _Served:
    """A service on a free port, run by a thread; `post` and `get`."""

    def __init__(self, recognizer, trace):
        self.server = serve(recognizer, port=0, trace=trace)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()

    def post(self, payload):
        req = urllib.request.Request(
            f"{self.url}/localize", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    def get(self, path):
        with urllib.request.urlopen(f"{self.url}{path}", timeout=30) as resp:
            return json.loads(resp.read())


def _edges(spans: list[dict]) -> set[tuple[str, str]]:
    """(parent name, child name) of every span but the collector's."""
    names = {s["id"]: s["name"] for s in spans}
    return {(names[s["parent"]], s["name"]) for s in spans
            if s["parent"] is not None and s["name"] != "gc"}


def _named(spans: list[dict], name: str) -> list[dict]:
    return [s for s in spans if s["name"] == name]


def _traced_request(served, payload):
    """The reply and its request's spans from GET /trace."""
    out = served.post(payload)
    rid = out["stats"]["request_id"]
    kept = {r["request_id"]: r["spans"] for r in served.get("/trace")}
    return out, kept[rid]


def peak_bytes(fn, calls: int = 1000) -> int:
    """Peak bytes traced while `fn` runs `calls` times, above the start."""
    fn()
    tracemalloc.start()
    try:
        start = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for _ in itertools.repeat(None, calls):
            fn()
        return tracemalloc.get_traced_memory()[1] - start
    finally:
        tracemalloc.stop()


def test_tracing_off_records_nothing(jax_env, monkeypatch):
    """Off: no record, no gc hook, no clock read and no allocation at a
    span site; the reply has the keys it had, and request_id."""
    rec = _port_recognizer(jax_env)
    payload = _payload(jax_env, _pose_lists())
    with _Served(rec, trace=False) as served:
        first = served.post(payload)
        second = served.post(payload)
        assert served.get("/trace") == []
    assert set(first["stats"]) == STATS_KEYS
    assert second["stats"]["request_id"] > first["stats"]["request_id"]
    assert TRACE.drain() == [] and TRACE.requests() == []
    assert TRACE.counts == {}
    assert stats._on_gc not in gc.callbacks

    def site():
        with span("env.score") as sp:
            sp.add("poses", 3)

    def bare_with():
        # The interpreter's own cost of a `with` (the bound `__exit__`).
        with shared:
            pass

    shared = type(stats.NO_SPAN)()
    monkeypatch.setattr(stats.time, "perf_counter_ns", None)  # a read raises
    assert peak_bytes(site) <= peak_bytes(bare_with)
    monkeypatch.undo()

    with _Served(rec, trace=True) as served:
        traced = served.post(payload)
    assert traced["detections"] == first["detections"]
    assert set(traced["stats"]) == STATS_KEYS


def test_nesting_parents_and_request_ids():
    timer = StageTimer()
    with timer.span("outside") as outside:
        pass
    with timer.span("service.request", request=7) as root:
        with timer.span("env.score") as score:
            score.add("poses", 3)
            score.add("poses", 2)
            with timer.span("scorer.batch") as batch:
                assert [r.name for r in timer.open_spans()] == [
                    "service.request", "env.score", "scorer.batch"]
        with timer.span("env.argmin") as argmin:
            pass
    assert timer.open_spans() == []
    assert outside.record.request is None and outside.record.parent is None
    assert root.record.request == 7 and root.record.parent is None
    assert score.record.parent == root.record.id
    assert batch.record.parent == score.record.id
    assert argmin.record.parent == root.record.id
    assert {score.record.request, batch.record.request,
            argmin.record.request} == {7}
    assert score.record.counters == {"poses": 5}
    ids = [r.record.id for r in (outside, root, score, batch, argmin)]
    assert len(set(ids)) == 5
    for r in (root, score, batch):
        assert r.record.start_ns <= r.record.end_ns
    assert root.record.start_ns <= score.record.start_ns
    assert batch.record.end_ns <= score.record.end_ns <= root.record.end_ns
    drained = timer.drain()
    assert [r.name for r in drained] == [
        "outside", "scorer.batch", "env.score", "env.argmin",
        "service.request"]
    assert timer.drain() == []
    (kept,) = timer.requests()
    assert kept["request_id"] == 7 and len(kept["spans"]) == 4
    assert [r.name for r in timer.loose()] == ["outside"]
    assert timer.counts["env.score"] == 1
    assert "env.score: " in timer.summary()


def test_buffer_keeps_the_last_requests():
    timer = StageTimer()
    kept = stats.REQUESTS_KEPT
    for rid in range(1, kept + 6):
        with timer.span("service.request", request=rid):
            with timer.span("env.score"):
                pass
    with timer.span("outside"):
        pass
    requests = timer.requests()
    assert [r["request_id"] for r in requests] == list(range(6, kept + 6))
    assert all(len(r["spans"]) == 2 for r in requests)
    assert [r.name for r in timer.loose()] == ["outside"]
    assert len(timer.drain()) == 2 * (kept + 5) + 1


def test_collection_inside_a_span_is_a_generation_2_child():
    stats.set_tracing(True)
    assert stats._on_gc in gc.callbacks
    with span("env.score") as outer:
        gc.collect()
    records = TRACE.drain()
    full = [r for r in records if r.name == "gc"
            and r.counters["generation"] == 2
            and r.parent == outer.record.id]
    assert full, [(r.name, r.parent, r.counters) for r in records]
    assert outer.record.start_ns <= full[0].start_ns <= full[0].end_ns
    assert full[0].end_ns <= outer.record.end_ns
    assert "collected" in full[0].counters
    stats.set_tracing(False)
    assert stats._on_gc not in gc.callbacks


def test_greedy_request_span_tree(jax_env):
    """A greedy request through the real service: the span tree, one
    request id, the counters against EnvStats and the batch."""
    rec = _port_recognizer(jax_env)
    payload = _payload(jax_env, _pose_lists())
    with _Served(rec, trace=True) as served:
        served.post(payload)                       # warm
        before = rec.env.stats.scenes_rendered
        out, spans = _traced_request(served, payload)
    after = rec.env.stats.scenes_rendered
    assert out["detections"]
    rid = out["stats"]["request_id"]
    assert {s["request"] for s in spans} == {rid}
    assert _edges(spans) == GREEDY_TREE
    (root,) = _named(spans, "service.request")
    assert root["parent"] is None and root["tags"] == {"mode": "greedy"}
    assert "error" not in root["counters"]
    body = len(json.dumps(payload).encode())
    assert _named(spans, "service.read")[0]["counters"] == {"bytes": body}
    assert _named(spans, "service.json")[0]["counters"] == {"bytes": body}
    assert _named(spans, "service.reply")[0]["counters"]["bytes"] > 0
    (score,) = _named(spans, "env.score")
    c = score["counters"]
    batch = rec.env.perch.gpu_batch_size
    assert c["poses"] == after - before > 0
    assert c["slots"] == c["batches"] * batch
    assert len(_named(spans, "scorer.batch")) == c["batches"]
    # The fused kernel: one refinement a batch, no host loop.
    icp = _named(spans, "scorer.icp")
    assert [s["counters"] for s in icp] == [
        {"poses": batch, "iterations": 0}] * c["batches"]
    assert out["stats"]["icp_iterations"] == 0
    (cands,) = _named(spans, "env.candidates")
    assert cands["counters"]["rows"] == sum(
        len(v) for v in payload["pose_lists"].values())
    assert cands["counters"]["valid"] == c["poses"]
    # One ball query per (model, segment): each object's rows and its label.
    groups = {(name, payload["segmented_object_names"].index(name))
              for name, rows in payload["pose_lists"].items() if rows}
    assert cands["counters"]["queries"] == len(groups) == 2
    (inp,) = _named(spans, "env.set_input")
    assert inp["counters"]["points"] > 0
    for s in spans:
        assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= root["end_ns"]


def test_gicp_request_spans_its_refinement(jax_env):
    """The composed GICP refiner: each batch's `scorer.icp` span counts the
    batch's slots and its loop iterations (one host read each), and the
    reply's `stats.icp_iterations` is their sum."""
    env = _port_env(jax_env)
    rec = ObjectRecognizer.from_models(
        convert.models_from_jax(jax_env.bank.models), PCAM, env.perch,
        dataclasses.replace(env.env, icp_mode="gicp"), t_cap=16,
        device="cpu")
    payload = _payload(jax_env, _pose_lists())
    with _Served(rec, trace=True) as served:
        out, spans = _traced_request(served, payload)
    assert out["detections"]
    assert _edges(spans) == GREEDY_TREE
    (score,) = _named(spans, "env.score")
    icp = _named(spans, "scorer.icp")
    assert len(icp) == score["counters"]["batches"]
    loops = [s["counters"]["iterations"] for s in icp]
    assert [s["counters"] for s in icp] == [
        {"poses": rec.env.perch.gpu_batch_size, "iterations": n}
        for n in loops]
    assert all(0 < n <= rec.env.perch.max_icp_iterations for n in loops)
    assert out["stats"]["icp_iterations"] == sum(loops)


def test_greedy_icp_request_span_tree():
    from tests.test_torch_3dof import PAIR_REGION, TABLE

    rec, depth = _table_recognizer()
    payload = {"depth_image": depth.tolist(), "depth_factor": 100.0,
               "cam_to_world": CAM_TO_BODY.tolist(), "table_height": TABLE,
               "mode": "greedy_icp", **PAIR_REGION}
    with _Served(rec, trace=True) as served:
        before = rec.env.stats.scenes_rendered
        out, spans = _traced_request(served, payload)
    assert sorted(d["name"] for d in out["detections"]) == ["crate", "post"]
    assert _edges(spans) == GREEDY_ICP_TREE
    (root,) = _named(spans, "service.request")
    assert root["tags"] == {"mode": "greedy_icp"}
    (score,) = _named(spans, "env.score")
    c = score["counters"]
    assert c["poses"] == rec.env.stats.scenes_rendered - before > 0
    assert c["slots"] == c["batches"] * rec.env.perch.gpu_batch_size
    assert c["slots"] > c["poses"]                  # the last batch padded
    (cands,) = _named(spans, "env.candidates")
    assert cands["counters"]["valid"] == c["poses"]
    assert cands["counters"]["rows"] > cands["counters"]["valid"]


@pytest.mark.parametrize("mode", ["greedy_icp", "tree"])
def test_3dof_candidates_count_each_cell_once(mode):
    """A 3-DoF request's `env.candidates` span: `rows` the grid's (model, x,
    y, yaw) rows, `counted` the projected point counts made, one per (cell,
    model) since a cell's yaws share theirs, `valid` the rows kept."""
    from tests.test_torch_3dof import PAIR_REGION, TABLE, walk

    rec, depth = _table_recognizer()
    payload = {"depth_image": depth.tolist(), "depth_factor": 100.0,
               "cam_to_world": CAM_TO_BODY.tolist(), "table_height": TABLE,
               "mode": mode, **PAIR_REGION}
    with _Served(rec, trace=True) as served:
        _, spans = _traced_request(served, payload)
    (cands,) = _named(spans, "env.candidates")
    env = rec.env.env
    cells = (len(walk(PAIR_REGION["x_min"], PAIR_REGION["x_max"], env.res))
             * len(walk(PAIR_REGION["y_min"], PAIR_REGION["y_max"], env.res)))
    models = rec.env.bank.models
    yaws = [1 if m.symmetric else round(2 * np.pi / env.theta_res)
            for m in models]
    c = cands["counters"]
    assert cells == 56 and yaws == [8, 1]
    assert c["rows"] == cells * sum(yaws)
    assert c["counted"] == cells * len(models)
    assert 0 < c["valid"] < c["rows"]


def test_tree_request_spans_each_expansion():
    from tests.test_torch_3dof import PAIR_REGION, TABLE

    rec, depth = _table_recognizer()
    payload = {"depth_image": depth.tolist(), "depth_factor": 100.0,
               "cam_to_world": CAM_TO_BODY.tolist(), "table_height": TABLE,
               "mode": "tree", **PAIR_REGION}
    with _Served(rec, trace=True) as served:
        out, spans = _traced_request(served, payload)
    expands = _named(spans, "search.expand")
    assert len(expands) == out["stats"]["expands"] >= 2
    assert all(s["counters"]["candidates"] > 0 for s in expands)
    assert ("search.expand", "env.score") in _edges(spans)


def test_failing_request_closes_its_spans(jax_env):
    """An unknown mode: a 500 reply, the request's root closed with
    error = 1, and the serving thread's stack of open spans empty."""
    rec = _port_recognizer(jax_env)
    server = serve(rec, port=0, trace=True)
    url = f"http://127.0.0.1:{server.server_address[1]}/localize"
    body = json.dumps({**_payload(jax_env, {}), "mode": "beam"}).encode()
    errors = []

    def client():
        try:
            urllib.request.urlopen(urllib.request.Request(url, data=body),
                                   timeout=60)
        except urllib.error.HTTPError as err:
            errors.append(err.code)

    thread = threading.Thread(target=client)
    try:
        thread.start()
        server.handle_request()       # served on this thread
        thread.join(timeout=60)
        assert not thread.is_alive()
    finally:
        server.server_close()
    assert errors == [500]
    assert TRACE.open_spans() == []
    (kept,) = TRACE.requests()
    (root,) = _named(kept["spans"], "service.request")
    assert root["counters"] == {"error": 1}
    assert {s["name"] for s in kept["spans"]} >= {
        "service.read", "service.json", "service.reply"}


def test_exception_in_a_span_unwinds_the_stack():
    stats.set_tracing(True)
    with pytest.raises(KeyError):
        with span("service.request", request=stats.next_request_id()):
            with span("env.set_input"):
                raise KeyError
    assert TRACE.open_spans() == []
    records = [r for r in TRACE.drain() if r.name != "gc"]
    assert [r.counters.get("error") for r in records] == [1, 1]
    assert np.all([r.end_ns >= r.start_ns for r in records])
