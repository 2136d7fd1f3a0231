"""One run of one cell: set-up, the measured window, the traced window's
reading, the comparison with the plain reference, the result line.

The program under test is `perception_tpu_torch`: its recogniser behind its
own HTTP service (`serve.serve(recognizer, 0)` on a loopback port, in a
thread of this process), driven by one closed-loop client that posts the
frames' JSON bytes in turn. Everything one configuration, traffic mix or
metric needs is read from its file by the name BENCHMARK.json gives.
"""

from __future__ import annotations

import dataclasses
import gc
import http.client
import json
import os
import sys
import threading
import time
from pathlib import Path

from portbench import load_file

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names a run may never hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "perception_tpu")
WINDOW = "portbench.window"
# What a traffic file may set. Every mix is one closed-loop client posting
# its `frames` distinct frames in turn; a key beyond these is refused, not
# ignored.
TRAFFIC_KEYS = {"name", "mode", "frames", "why"}


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among loaded modules, compared whole:
    `perception_tpu_torch` is not `perception_tpu`."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list[dict]     # BENCHMARK.json entries this cell reports
    per_layer: list[dict]
    bench: Path = BENCH        # where its scene kind, reference and limits
                               # files are found by name


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json",
              bench: Path = BENCH) -> Cell:
    """The cell's configuration (the file BENCHMARK.json names, relative to
    its directory), traffic (traffic/<name>.json) and metric entries."""
    bm = load_json(benchmark)
    cell = next((w for w in bm["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in {Path(benchmark).name}")
    cfg_entry = next(c for c in bm["configs"] if c["name"] == cell["config"])
    config = load_json(Path(benchmark).parent / cfg_entry["file"])
    traffic = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    unknown = set(traffic) - TRAFFIC_KEYS
    if unknown:
        raise SystemExit(f"traffic {cell['traffic']!r}: keys this harness "
                         f"does not implement: {', '.join(sorted(unknown))}")

    def reports(metric) -> bool:
        return name in metric.get("workloads", [name])

    e2e = [m for m in bm["end_to_end"] if reports(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bm["per_layer"] if reports(m) and m["moves"] in moved]
    return Cell(name, config, traffic, e2e, layer, Path(bench))


def reader(metric: str, bench: Path = BENCH):
    """The `read(run)` function of metrics/<metric>.py."""
    return load_file(bench / "metrics" / f"{metric}.py",
                     "portbench_metric").read


def reference_for(cell: Cell, bank, device: str, quant=None):
    """The plain reference the configuration names (`reference`: a module
    reference/<name>.py with a `Reference` class; `env` by default)."""
    config = cell.config
    mod = load_file(cell.bench / "reference"
                    / f"{config.get('reference', 'env')}.py",
                    "portbench_reference")
    return mod.Reference(bank, config["camera"], config["perch"],
                         config["env"], device=device, quant=quant,
                         batch=config["perch"]["gpu_batch_size"])


@dataclasses.dataclass
class Request:
    frame: int
    seconds: float              # client clock: send to parsed reply
    reply: dict | None          # None: failed
    stats: dict                 # the env's EnvStats after the request
    candidates_s: float = 0.0   # traced runs: time in candidate generation


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    window_s: float
    requests: list[Request]
    previous_stats: dict        # EnvStats after the warm-up request
    peak_bytes: int
    trace: object = None        # trace.Trace (traced runs on the card)
    work: list = None           # reference Work per distinct frame
    bench: Path = BENCH

    @property
    def served(self) -> list[Request]:
        return [r for r in self.requests if r.reply is not None]

    def stat_deltas(self, field: str) -> list[float]:
        """Per served request, the increase of a cumulative EnvStats field
        since the request before it."""
        out, prev = [], self.previous_stats[field]
        for r in self.requests:
            if r.reply is not None:
                out.append(r.stats[field] - prev)
            prev = r.stats[field]
        return out


# -- the program ------------------------------------------------------------

def build_program(config: dict, mesh_list: list[dict], six_dof: bool,
                  device: str):
    """The port's recogniser over the configuration's meshes."""
    from perception_tpu_torch.core.config import (
        CameraIntrinsics,
        EnvConfig,
        PerchConfig,
    )
    from perception_tpu_torch.core.mesh import mesh_model_from_arrays
    from perception_tpu_torch.pipeline.recognizer import ObjectRecognizer

    models = []
    for m in mesh_list:
        mm = mesh_model_from_arrays(m["name"], m["verts"], m["faces"],
                                    colors=m["colors"],
                                    use_external_pose_list=six_dof)
        models.append(dataclasses.replace(mm, symmetric=m["symmetric"]))
    return ObjectRecognizer.from_models(
        models, CameraIntrinsics(**config["camera"]),
        PerchConfig(**config["perch"]), EnvConfig(**config["env"]),
        device=device)


def env_stats(recognizer) -> dict:
    return dataclasses.asdict(recognizer.env.stats)


def _post(port: int, body: bytes) -> dict | None:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/localize", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            print(f"request failed: {resp.status} {data[:500]!r}",
                  file=sys.stderr)
            return None
        return json.loads(data)
    except (OSError, http.client.HTTPException, ValueError) as exc:
        print(f"request failed: {exc!r}", file=sys.stderr)
        return None
    finally:
        conn.close()


class Spans:
    """Traced runs: host spans (name, start, end on the host clock) around
    the calls into each layer, wrapped on the recogniser's instances (a
    method the program no longer has is left unwrapped), and the candidate
    generation's host time per request. The server thread records them; the
    profiler sees only the thread that started it, so the spans are kept
    here and placed on the trace's clock by the window's range."""

    def __init__(self, recognizer):
        self.candidates_s = 0.0
        self.spans: list[tuple[str, float, float]] = []
        env = recognizer.env

        def wrap(obj, attr, name, timed=False):
            fn = getattr(obj, attr, None)
            if fn is None:
                return

            def call(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    t1 = time.perf_counter()
                    self.spans.append((name, t0, t1))
                    if timed:
                        self.candidates_s += t1 - t0
            setattr(obj, attr, call)

        wrap(env, "set_input", "env.set_input")
        wrap(env, "generate_successors_6dof", "env.candidates", timed=True)
        wrap(env, "generate_successors_3dof", "env.candidates", timed=True)
        wrap(env, "score_object_states", "env.score")
        for attr in ("localize_objects_greedy_render",
                     "localize_objects_greedy_icp", "localize_objects"):
            wrap(recognizer, attr, "recognizer.localize")

    def take(self) -> float:
        out, self.candidates_s = self.candidates_s, 0.0
        return out


# -- one run ----------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", min_requests: int = 1,
             details: dict | None = None) -> dict:
    """Run the cell once; returns the result line's object (and prints the
    comparison on standard error). The meshes and frames are made from
    `seed`. The window serves at least `min_requests`; `details` receives
    the frames, the reference's bank and answers, and the compared
    numbers."""
    import torch
    import torch.profiler

    from perception_tpu_torch.serve import serve
    from portbench import compare
    from portbench.scenes.frames import (
        encode,
        kind,
        make_frames,
        meshes,
        reference_bank,
    )

    on_card = device == "cuda"
    config, traffic = cell.config, cell.traffic
    scenes = cell.bench / "scenes"
    mesh_list = meshes(config, seed)
    bank = reference_bank(config, mesh_list, scenes)
    frames = make_frames(config, traffic, bank, seed, device, scenes)
    # The frames stay arrays while the window runs: nested lists would be
    # millions of objects that every full collection of the program's
    # garbage collector walks (a client in another process adds none).
    bodies = [encode(f) for f in frames]
    if on_card:
        from perception_tpu_torch.kernels import build
        build.library()
    recognizer = build_program(config, mesh_list, kind(config, scenes)[0],
                               device)
    server = serve(recognizer, 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    try:
        warm = _post(port, bodies[0])
        if warm is None:
            raise RuntimeError("the warm-up request failed")
        previous = env_stats(recognizer)
        spans = Spans(recognizer) if trace else None
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        prof = None
        if trace and on_card:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        requests = []
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            while True:
                f = len(requests) % len(bodies)
                t1 = time.perf_counter()
                reply = _post(port, bodies[f])
                dt = time.perf_counter() - t1
                requests.append(Request(
                    f, dt, reply, env_stats(recognizer),
                    spans.take() if spans else 0.0))
                if (time.perf_counter() - t0 >= seconds
                        and len(requests) >= min_requests):
                    break
        window_s = time.perf_counter() - t0
        if on_card:
            torch.cuda.synchronize()
        trace_data = None
        if prof is not None:
            prof.__exit__(None, None, None)
            from portbench.trace import from_profiler
            trace_data = from_profiler(prof, WINDOW, spans.spans,
                                       (t0, t0 + window_s))
            del prof
        peak = torch.cuda.max_memory_allocated() if on_card else 0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    del recognizer, server
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")

    # The reference, once per distinct frame, after the window.
    ref = reference_for(cell, bank, device)
    answers, work = [], []
    for f in frames:
        ref.work = type(ref.work)()
        answers.append(ref.answer(f))
        work.append(ref.work)
    mode = traffic["mode"]
    numbers = compare.compare(mode, [r.reply for r in requests], answers,
                              [r.frame for r in requests], bank)
    limits = compare.limits(mode, config["name"], cell.bench / "limits")
    ok, lines = compare.verdict(numbers, limits)
    if details is not None:
        details.update(frames=frames, bank=bank, answers=answers,
                       numbers=numbers, replies=[r.reply for r in requests],
                       frame_of=[r.frame for r in requests])

    run = Run(cell=cell, setup_s=setup_s, window_s=window_s,
              requests=requests, previous_stats=previous, peak_bytes=peak,
              trace=trace_data, work=work, bench=cell.bench)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"], cell.bench)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(r.reply is None for r in requests)
    result = {
        "correct": bool(ok and failed == 0 and requests),
        "attempted": len(requests), "failed": failed, "metrics": metrics,
        "device": device_info(on_card, peak, trace_data),
    }
    if trace_data is not None:
        result["breakdown"] = {"device_ops": trace_data.top_ops(),
                               "idle_gaps": trace_data.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()}
    for line in lines:
        print(line, file=sys.stderr)
    return result


def device_info(on_card: bool, peak: int, trace_data) -> dict:
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace_data is not None:
        out["busy_s"] = trace_data.busy_seconds()
        out["window_s"] = (trace_data.window[1] - trace_data.window[0]) / 1e6
    return out


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
