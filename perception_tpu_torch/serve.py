"""Localisation service: a long-lived recogniser behind a JSON/HTTP API.

Counterpart of `perception_tpu/serve.py`:

    POST /localize   {"depth_image": [[...]], "label_mask": [[...]] | null,
                      "color_image": [[[...]]] | null, "depth_factor": 100,
                      "cam_to_world": [[...4x4]] | null,
                      "segmented_object_names": [...],
                      "pose_lists": {"obj": [[x,y,z,qx,qy,qz,qw], ...]},
                      "x_min", "x_max", "y_min", "y_max", "table_height",
                      "mode": "greedy" | "tree" | "greedy_icp"}
                  -> {"detections": [{"name", "translation",
                                      "quaternion_xyzw", "transform"}],
                      "stats": {"scenes_rendered", "time", "gpu_time",
                                "decode_time", "expands", "icp_iterations",
                                "request_id"}}
    GET /status      the last /localize response
    GET /trace       with tracing on, the spans of the last 256 requests:
                     [{"request_id", "spans": [{"name", "start_ns",
                       "end_ns", "id", "parent", "request", "counters",
                       "tags"}]}], oldest first; [] with tracing off
    GET / (/index.html)  HTML status page: the last detections and the
                     overlay below them
    GET /overlay.png the last detections rendered over the last observation
                     (404 before the first localisation)

    python -m perception_tpu_torch.serve --config scene.json --port 8765 \
        [--warmup] [--device cuda|cpu] [--trace]

"greedy" localises the 6-DoF candidates of `pose_lists`; "tree" (the tree
search) and "greedy_icp" (the brute-force ICP baseline) search the 3-DoF
(x, y, yaw) grid over the region `x_min` .. `y_max` (metres, world frame) on
the table at `table_height`. A request with a `label_mask` is a 6-DoF input,
one without it a 3-DoF input. A `color_image` (0..255 RGB) reaches
`set_input`, which builds the observed Lab colours that the colour-gated
cost (`use_color_cost`) reads. `decode_time` is the seconds spent turning
the JSON lists into arrays. `icp_iterations` is the request's sum over its
scored batches of the composed ICP refiners' loop iterations (each one
association and one host read; 0 on the fused and no-ICP paths).
`request_id` numbers the process's requests; with tracing on it is the
`request` of the request's spans.

Tracing (`serve(..., trace=True)`, `--trace`; `utils.stats`): each POST is a
`service.request` span (tag `mode`; counter `error` = 1 on a failed request)
over `service.read` and `service.json` (counter `bytes`), `service.decode`
(the region `decode_time` times), the recogniser's `recognizer.localize` and
its env, scorer and search spans, and `service.reply` (`json.dumps` and the
write; `bytes`). The garbage collector's passes are `gc` spans.

The overlay blends the detected objects' render (`render_composite` of the
recogniser's last state, the direct raster kernel on the card) 0.55 over
0.45 of the observation's colour image, or of its depth colourised where
the request had no colour, truncated to uint8 as the JAX service does.

`main` reads the JAX service's config schema (`camera`, `model_bank` of
{name, path}, the PerchConfig keys at the top level, `env_params`) from
JSON, or from YAML where the `yaml` module is installed, builds the
recogniser on `--device` (the card unless "cpu"), optionally localises one
synthetic scene (`--warmup`), and prints a line once it listens.
"""

from __future__ import annotations

import argparse
import html
import json
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from perception_tpu_torch.io.images import encode_png
from perception_tpu_torch.pipeline.env import RecognitionInput
from perception_tpu_torch.utils.stats import (
    TRACE,
    next_request_id,
    set_tracing,
    span,
    tracing,
)
from perception_tpu_torch.utils.debug import colorize_depth

MODES = ("greedy", "tree", "greedy_icp")


class LocalizerService:
    def __init__(self, recognizer):
        self.recognizer = recognizer
        # The last observation and response, for the status page and the
        # overlay.
        self.last_observation: dict | None = None
        self.last_response: dict | None = None

    def handle(self, payload: dict, request_id: int | None = None) -> dict:
        """Localise one request's payload; the reply. `request_id` (default:
        the process's next) is the reply's `stats.request_id`."""
        if request_id is None:
            request_id = next_request_id()
        mode = payload.get("mode", "greedy")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
        with span("service.decode"):
            t0 = time.perf_counter()
            depth = np.asarray(payload["depth_image"], np.float64)
            label = (np.asarray(payload["label_mask"], np.int32)
                     if payload.get("label_mask") is not None else None)
            color = (np.asarray(payload["color_image"], np.float32)
                     if payload.get("color_image") is not None else None)
            cam_to_world = np.asarray(
                payload.get("cam_to_world") or np.eye(4).tolist(), np.float64)
            rin = RecognitionInput(
                depth_image=depth, color_image=color, label_mask=label,
                depth_factor=float(payload.get("depth_factor", 100.0)),
                cam_to_world=cam_to_world,
                segmented_object_names=payload.get(
                    "segmented_object_names",
                    [s.name for s in self.recognizer.specs]),
                use_external_pose_list=label is not None)
            # The 3-DoF support-surface region.
            for field in ("table_height", "x_min", "x_max", "y_min",
                          "y_max"):
                if field in payload:
                    setattr(rin, field, float(payload[field]))
            pose_lists = {k: np.asarray(v, np.float64)
                          for k, v in (payload.get("pose_lists")
                                       or {}).items()}
            decode_time = time.perf_counter() - t0
        if mode == "greedy":
            result = self.recognizer.localize_objects_greedy_render(
                rin, pose_lists)
        elif mode == "tree":
            result = self.recognizer.localize_objects(rin)
        else:
            result = self.recognizer.localize_objects_greedy_icp(rin)
        stats = self.recognizer.env.stats
        self.last_observation = {"depth": depth, "color": color,
                                 "depth_factor": rin.depth_factor}
        out = {
            "detections": [
                {
                    "name": name,
                    "translation": [pose.x, pose.y, pose.z],
                    "quaternion_xyzw": list(pose.quaternion()),
                    "transform": np.asarray(tf, float).tolist(),
                }
                for name, pose, tf in zip(result.names, result.poses,
                                          result.object_transforms)
            ],
            "stats": {
                "scenes_rendered": stats.scenes_rendered,
                "time": stats.time,
                "gpu_time": stats.gpu_time,
                "decode_time": decode_time,
                "expands": stats.expands,
                "icp_iterations": self.recognizer.env.icp_iterations,
                "request_id": request_id,
            },
        }
        self.last_response = out
        return out

    def render_overlay(self) -> np.ndarray | None:
        """The last detections composited over the last observation: RGB
        uint8 [H, W, 3], or None before the first localisation (or when the
        recogniser keeps no final state or it holds no object)."""
        state = getattr(self.recognizer, "last_state", None)
        env = getattr(self.recognizer, "env", None)
        if (state is None or env is None or self.last_observation is None
                or not state.object_states):
            return None
        obs = self.last_observation
        if obs["color"] is not None:
            base = np.asarray(obs["color"], np.float64)
        else:
            base = colorize_depth(np.asarray(obs["depth"], np.float64)
                                  / obs["depth_factor"]).astype(np.float64)
        det_depth, det_color, _ = env.render_composite(state.object_states)
        h = min(base.shape[0], det_depth.shape[0])
        w = min(base.shape[1], det_depth.shape[1])
        overlay = base[:h, :w].copy()
        mask = det_depth[:h, :w] > 0
        overlay[mask] = (0.45 * overlay[mask]
                         + 0.55 * det_color[:h, :w][mask])
        return np.clip(overlay, 0, 255).astype(np.uint8)


def status_page(service: LocalizerService) -> str:
    """The HTML status page: the last detections and the overlay."""
    resp = service.last_response
    if resp is None:
        rows = "<p>No localisation served yet. POST to /localize.</p>"
        img = ""
    else:
        rows = ("<table border=1 cellpadding=4><tr><th>object</th>"
                "<th>x</th><th>y</th><th>z</th></tr>")
        for d in resp.get("detections", []):
            t = d["translation"]
            name = html.escape(str(d["name"]))
            rows += (f"<tr><td>{name}</td><td>{t[0]:.3f}</td>"
                     f"<td>{t[1]:.3f}</td><td>{t[2]:.3f}</td></tr>")
        rows += "</table>"
        img = '<p><img src="/overlay.png" alt="pose overlay"></p>'
    return ("<html><head><title>perception_tpu_torch localizer</title>"
            "</head><body><h2>perception_tpu_torch localizer</h2>"
            f"{rows}{img}</body></html>")


def serve(recognizer, port: int = 8765, trace: bool = False) -> HTTPServer:
    """An HTTPServer on 127.0.0.1:port (0 = any free port); the caller runs
    serve_forever() and shutdown(). `trace` turns the process's tracing on
    (`utils.stats.set_tracing`); it stays on after the server closes."""
    service = LocalizerService(recognizer)
    if trace:
        set_tracing(True)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, data: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _reply(self, code: int, body: dict) -> None:
            with span("service.reply") as sp:
                data = json.dumps(body).encode()
                sp.add("bytes", len(data))
                self._send(code, data, "application/json")

        def do_POST(self):
            if self.path != "/localize":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            request_id = next_request_id()
            with span("service.request", request=request_id) as req:
                try:
                    with span("service.read") as sp:
                        body = self.rfile.read(length)
                        sp.add("bytes", len(body))
                    with span("service.json") as sp:
                        payload = json.loads(body)
                        sp.add("bytes", len(body))
                    if req:
                        req.tag("mode", payload.get("mode", "greedy"))
                    out = service.handle(payload, request_id)
                except Exception as exc:   # report errors to the client
                    req.add("error", 1)
                    self._reply(500,
                                {"error": f"{type(exc).__name__}: {exc}"})
                    return
                self._reply(200, out)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, status_page(service).encode(), "text/html")
            elif self.path == "/status":
                self._reply(200, service.last_response or {})
            elif self.path == "/trace":
                self._reply(200, TRACE.requests() if tracing() else [])
            elif self.path == "/overlay.png":
                overlay = service.render_overlay()
                if overlay is None:
                    self.send_error(404, "no localisation yet")
                    return
                self._send(200, encode_png(overlay), "image/png")
            else:
                self.send_error(404)

        def log_message(self, *args):
            pass

    return HTTPServer(("127.0.0.1", port), Handler)


def recognizer_from_config(path: str, device: str = "cuda"):
    """The ObjectRecognizer of a service config file: `camera`,
    `model_bank` [{name, path}], the PerchConfig keys, `env_params`."""
    from perception_tpu_torch.core.config import (
        CameraIntrinsics,
        EnvConfig,
        PerchConfig,
        load_config,
    )
    from perception_tpu_torch.pipeline.recognizer import (
        ModelSpec,
        ObjectRecognizer,
    )

    cfg = load_config(path)
    return ObjectRecognizer(
        [ModelSpec(name=m["name"], path=m["path"])
         for m in cfg["model_bank"]],
        CameraIntrinsics(**cfg["camera"]), PerchConfig.from_yaml_dict(cfg),
        EnvConfig.from_yaml_dict(cfg.get("env_params", {})), device=device)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="perception_tpu_torch.serve")
    parser.add_argument("--config", required=True)
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--warmup", action="store_true",
                        help="localise one synthetic scene at boot, so the "
                             "first request finds the kernels loaded")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--trace", action="store_true",
                        help="record spans of every request (GET /trace)")
    args = parser.parse_args(argv)

    recognizer = recognizer_from_config(args.config, args.device)
    if args.warmup:
        dt = recognizer.warmup()
        print(f"warmup: serving path ready in {dt:.1f}s", flush=True)
    server = serve(recognizer, args.port, trace=args.trace)
    print(f"perception_tpu_torch localizer on :{args.port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
