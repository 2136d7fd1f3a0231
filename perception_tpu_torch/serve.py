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
                                "decode_time", "expands"}}
    GET /status      the last /localize response

"greedy" localises the 6-DoF candidates of `pose_lists`; "tree" (the tree
search) and "greedy_icp" (the brute-force ICP baseline) search the 3-DoF
(x, y, yaw) grid over the region `x_min` .. `y_max` (metres, world frame) on
the table at `table_height`. A request with a `label_mask` is a 6-DoF input,
one without it a 3-DoF input. A `color_image` (0..255 RGB) reaches
`set_input`, which builds the observed Lab colours that the colour-gated
cost (`use_color_cost`) reads. `decode_time` is the seconds spent turning
the JSON lists into arrays. The /overlay.png view answers 501: it is not
ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from perception_tpu_torch.pipeline.env import RecognitionInput

MODES = ("greedy", "tree", "greedy_icp")


class LocalizerService:
    def __init__(self, recognizer):
        self.recognizer = recognizer
        self.last_response: dict | None = None

    def handle(self, payload: dict) -> dict:
        mode = payload.get("mode", "greedy")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
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
        for field in ("table_height", "x_min", "x_max", "y_min", "y_max"):
            if field in payload:
                setattr(rin, field, float(payload[field]))
        pose_lists = {k: np.asarray(v, np.float64)
                      for k, v in (payload.get("pose_lists") or {}).items()}
        decode_time = time.perf_counter() - t0
        if mode == "greedy":
            result = self.recognizer.localize_objects_greedy_render(
                rin, pose_lists)
        elif mode == "tree":
            result = self.recognizer.localize_objects(rin)
        else:
            result = self.recognizer.localize_objects_greedy_icp(rin)
        stats = self.recognizer.env.stats
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
            },
        }
        self.last_response = out
        return out


def serve(recognizer, port: int = 8765) -> HTTPServer:
    """An HTTPServer on 127.0.0.1:port (0 = any free port); the caller runs
    serve_forever() and shutdown()."""
    service = LocalizerService(recognizer)

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, body: dict) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            if self.path != "/localize":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                out = service.handle(json.loads(self.rfile.read(length)))
            except Exception as exc:   # report errors to the client
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
                return
            self._reply(200, out)

        def do_GET(self):
            if self.path == "/status":
                self._reply(200, service.last_response or {})
            elif self.path == "/overlay.png":
                self._reply(501, {"error": "/overlay.png is not ported to "
                                           "PyTorch yet"})
            else:
                self.send_error(404)

        def log_message(self, *args):
            pass

    return HTTPServer(("127.0.0.1", port), Handler)
