"""Frame-watch camera loop: robot integration without ROS.

Counterpart of `perception_tpu/camera_loop.py`, the reference's
`perception_interface` (object_recognition_node/src/perception_interface.cpp:
57-320) over the filesystem instead of ROS topics: a watcher polls a spool
directory for frame drops, builds the /localize payload (the JSON contract
of `serve.py`), dispatches it to an in-process `LocalizerService` or a
remote service's URL, and writes a detections JSON next to the frames.

    python -m perception_tpu_torch.camera_loop --spool DIR \\
        --url http://127.0.0.1:8765/localize
    python -m perception_tpu_torch.camera_loop --spool DIR \\
        --config scene.json [--warmup] [--device cuda|cpu]

Frame contract per key (any filename prefix):

    <key>-depth.png      16-bit depth PNG (required; triggers processing)
    <key>-color.png      8-bit RGB (optional)
    <key>-labels.png     8-/16-bit instance mask, 1-based (optional)
    <key>-request.json   payload overrides: depth_factor, cam_to_world,
                         pose_lists, mode, segmented_object_names,
                         table_height (optional)

    <key>-detections.json   written on completion; its existence marks
                            the frame processed (restart-safe)
    <key>-overlay.png       the pose overlay (in-process dispatch only)

The depth's units follow the request's `depth_factor` (sensor units per
metre), else the watcher's (`--depth-factor`, default 10000). PNGs are read
and written by `io.images` (no OpenCV on the machines the port runs on).
A frame that fails is retried at the next poll and recorded with an
"error" only once its files are unchanged across two failing polls: a
producer that writes non-atomically leaves a half-written PNG for a poll.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from perception_tpu_torch.io.images import read_png, write_png


class FrameWatcher:
    """Polls a spool directory and localises each new frame once."""

    def __init__(self, spool_dir: str, service=None, url: str | None = None,
                 depth_factor: float = 10000.0, poll_seconds: float = 0.5):
        if (service is None) == (url is None):
            raise ValueError("pass exactly one of service=, url=")
        self.spool_dir = spool_dir
        self.service = service
        self.url = url
        self.depth_factor = depth_factor
        self.poll_seconds = poll_seconds
        # key -> the frame files' stat snapshot at the poll its processing
        # last failed; the failure is terminal once the snapshot repeats.
        self._failed_snapshot: dict[str, tuple] = {}

    def pending_keys(self) -> list[str]:
        keys = []
        for name in sorted(os.listdir(self.spool_dir)):
            if not name.endswith("-depth.png"):
                continue
            key = name[: -len("-depth.png")]
            if not os.path.exists(self._path(key, "detections.json")):
                keys.append(key)
        return keys

    def _path(self, key: str, suffix: str) -> str:
        return os.path.join(self.spool_dir, f"{key}-{suffix}")

    def build_payload(self, key: str) -> dict:
        """The /localize request of one frame."""
        depth = read_png(self._path(key, "depth.png"))
        payload: dict = {
            "depth_image": np.asarray(depth, np.float64).tolist(),
            "depth_factor": self.depth_factor,
            "mode": "greedy",
        }
        color_path = self._path(key, "color.png")
        if os.path.exists(color_path):
            payload["color_image"] = read_png(color_path)[..., :3].tolist()
        labels_path = self._path(key, "labels.png")
        if os.path.exists(labels_path):
            payload["label_mask"] = np.asarray(read_png(labels_path),
                                               np.int64).tolist()
        req_path = self._path(key, "request.json")
        if os.path.exists(req_path):
            with open(req_path) as f:
                payload.update(json.load(f))
        return payload

    def _localize(self, payload: dict) -> dict:
        if self.service is not None:
            return self.service.handle(payload)
        import urllib.request

        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())

    def process(self, key: str) -> dict:
        t0 = time.perf_counter()
        result = self._localize(self.build_payload(key))
        result["frame"] = key
        result["latency_s"] = round(time.perf_counter() - t0, 3)
        out = self._path(key, "detections.json")
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f, indent=1)
        os.replace(tmp, out)   # atomic: consumers never see partial JSON
        self._write_overlay(key)
        return result

    def _write_overlay(self, key: str) -> None:
        """The pose overlay next to the frame (in-process dispatch only: a
        remote service serves the same image at GET /overlay.png)."""
        if self.service is None:
            return
        try:
            overlay = self.service.render_overlay()
            if overlay is not None:
                write_png(self._path(key, "overlay.png"), overlay)
        except Exception:
            pass   # visualisation must never fail the frame

    def _frame_snapshot(self, key: str) -> tuple:
        snap = []
        for suffix in ("depth.png", "color.png", "labels.png",
                       "request.json"):
            try:
                st = os.stat(self._path(key, suffix))
                snap.append((suffix, st.st_size, st.st_mtime_ns))
            except OSError:
                snap.append((suffix, None, None))
        return tuple(snap)

    def scan_once(self) -> list[str]:
        """Process every pending frame once; returns the keys finished
        (localised, or recorded as failed)."""
        done = []
        for key in self.pending_keys():
            try:
                self.process(key)
            except Exception as e:
                snap = self._frame_snapshot(key)
                if self._failed_snapshot.get(key) != snap:
                    self._failed_snapshot[key] = snap
                    continue
                self._failed_snapshot.pop(key, None)
                with open(self._path(key, "detections.json"), "w") as f:
                    json.dump({"frame": key, "error": repr(e),
                               "detections": []}, f)
            else:
                self._failed_snapshot.pop(key, None)
            done.append(key)
        return done

    def run_forever(self) -> None:
        while True:
            for key in self.scan_once():
                print(f"localised frame {key}", flush=True)
            time.sleep(self.poll_seconds)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="perception_tpu_torch.camera_loop")
    parser.add_argument("--spool", required=True, help="frame drop directory")
    parser.add_argument("--config", help="scene config (in-process "
                                         "recogniser; JSON, or YAML where "
                                         "the yaml module is installed)")
    parser.add_argument("--url", help="remote service's /localize URL")
    parser.add_argument("--depth-factor", type=float, default=10000.0)
    parser.add_argument("--poll-seconds", type=float, default=0.5)
    parser.add_argument("--warmup", action="store_true",
                        help="localise one synthetic scene before watching")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="the in-process recogniser's device")
    args = parser.parse_args(argv)

    service = None
    if args.config:
        from perception_tpu_torch.serve import (
            LocalizerService,
            recognizer_from_config,
        )

        service = LocalizerService(recognizer_from_config(args.config,
                                                          args.device))
        if args.warmup:
            dt = service.recognizer.warmup()
            print(f"warmup: scoring path ready in {dt:.1f}s", flush=True)
    elif not args.url:
        parser.error("pass --config (in-process) or --url (remote)")

    watcher = FrameWatcher(args.spool, service=service, url=args.url,
                           depth_factor=args.depth_factor,
                           poll_seconds=args.poll_seconds)
    print(f"watching {args.spool}", flush=True)
    watcher.run_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
