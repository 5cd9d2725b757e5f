"""Stdlib HTTP/JSON front end over the micro-batching ``InferenceEngine``
(counterpart of the reference package's ``serving/server.py``).

``ThreadingHTTPServer`` gives one OS thread per connection; each parses
JSON and blocks on an engine future, and the batching lives in the engine.

Endpoints::

    GET  /healthz              -> {"ok": true, "model", "img_size", "key_len"}
    GET  /v1/stats             -> engine.stats()
    POST /v1/generate          {"seed"?: int, "key_bits"?: [0/1...], "user"?: name,
                                "encoding"?: "png_b64"|"float_list", "return_latent"?: bool}
    POST /v1/attribute         {"image_npy_b64": b64(np.save bytes)} or
                               {"image": [[[...]]] float [-1,1] HWC}
    POST /v1/identify          same body as /v1/attribute; needs a registry

Bad input answers 400, a request the server is not set up for (no
registry, attribution off: ``EngineMisconfigured``) 501,
``EngineUnavailable`` 503, and any other failure (a kernel's launch error,
out of memory) 500.
"""

from __future__ import annotations

import base64
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict

import numpy as np

from ..utils.image import encode_png, make_image_np
from .engine import EngineMisconfigured, EngineUnavailable, InferenceEngine


def _png_b64(img_float_hwc: np.ndarray) -> str:
    """float [-1, 1] HWC -> base64 PNG."""
    u8 = make_image_np(img_float_hwc)
    return base64.b64encode(encode_png(u8)).decode("ascii")


def _finite(x: float):
    """JSON has no Infinity/NaN: a one-user registry gives margin=inf and a
    degenerate solve a NaN loss; both go out as null."""
    x = float(x)
    return x if np.isfinite(x) else None


def _decode_image(body: Dict[str, Any], img_size: int) -> np.ndarray:
    if "image_npy_b64" in body:
        arr = np.load(io.BytesIO(base64.b64decode(body["image_npy_b64"])), allow_pickle=False)
    elif "image" in body:
        arr = body["image"]
    else:
        raise ValueError("missing 'image' or 'image_npy_b64'")
    arr = np.asarray(arr, dtype=np.float32)
    if arr.shape != (img_size, img_size, 3):
        raise ValueError(f"image must be ({img_size},{img_size},3), got {list(arr.shape)}")
    return arr


class _Handler(BaseHTTPRequestHandler):
    engine: InferenceEngine  # set by make_server

    def log_message(self, fmt, *args):  # noqa: D102 - quiet unless asked; /v1/stats is the observability
        if os.environ.get("FP_SERVE_VERBOSE"):
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: Dict[str, Any]) -> None:
        raw = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            pipe = self.engine.pipe
            self._reply(200, {"ok": True, "model": pipe.mcfg.model, "img_size": pipe.mcfg.img_size,
                              "key_len": pipe.fpcfg.key_len})
        elif self.path == "/v1/stats":
            self._reply(200, self.engine.stats())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
        except ValueError as e:  # json.JSONDecodeError is a ValueError
            return self._reply(400, {"error": f"bad JSON body: {e}"})
        routes = {"/v1/generate": self._generate, "/v1/attribute": self._attribute,
                  "/v1/identify": self._identify}
        if self.path not in routes:
            return self._reply(404, {"error": f"unknown path {self.path}"})
        try:
            routes[self.path](body)
        except EngineUnavailable as e:  # transient: the client may retry
            self._reply(503, {"error": str(e), "retryable": True})
        except ValueError as e:
            self._reply(400, {"error": str(e)})
        except EngineMisconfigured as e:  # the request is fine; the server is not set up to serve it
            self._reply(501, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - a device or solver failure is the server's, not the client's
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    def _generate(self, body: Dict[str, Any]) -> None:
        encoding = body.get("encoding", "png_b64")
        if encoding not in ("png_b64", "float_list"):
            raise ValueError(f"unknown encoding {encoding!r}")  # before it costs a device batch
        out = self.engine.generate(seed=body.get("seed"), key_bits=body.get("key_bits"), user=body.get("user"))
        resp: Dict[str, Any] = {"seed": out["seed"], "key_bits": out["key_bits"].tolist()}
        if encoding == "png_b64":
            resp["image_png_b64"] = _png_b64(out["image"])
        else:
            resp["image"] = out["image"].tolist()
        if body.get("return_latent"):
            resp["w"] = out["w"].tolist()
        self._reply(200, resp)

    def _attribute(self, body: Dict[str, Any]) -> None:
        out = self.engine.attribute(_decode_image(body, self.engine.pipe.mcfg.img_size))
        self._reply(200, {"key_bits": out["key_bits"].tolist(),
                          "confidence": np.round(out["confidence"], 6).tolist(), "loss": _finite(out["loss"])})

    def _identify(self, body: Dict[str, Any]) -> None:
        out = self.engine.identify(_decode_image(body, self.engine.pipe.mcfg.img_size))
        self._reply(200, {"user": out["user"], "user_index": out["user_index"],
                          "log_likelihood": _finite(out["log_likelihood"]),
                          "margin_nats": _finite(out["margin_nats"]), "hard_match_user": out["hard_match_user"],
                          "hard_distance": out["hard_distance"], "key_bits": out["key_bits"].tolist(),
                          "loss": _finite(out["loss"])})


class _Server(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 drops the connections of a larger burst of
    # clients, whose SYNs are then retried a second later
    request_queue_size = 128


def make_server(engine: InferenceEngine, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    """Bind (but do not serve) an HTTP server over ``engine``; ``port=0``
    binds an ephemeral port, read back from ``server.server_address[1]``."""
    handler = type("BoundHandler", (_Handler,), {"engine": engine})
    return _Server((host, port), handler)


def serve_forever_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t
