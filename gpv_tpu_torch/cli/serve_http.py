"""HTTP serving front end around `GPVServer` (stdlib only; the port's
counterpart of `gpv_tpu/cli/serve_http.py` in checkpoint mode).

Protocol (JSON over HTTP), the same as the JAX package's:
  GET  /healthz   -> {"ok": true}
  GET  /stats     -> serving counters (GPVServer.stats)
  POST /predict   body {"image": <base64 JPEG/PNG>, "query": "<text>",
                        "task": "vqa"|"captioning"|"classification"|
                                "classification_syns"|"detection" (optional),
                        "beam_size": int (optional, 1..20 -> beam search)}
               -> {"answer": str, "boxes": [[cx,cy,w,h] x Q],
                   "relevance": [float x Q]}
                  + for beam requests: {"answers": [str x K],
                    "answer_probs": [float x K]} ("answer" = top beam)

`task=classification[_syns]` applies the COCO-class vocab mask; other
tasks decode over the open vocabulary. Images are resized on the server
to the task size (`task_configs.image_size`, default 480x640; a bundle's
own size), so the batches of a bucket share one shape.

Usage (from a checkout; it reads `configs/exp/gpv_inference.yaml`):
  python -m gpv_tpu_torch.cli.serve_http ckpt=<model.pth | null> \
      [port=8000] [serve.batch_size=20] [serve.max_wait_ms=5] \
      [model.vocab=...] [tpu.dtype=float32] [device=cpu]
Serving an exported bundle (`gpv_tpu_torch.cli.export_serving`) needs no
checkout, config or model code; buckets and image size come from its
manifest, and a beam request is answered 400 (bundles serve greedy):
  python -m gpv_tpu_torch.cli.serve_http bundle=<dir> [port=8000] \
      [serve.bucket_sizes=[1,8]] [serve.warmup=false] [device=cpu]
"""
from __future__ import annotations

import base64
import io
import json
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

MAX_BEAM = 20


def _decode_image(b64: str, size_hw) -> np.ndarray:
    from PIL import Image
    img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
    h, w = size_hw
    if img.size != (w, h):
        img = img.resize((w, h), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def make_handler(server, vocab_masks: dict, size_hw, timeout_s: float = 120.0):
    """The request-handler class over a running GPVServer.
    vocab_masks: task name -> additive (V,) float32 mask or None."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive for batching clients
        # an idle keep-alive connection frees its thread within 5 s
        timeout = 5

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/stats":
                self._reply(200, server.stats())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                query = req["query"]
                image = _decode_image(req["image"], size_hw)
                task = req.get("task")
                if task is not None and task not in vocab_masks:
                    self._reply(400, {
                        "error": f"unknown task {task!r}; known: "
                                 f"{sorted(vocab_masks)}"})
                    return
                mask = vocab_masks.get(task) if task else None
                beam = None
                if req.get("beam_size") is not None:
                    beam = int(req["beam_size"])
                    if not 1 <= beam <= MAX_BEAM:
                        self._reply(400, {"error": f"beam_size {beam} out "
                                                   f"of range [1, {MAX_BEAM}]"})
                        return
            except Exception as e:  # any malformed body is the client's
                self._reply(400, {"error": f"bad request: {e}"})
                return
            try:
                fut = server.submit(image, query, mask, beam_size=beam)
            except ValueError as e:  # refused at the door: beam on a bundle
                self._reply(400, {"error": str(e)})
                return
            try:
                out = fut.result(timeout=timeout_s)
                payload = {
                    "answer": out["answer"],
                    "boxes": np.asarray(out["boxes"]).tolist(),
                    "relevance": np.asarray(out["relevance"]).tolist()}
                if "answers" in out:
                    payload["answers"] = out["answers"]
                    payload["answer_probs"] = out["answer_probs"]
                self._reply(200, payload)
            except Exception as e:  # the request failed; keep serving
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def make_http_server(server, vocab_masks: dict, size_hw,
                     host: str = "0.0.0.0", port: int = 8000,
                     timeout_s: float = 120.0) -> ThreadingHTTPServer:
    httpd = ThreadingHTTPServer(
        (host, port), make_handler(server, vocab_masks, size_hw, timeout_s))
    # server_close() joins in-flight handlers: a graceful shutdown never
    # cuts a reply
    httpd.daemon_threads = False
    httpd.block_on_close = True
    return httpd


def serve_in_thread(httpd: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return t


def main(argv=None):
    from gpv_tpu_torch.evaluation.vocab_mask import coco_vocab_mask
    from gpv_tpu_torch.serve import GPVServer

    raw = list(argv if argv is not None else sys.argv[1:])
    bundle = next((o.split("=", 1)[1] for o in raw
                   if o.startswith("bundle=")), None)
    overrides = [o for o in raw if not o.startswith("bundle=")]
    if bundle:
        # config-free: no model code and no configs/ tree; the overrides
        # are dotted values over serving defaults
        from gpv_tpu_torch.export import ExportedEngine
        from gpv_tpu_torch.utils.config import ConfigNode, _parse_scalar
        cfg = ConfigNode({"serve": ConfigNode()})
        for o in overrides:
            k, _, v = o.partition("=")
            cfg.set_path(k, _parse_scalar(v))
        engine = ExportedEngine(bundle, device=cfg.get("device"))
        H, W = engine.image_hw
        serve_cfg = cfg.get("serve") or {}
        buckets = tuple(serve_cfg.get("bucket_sizes") or engine.batch_sizes)
    else:
        from gpv_tpu_torch.infer.build import build_engine
        from gpv_tpu_torch.utils.config import load_config
        cfg = load_config("configs", "exp/gpv_inference", overrides)
        engine = build_engine(cfg)
        H = int(cfg.task_configs.image_size.H)
        W = int(cfg.task_configs.image_size.W)
        serve_cfg = cfg.get("serve") or {}
        batch = int(serve_cfg.get("batch_size", 20))
        buckets = tuple(serve_cfg.get("bucket_sizes") or (1, 8, batch))
    warm = str(serve_cfg.get("warmup", True)).lower() != "false"
    server = GPVServer(
        engine, max_wait_ms=float(serve_cfg.get("max_wait_ms", 5.0)),
        num_workers=int(serve_cfg.get("num_workers", 2)),
        bucket_sizes=buckets, warmup=(H, W) if warm else None)
    masks = {
        "vqa": None, "captioning": None, "detection": None,
        "classification": coco_vocab_mask(engine.vocab, use_syns=False),
        "classification_syns": coco_vocab_mask(engine.vocab, use_syns=True),
    }
    port = int(cfg.get("port", 8000))
    httpd = make_http_server(server, masks, (H, W),
                             host=str(cfg.get("host", "0.0.0.0")), port=port)
    print(f"gpv_tpu_torch serving on :{port} (buckets={buckets}, "
          f"image {H}x{W}, {engine.device}); POST /predict, GET /healthz, "
          "GET /stats", flush=True)

    def _term(signum, frame):  # SIGTERM -> graceful drain, exit 0
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass  # not the main thread (tests drive main() in a thread)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        server.close(drain=True)
        httpd.server_close()


if __name__ == "__main__":
    main()
