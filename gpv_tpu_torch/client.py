"""GPVClient: stdlib HTTP client for the serving front end (the port's
copy of `gpv_tpu/client.py`; the protocol is the same).

For machines without the model code: numpy and PIL are needed only to
send an image array (a path or encoded bytes work without them).

    server host:  python -m gpv_tpu_torch.cli.serve_http ckpt=... port=8000
    client host:  GPVClient("http://gpu-host:8000").predict(img, "what is this?")

Protocol: see `gpv_tpu_torch/cli/serve_http.py` (POST /predict,
GET /healthz, GET /stats).
"""
from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from typing import Optional


class GPVClient:
    def __init__(self, base_url: str, timeout_s: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    # ---- transport ----

    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(self.base_url + path,
                                    timeout=self.timeout_s) as r:
            return json.loads(r.read())

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.base_url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            body = e.read().decode(errors="replace")
            try:
                msg = json.loads(body).get("error", body)
            except Exception:
                msg = body
            raise RuntimeError(f"server returned {e.code}: {msg}") from None

    # ---- image encoding ----

    @staticmethod
    def _encode_image(image) -> str:
        """Accept a file path, raw encoded bytes (PNG/JPEG), or an HxWx3
        uint8 array (PNG-encoded client-side)."""
        if isinstance(image, (str,)) or hasattr(image, "__fspath__"):
            with open(image, "rb") as f:
                return base64.b64encode(f.read()).decode()
        if isinstance(image, (bytes, bytearray)):
            return base64.b64encode(bytes(image)).decode()
        # ndarray-like
        import io

        import numpy as np
        from PIL import Image
        arr = np.asarray(image)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f"expected HxWx3 image array, got {arr.shape}")
        buf = io.BytesIO()
        Image.fromarray(arr.astype(np.uint8)).save(buf, "PNG")
        return base64.b64encode(buf.getvalue()).decode()

    # ---- API ----

    def predict(self, image, query: str,
                task: Optional[str] = None,
                beam_size: Optional[int] = None) -> dict:
        """One request -> {answer, boxes (Qx4 cxcywh lists), relevance}.

        `image`: path, encoded bytes, or HxWx3 uint8 array.
        `task`: optional server-side vocab-mask routing
        ("classification"/"classification_syns" apply the COCO class mask).
        `beam_size`: K>1 adds beam search — the reply also carries
        `answers` ([str x K]) and `answer_probs`; `answer` is the top beam.
        """
        payload = {"image": self._encode_image(image), "query": query}
        if task is not None:
            payload["task"] = task
        if beam_size is not None:
            payload["beam_size"] = int(beam_size)
        return self._post("/predict", payload)

    def healthy(self) -> bool:
        try:
            return bool(self._get("/healthz").get("ok"))
        except Exception:
            return False

    def stats(self) -> dict:
        """Serving counters (see GPVServer.stats)."""
        return self._get("/stats")
