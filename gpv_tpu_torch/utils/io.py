"""Small IO helpers (counterpart of `gpv_tpu/utils/io.py`; reference
`utils/io.py`: load_json_object :27 / dump_json_object :34)."""
from __future__ import annotations

import gzip
import json
from pathlib import Path
from typing import Any


def load_json_object(path: str | Path, compressed: bool = False) -> Any:
    if compressed:
        with gzip.open(path, "rt") as f:
            return json.load(f)
    return json.loads(Path(path).read_text())


def dump_json_object(obj: Any, path: str | Path,
                     compressed: bool = False, indent: int | None = None):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if compressed:
        with gzip.open(path, "wt") as f:
            json.dump(obj, f, default=str)
        return
    path.write_text(json.dumps(obj, default=str, indent=indent))


def mkdir_if_not_exists(path: str | Path, recursive: bool = True):
    Path(path).mkdir(parents=recursive, exist_ok=True)
