"""Minimal HTML table writer for training visualizations (counterpart of
`gpv_tpu/utils/html_writer.py`; reference `utils/html_writer.py`): open a
file, add rows of cells (text or <img>), close. The trainer writes
`training_visualizations/{subset}_{step}/index.html` with it."""
from __future__ import annotations

from pathlib import Path


class HtmlWriter:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("w")
        self._fh.write(
            "<html><head><style>"
            "table{border-collapse:collapse} td{border:1px solid #999;"
            "padding:4px;vertical-align:top;font-family:monospace}"
            "img{max-width:640px}</style></head><body><table>\n")

    def add_row(self, cells: dict | list):
        if isinstance(cells, dict):
            cells = [cells[k] for k in sorted(cells)]
        self._fh.write("<tr>")
        for c in cells:
            self._fh.write(f"<td>{c}</td>")
        self._fh.write("</tr>\n")

    def image_tag(self, src: str, height: int | None = None) -> str:
        h = f' height="{height}"' if height else ""
        return f'<img src="{src}"{h}>'

    def close(self):
        self._fh.write("</table></body></html>\n")
        self._fh.close()
