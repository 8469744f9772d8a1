"""Serving-bundle export CLI (counterpart of
`gpv_tpu/cli/export_serving.py`).

    python -m gpv_tpu_torch.cli.export_serving ckpt=<model.pth | null> \
        out=<bundle_dir> [batch_sizes=[1,8,20]] [image_h=480] [image_w=640] \
        [tpu.dtype=float32] [device=cpu]

Run from a checkout (it reads `configs/exp/gpv_inference.yaml`). Builds the
engine (`infer.build.build_engine`: on the card unless `device=` says
otherwise), writes its bundle with `gpv_tpu_torch.export.export_engine`
(programs for each batch size, the folded weights once, both
vocabularies) and prints a JSON summary. Serve the bundle with
`gpv_tpu_torch.export.ExportedEngine(bundle_dir)` or
`python -m gpv_tpu_torch.cli.serve_http bundle=<bundle_dir>`: no model code
is needed there.
"""
import json
import sys


def main(argv=None):
    from gpv_tpu_torch.export import export_engine
    from gpv_tpu_torch.infer.build import build_engine
    from gpv_tpu_torch.utils.config import load_config

    overrides = list(argv if argv is not None else sys.argv[1:])
    keep, out, bs, h, w = [], None, (1, 8, 20), 480, 640
    for o in overrides:
        k, _, v = o.partition("=")
        if k == "out":
            out = v
        elif k == "batch_sizes":
            bs = tuple(int(x) for x in v.strip("[]").split(",") if x)
        elif k == "image_h":
            h = int(v)
        elif k == "image_w":
            w = int(v)
        else:
            keep.append(o)
    if not out:
        raise SystemExit("usage: export_serving ckpt=<path> out=<dir> "
                         "[batch_sizes=[1,8,20]] [image_h=] [image_w=]")
    engine = build_engine(load_config("configs", "exp/gpv_inference", keep))
    manifest = export_engine(engine, out, batch_sizes=bs, image_hw=(h, w))
    summary = {"out": out, "modules": sorted(manifest["programs"]),
               "platforms": [manifest["device"]]}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
