"""Single-image greedy inference (the port's root `inference.py`).

    python -m gpv_tpu_torch.cli.inference ckpt=<model.pth | null> \
        image_path=<img> query="what is this?" [num_output_boxes=5] \
        [model.vocab=<vocab.json>] [tpu.dtype=float32] [device=cpu]

Run from a checkout (it reads `configs/exp/gpv_inference.yaml`). The image
is used at its native resolution; prints the answer and the top
relevance-sorted normalised cxcywh boxes, as the root CLI does.
"""
import sys


def main(argv=None):
    from gpv_tpu_torch.datasets.image import load_image
    from gpv_tpu_torch.infer.build import build_engine
    from gpv_tpu_torch.utils.config import load_config

    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = load_config("configs", "exp/gpv_inference", overrides)
    engine = build_engine(cfg)

    img = load_image(cfg.image_path)  # native H x W (no resize)
    out = engine.predict(img[None], [cfg.query])[0]

    num_boxes = int(cfg.get("num_output_boxes", 5))
    print("answer:", out["answer"])
    print("relevant boxes (cx, cy, w, h):")
    for i in range(min(num_boxes, len(out["boxes"]))):
        b = out["boxes"][i]
        print(f"  {b[0]:.4f} {b[1]:.4f} {b[2]:.4f} {b[3]:.4f} "
              f"(relevance {out['relevance'][i]:.4f})")
    return out


if __name__ == "__main__":
    main()
