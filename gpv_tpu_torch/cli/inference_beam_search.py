"""Single-image beam-search inference (the port's root
`inference_beam_search.py`).

    python -m gpv_tpu_torch.cli.inference_beam_search ckpt=<model.pth | null> \
        image_path=<img> query="what is this?" beam_size=5 [device=cpu]

Run from a checkout. The image is resized to the task size
(`task_configs.image_size`, by `task_configs.host_resize`); prints the K
answers with their probabilities (with the reference's beam tail quirk,
as the root CLI does) and the top boxes.
"""
import sys


def main(argv=None):
    from gpv_tpu_torch.datasets.image import load_image, resize_uint8
    from gpv_tpu_torch.infer.build import build_engine
    from gpv_tpu_torch.utils.config import load_config

    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = load_config("configs", "exp/gpv_inference", overrides)
    engine = build_engine(cfg)

    img = load_image(cfg.image_path)
    img = resize_uint8(img, int(cfg.task_configs.image_size.H),
                       int(cfg.task_configs.image_size.W),
                       method=str(cfg.task_configs.get("host_resize",
                                                       "pil")))
    beam_size = int(cfg.get("beam_size", 5))
    out = engine.predict_beam(img[None], [cfg.query], beam_size,
                              reference_quirks=True)[0]

    print("answers (with probabilities):")
    for ans, p in zip(out["answers"], out["answer_probs"]):
        print(f"  {p:.4f}  {ans}")
    num_boxes = int(cfg.get("num_output_boxes", 5))
    print("relevant boxes (cx, cy, w, h):")
    for i in range(min(num_boxes, len(out["boxes"]))):
        b = out["boxes"][i]
        print(f"  {b[0]:.4f} {b[1]:.4f} {b[2]:.4f} {b[3]:.4f} "
              f"(relevance {out['relevance'][i]:.4f})")
    return out


if __name__ == "__main__":
    main()
