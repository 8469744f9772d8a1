"""Checkpoint parity checker (the port's `gpv_tpu.cli.check_parity`): load
a reference torch checkpoint, run an image+query through the port's model
in fp32, and print (or compare) the outputs.

  # print outputs for an image/query (and save them as goldens)
  python -m gpv_tpu_torch.cli.check_parity ckpt=model.pth image=img.jpg \
      query="what is this?" save=goldens.json [device=cpu]

  # compare against saved goldens (e.g. produced by the reference repo)
  python -m gpv_tpu_torch.cli.check_parity ckpt=model.pth image=img.jpg \
      query="what is this?" expect=goldens.json [atol=1e-3]

The goldens JSON format: {"boxes": [[cx,cy,w,h]...], "relevance": [...],
"answer": "..."} — the reference's inference.py output contract. The
`.pth` holds the reference's names, which are the port's own: it loads as
it is, with no conversion. `resize=true` resizes the image to the task size
by `resize_method` (default exact: the reference's eval pixel path).
"""
import json
import sys
from pathlib import Path

import numpy as np

LOCAL_ARGS = ("ckpt", "image", "query", "save", "expect", "atol", "resize")


def main(argv=None):
    import torch

    from gpv_tpu_torch.datasets.image import load_image, resize_uint8
    from gpv_tpu_torch.engine import GPVEngine
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
    from gpv_tpu_torch.utils.config import load_config
    from gpv_tpu_torch.weights import load_torch_state_dict

    argv = list(argv or sys.argv[1:])
    args = dict(a.split("=", 1) for a in argv)
    cfg = load_config("configs", "exp/gpv",
                      [o for o in argv
                       if o.split("=", 1)[0] not in LOCAL_ARGS])

    sd = load_torch_state_dict(args["ckpt"])
    vocab_size = sd["answer_head.vocab_embed"].shape[0]
    vocab = (AnswerVocab.load(cfg.model.vocab) if cfg.model.vocab
             else AnswerVocab.debug(size=vocab_size))
    tokenizer = (WordPieceTokenizer.load(cfg.model.bert_vocab)
                 if cfg.model.get("bert_vocab")
                 else WordPieceTokenizer.debug())
    engine = GPVEngine.from_config(cfg.model, vocab, tokenizer,
                                   state_dict=sd, dtype=torch.float32,
                                   device=cfg.get("device"))

    img = load_image(args["image"])
    if args.get("resize", "false").lower() == "true":
        img = resize_uint8(img, int(cfg.task_configs.image_size.H),
                           int(cfg.task_configs.image_size.W),
                           method=args.get("resize_method", "exact"))
    out = engine.predict(img[None], [args["query"]])[0]
    result = {"answer": out["answer"],
              "boxes": np.asarray(out["boxes"]).tolist(),
              "relevance": np.asarray(out["relevance"]).tolist()}

    if args.get("save"):
        Path(args["save"]).write_text(json.dumps(result))
        print(f"saved goldens to {args['save']}")
    if args.get("expect"):
        atol = float(args.get("atol", 1e-3))
        want = json.loads(Path(args["expect"]).read_text())
        ok = True
        if want.get("answer") != result["answer"]:
            print(f"ANSWER MISMATCH: {result['answer']!r} != "
                  f"{want['answer']!r}")
            ok = False
        for key in ("boxes", "relevance"):
            if key in want:
                diff = np.max(np.abs(np.asarray(want[key])
                                     - np.asarray(result[key])))
                print(f"{key}: max abs diff {diff:.2e}")
                ok &= diff <= atol
        print("PARITY OK" if ok else "PARITY FAILED")
        return 0 if ok else 1
    print(json.dumps({"answer": result["answer"],
                      "top_boxes": result["boxes"][:5],
                      "top_relevance": result["relevance"][:5]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
