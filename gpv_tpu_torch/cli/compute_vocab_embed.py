"""Answer-vocabulary embedding (the port's counterpart of
`gpv_tpu.cli.compute_vocab_embed`):

    python -m gpv_tpu_torch.cli.compute_vocab_embed vocab=<vocab.json> \
        out=<vocab_embed.npy> [bert_vocab=<vocab.txt>] \
        [bert_ckpt=<HF BERT state dict .bin/.pth>] [device=cpu]

BERT CLS embedding per vocab word -> (V, 768) .npy, the answer head's
fixed matrix (reference `exp/gpv/compute_vocab_bert.py`). Without
`bert_ckpt` the BERT has seeded random weights.
"""
import json
import sys
from pathlib import Path


def main(argv=None):
    args = dict(a.split("=", 1) for a in (argv if argv is not None
                                          else sys.argv[1:]))
    from gpv_tpu_torch.data.vocab_embed import embed_vocab, write_vocab_embed
    from gpv_tpu_torch.nn.bert import BertEncoder
    from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
    from gpv_tpu_torch.weights import load_bert_weights, load_torch_state_dict

    vocab = json.loads(Path(args["vocab"]).read_text())
    tokenizer = (WordPieceTokenizer.load(args["bert_vocab"])
                 if args.get("bert_vocab") else WordPieceTokenizer.debug())
    bert = None
    if args.get("bert_ckpt"):
        bert = load_bert_weights(BertEncoder(),
                                 load_torch_state_dict(args["bert_ckpt"]))
    embed = embed_vocab(vocab, tokenizer, bert, device=args.get("device"))
    out = write_vocab_embed(embed, args.get("out", "vocab_embed.npy"))
    print(f"wrote {out} shape={embed.shape}")


if __name__ == "__main__":
    main()
