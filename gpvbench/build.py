"""Set-up shared by the drivers: the program's engine on seeded weights, and
the seeded pools of images and queries a cell's traffic draws from.

The weights are drawn on the device from the seed by the spec of the
configuration's family (`make_weights` of `reference/<family>.py`, found
through `family.reference`) and loaded into the program's model
strictly, so the program and the reference get the same numbers and
neither takes them from the other. The answer vocabulary is generated:
`answer_words(n)` plain words and the four specials in the program's
order. Queries come from the traffic's templates and object words, under
a word-level BERT vocabulary of exactly those words (`bert_words`), so
every query is one token a word.
"""
from __future__ import annotations

import time
from typing import List

from . import family

SPECIALS = ("__pad__", "__cls__", "__stop__", "__unk__")
BERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "?")


def answer_words(n: int) -> List[str]:
    return [f"w{i}" for i in range(n - len(SPECIALS))] + list(SPECIALS)


def bert_words(traffic: dict) -> List[str]:
    words = set()
    templates = traffic["templates"]
    if isinstance(templates, dict):          # templates by task
        templates = [t for ts in templates.values() for t in ts]
    for t in templates:
        words.update(t.replace("?", " ").replace("{}", " ").split())
    words.update(traffic["objects"])
    return list(BERT_SPECIALS) + sorted(words)


def node(d):
    """A plain dict as the program's config node (attribute access)."""
    from gpv_tpu_torch.utils.config import ConfigNode
    return ConfigNode({k: node(v) if isinstance(v, dict) else v
                       for k, v in d.items()})


def seed_of(seed: int, stream: int) -> int:
    """A generator seed for one of a run's streams (weights, pixels,
    requests, the check's sample); any whole number maps to one."""
    return (int(seed) * 1_000_003 + stream) % (2 ** 63)


def make_engine(ctx):
    """The program's `GPVEngine` for the configuration, on seeded weights:
    the model built on the device, the weights drawn there and loaded
    strictly, then folded, cast and held by the engine."""
    import torch
    from gpv_tpu_torch.engine import GPVEngine
    from gpv_tpu_torch.models.gpv import build_gpv
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer

    dev = torch.device(ctx.device)
    t = time.perf_counter()
    V = int(ctx.config["vocab_size"])
    weights = seeded_weights(ctx)
    with dev:
        model = build_gpv(node(ctx.model), V)
    model.load_state_dict(weights, strict=True)
    del weights
    eng = GPVEngine(model, AnswerVocab(answer_words(V)),
                    WordPieceTokenizer(bert_words(ctx.traffic)),
                    max_query_len=int(ctx.traffic["max_query_len"]),
                    device=dev, dtype=getattr(torch, ctx.dtype))
    del model
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ctx.split("weights", time.perf_counter() - t)
    if dev.type == "cuda":
        from gpv_tpu_torch.ops import _cuda
        t = time.perf_counter()
        _cuda.build_all()
        ctx.split("build", time.perf_counter() - t)
    return eng


def seeded_weights(ctx):
    """The cell's fp32 weights drawn on its device from its seed: the
    program loads them, and the reference draws them again once the
    program is gone."""
    import torch
    ref = family.reference(ctx.config)
    V = int(ctx.config["vocab_size"])
    return ref.make_weights(ref.param_spec(ctx.model, V),
                            seed_of(ctx.seed, 0), torch.device(ctx.device))


class Pool:
    """Seeded uint8 images (`batches` batches of `batch` images at the
    traffic's size, drawn on the device) and a query generator."""

    def __init__(self, ctx, batches: int, batch: int):
        import torch
        t = time.perf_counter()
        H, W = ctx.traffic["image_hw"]
        dev = torch.device(ctx.device)
        g = torch.Generator(device=dev).manual_seed(seed_of(ctx.seed, 1))
        # a coarse random layout (blocks of 1/16 of a side) under fine
        # noise, so that images differ in content and not only in noise
        coarse = torch.rand(batches * batch, 3, 16, 16, generator=g,
                            device=dev)
        coarse = torch.nn.functional.interpolate(coarse, size=(H, W),
                                                 mode="nearest")
        fine = torch.rand(batches * batch, 3, H, W, generator=g, device=dev)
        pix = (255.0 * (0.75 * coarse + 0.25 * fine)).to(torch.uint8)
        self.images = pix.permute(0, 2, 3, 1).reshape(
            batches, batch, H, W, 3).contiguous().cpu().numpy()
        self.templates = list(ctx.traffic["templates"])
        self.objects = list(ctx.traffic["objects"])
        ctx.split("data", time.perf_counter() - t)

    def queries(self, rng, n: int) -> List[str]:
        out = []
        for _ in range(n):
            t = self.templates[rng.integers(len(self.templates))]
            objs = rng.choice(len(self.objects), t.count("{}"),
                              replace=False)
            out.append(t.format(*(self.objects[i] for i in objs)))
        return out


def device_info(peak: int, prof=None) -> dict:
    import torch
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": peak}
    if prof is not None:
        dev["busy_s"] = prof.busy_s()
        dev["window_s"] = prof.window_s
    return dev
