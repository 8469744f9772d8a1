"""A cell shrunk for the CPU: every width of the released configuration cut,
the image 64x64, four rows a call; the harness and the drivers run as
they do on the card (test-only entry: `run_tiny`)."""
from __future__ import annotations

import copy
import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_MODEL = {
    "hidden_dim": 32, "max_target_boxes": 8,
    "bert": {"hidden": 32, "num_layers": 1, "heads": 4, "vocab_size": 200,
             "max_len": 64},
    "detr": {"hidden_dim": 32, "nheads": 4, "num_encoder_layers": 1,
             "num_decoder_layers": 1, "num_queries": 10,
             "dim_feedforward": 64, "backbone_layers": [1, 1, 1, 1]},
    "detr_joiner": {"detr_dim": 2080, "out_dim": 32},
    "bert_joiner": {"bert_dim": 32, "out_dim": 32},
    "text_decoder": {"hidden_dim": 32, "nheads": 4, "num_layers": 1},
    "co_att": {"bi_num_attention_heads": 4, "bi_hidden_size": 32,
               "hidden_size": 32, "intermediate_size": 64,
               "output_size": 32, "v_hidden_size": 32,
               "v_intermediate_size": 64, "v_output_size": 32,
               "num_layers": 1}}
# At these widths in fp32 the program matches the reference to about 1e-6
# (no token gap, boxes within 1e-6), so a fault planted at this size is
# held to limits of this size: the configurations' limits are set for
# bf16 at the released widths.
TINY_LIMITS = {"token_gap": 0.02, "box_err": 0.05, "unsorted": 0,
               "loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 0.05,
               "grad_diff": 1e-3, "change_diff": 1e-3}
TINY_TRAFFIC = {"batch": 4, "image_hw": [64, 64], "pool_batches": 2,
                "warmup_calls": 1, "profile_s": 0.2, "check_rows": 6,
                "per_task": 2, "caption_words": [3, 5], "vqa_words": [1, 2],
                "box_counts": [1, 3]}


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else copy.deepcopy(v)
    return out


def tiny(ctx, vocab: int = 64):
    """Shrink a made `Ctx` in place to the tiny widths, fp32, on the CPU."""
    ctx.config = merge(ctx.config, {"model": TINY_MODEL,
                                    "vocab_size": vocab})
    ctx.traffic = merge(ctx.traffic, TINY_TRAFFIC)
    ctx.dtype = "float32"
    return ctx


def run_tiny(cell: str, seed: int = 7, seconds: float = 1.0,
             trace: bool = False, man=None, root: Path = ROOT,
             config: dict = None):
    """The harness's run of `cell` at tiny widths on the CPU: the result
    line as a dict (without the card check)."""
    from gpvbench import run
    man = man or run.manifest(root)
    ctx = tiny(run.make_ctx(man, cell, seed, seconds, trace, "cpu",
                            time.perf_counter(), root))
    if config:
        ctx.config = merge(ctx.config, config)
    ctx.log = lambda line: None
    return run.run_cell(man, ctx)


if __name__ == "__main__":
    print(json.dumps(run_tiny("predict-greedy-r50"), default=str)[:2000])
