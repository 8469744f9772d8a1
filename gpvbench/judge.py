"""The comparison that decides `correct` for a served model: the answers,
boxes and relevance the program returned, held against the plain
reference on the same image, query and weights.

- `token_gap`: for every served answer token, how far its reference logit
  lies below the reference's best at that place (teacher-forced on the
  served tokens); the largest over the sample.
- `box_err`: every served (box, relevance) pair against the reference's
  100 pairs of that row: the distance (largest coordinate or relevance
  difference) to the nearest one; the 99th percentile over the sample's
  boxes (a wrong row is 3% of them), divided by the same percentile of
  the reference's own boxes computed with its products rounded to
  bfloat16. How far boxes move under rounding depends on the weights
  drawn (a seed whose box head saturates moves them a fifth as far), so
  the served boxes are judged against the rounding the precision the
  configuration states makes on the same seed: a sound bf16 program
  reads about 1.
- `unsorted`: served relevance values that rise where they should fall
  (the program sorts them, most relevant first); the limit is 0.

The served answer is a string of words; `align` turns it back into the
tokens that produced it. A `__cls__` token leaves no word, and the answer
ends at `__stop__` or `__pad__`, so a row shorter than the decode is
aligned one place at a time, taking at each place whichever token the
string allows that the reference ranks highest.

With the run's `control` set, `readings` also gives the control's
numbers: the same reference computed in float8 (the family reference's
`Precision`), its best token at each place judged by the fp32 logits, and
its own boxes and relevance sorted and judged as the program's are.

The reference is the configuration's family's (`family.reference`: its
`param_spec`, `make_weights`, `Precision`, `tokenize`, `encode`, which
gives `memory`, `mem_valid`, `relevance` and `boxes`, and
`answer_logits`); the training check also takes its training reference
(`family.train_reference`).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import build, family

CHECKS = ("token_gap", "box_err", "unsorted")


def box_err(boxes: np.ndarray, rel: np.ndarray, ref_boxes: torch.Tensor,
            ref_rel: torch.Tensor) -> torch.Tensor:
    b = torch.as_tensor(np.asarray(boxes), dtype=torch.float32)
    r = torch.as_tensor(np.asarray(rel), dtype=torch.float32)
    d = torch.maximum((b[:, None, :] - ref_boxes[None].float()).abs()
                      .amax(-1), (r[:, None] - ref_rel[None].float()).abs())
    return d.amin(1)


def unsorted(rel: np.ndarray) -> int:
    return int((np.diff(np.asarray(rel, np.float64)) > 0).sum())


def _gap(logits: torch.Tensor, tok: int) -> float:
    return float(logits.max() - logits[tok])


def align(ref, P, W, model, memory, mem_valid, words: List[str], index,
          steps: int, cls_id: int, ends) -> List[int]:
    """The served token ids of one row whose answer has fewer words than
    `steps` (module docstring); None where the words cannot be placed."""
    toks: List[int] = []
    i = 0
    for _ in range(steps):
        lg = ref.answer_logits(P, W, model, memory, mem_valid,
                               torch.tensor([[cls_id] + toks],
                                            device=memory.device))[0, -1]
        cands = [cls_id]
        if i < len(words):
            cands.append(index.get(words[i], -1))
        else:
            cands += list(ends)
        cands = [c for c in cands if c >= 0]
        pick = min(cands, key=lambda c: _gap(lg, c))
        toks.append(pick)
        if i < len(words) and pick == cands[-1] and pick != cls_id:
            i += 1
        if pick in ends:
            break
    return toks if i == len(words) else None


@torch.no_grad()
def readings(ctx, rows: List[dict], answer_words: List[str],
             block: int = 8) -> Dict[str, float]:
    """The program's readings over `rows` (each {image, query, answer,
    boxes, relevance}) against the reference on the cell's seeded weights,
    at the traffic's query length and the configuration's decode steps;
    with `ctx.control` also the control's (`control_*`)."""
    ref = family.reference(ctx.config)
    model, control, device = ctx.model, ctx.control, torch.device(ctx.device)
    W = build.seeded_weights(ctx)
    bert_words = build.bert_words(ctx.traffic)
    query_len = int(ctx.traffic["max_query_len"])
    steps = int(model["max_text_len"]) - 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P32, P8 = ref.Precision("float32"), ref.Precision("float8")
    P16 = ref.Precision("bfloat16")
    index = {w: i for i, w in enumerate(answer_words)}
    cls_id = index["__cls__"]
    ends = (index["__stop__"], index["__pad__"])
    out = {k: 0.0 for k in CHECKS}
    if control:
        out.update({f"control_{k}": 0.0 for k in CHECKS})
    errs = {"box_err": [], "control_box_err": [], "bf16": []}
    ids, valid = ref.tokenize(bert_words, [r["query"] for r in rows],
                              query_len)
    for s in range(0, len(rows), block):
        part = rows[s:s + block]
        imgs = torch.from_numpy(np.stack([r["image"] for r in part])).to(
            device)
        q, qv = ids[s:s + block].to(device), valid[s:s + block].to(device)
        e = ref.encode(P32, W, model, imgs, q, qv)
        mem, mv, rel, boxes = (e["memory"], e["mem_valid"], e["relevance"],
                               e["boxes"])
        e16 = ref.encode(P16, W, model, imgs, q, qv)
        for j in range(len(part)):
            order = torch.argsort(-e16["relevance"][j], stable=True)
            errs["bf16"].append(box_err(
                e16["boxes"][j][order].cpu().numpy(),
                e16["relevance"][j][order].cpu().numpy(), boxes[j].cpu(),
                rel[j].cpu()))
        if control:
            e = ref.encode(P8, W, model, imgs, q, qv)
            mem8, mv8, rel8, boxes8 = (e["memory"], e["mem_valid"],
                                       e["relevance"], e["boxes"])
        for j, r in enumerate(part):
            words = r["answer"].split()
            if len(words) == steps and all(w in index for w in words):
                toks = [index[w] for w in words]
            else:
                toks = align(ref, P32, W, model, mem[j:j + 1], mv[j:j + 1],
                             words, index, steps, cls_id, ends)
            if toks is None:
                out["token_gap"] = float("inf")
            else:
                inp = torch.tensor([[cls_id] + toks[:-1]], device=device)
                lg = ref.answer_logits(P32, W, model, mem[j:j + 1],
                                       mv[j:j + 1], inp)[0]
                t = torch.tensor(toks, device=device)
                gaps = lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]
                out["token_gap"] = max(out["token_gap"], float(gaps.max()))
                if control:
                    lg8 = ref.answer_logits(P8, W, model, mem8[j:j + 1],
                                            mv8[j:j + 1], inp)[0]
                    pick = lg8.argmax(-1)
                    g8 = lg.max(-1).values - lg.gather(1, pick[:, None])[:, 0]
                    out["control_token_gap"] = max(
                        out["control_token_gap"], float(g8.max()))
            errs["box_err"].append(box_err(r["boxes"], r["relevance"],
                                           boxes[j].cpu(), rel[j].cpu()))
            out["unsorted"] += unsorted(r["relevance"])
            if control:
                order = torch.argsort(-rel8[j], stable=True)
                errs["control_box_err"].append(box_err(
                    boxes8[j][order].cpu().numpy(),
                    rel8[j][order].cpu().numpy(), boxes[j].cpu(),
                    rel[j].cpu()))
    scale = max(float(torch.quantile(torch.cat(errs.pop("bf16")), 0.99)),
                1e-6)
    for k, v in errs.items():
        if v:
            out[k] = float(torch.quantile(torch.cat(v), 0.99)) / scale
    return out


TRAIN_LOSSES = ("loss_caption", "loss_vqa", "loss_cls", "loss_ce",
                "loss_bbox", "loss_giou")
TRAIN_CHECKS = ("loss_gap", "grad_gap", "change_gap", "grad_diff",
                "change_diff")
WORST: Dict[str, list] = {}   # the last comparison's worst parts, logged


def parts(leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The leaves as the check compares them: a packed attention bias
    (`*in_proj_bias`: the query, key and value biases one after the other)
    as its three thirds, every other leaf whole."""
    out = {}
    for n, t in leaves.items():
        if n.endswith("in_proj_bias"):
            for tag, piece in zip("qkv", t.chunk(3)):
                out[f"{n}[{tag}]"] = piece
        else:
            out[n] = t
    return out


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in leaves.items()}


def rounding_only(grad: Dict[str, torch.Tensor],
                  again: Dict[str, torch.Tensor],
                  spread: float = 1e-2) -> List[str]:
    """The parts whose exact gradient is nought, by the reference's first
    gradient (`grad`) and the same taken over the batch's rows in reverse
    order (`again`): a norm under a thousandth of the median part's, or
    one that the reordering changes by more than `spread` of itself (fp32
    sums that cancel to rounding: the answer head's bias, added to every
    word's logit alike, and each attention key bias, added to every key's
    score alike, are nought under softmax). A real gradient reorders to
    about 1e-6 of itself. These parts move under AdamW by rounding alone;
    the check leaves them out."""
    g, h = parts(grad), parts(again)
    norm = _norms(g)
    med = float(np.median(list(norm.values())))
    return sorted(n for n in g if norm[n] < 1e-3 * med or float(
        torch.linalg.vector_norm((h[n] - g[n]).float())) > spread * norm[n])


def compare_training(ref_run: dict, start: Dict[str, torch.Tensor],
                     other: dict, left_out: List[str]) -> Dict[str, float]:
    """A run of the checked steps (`other`: per step its losses, the first
    step's gradient as the optimizer took it, the parameters after the
    last step) against the reference's (`ref_run`, from the weights
    `start`), over the parts (`parts`) but those in `left_out`
    (`rounding_only`):

    - `loss_gap`: each step's loss of each task, relative to the
      reference's (whose localization losses are over its own optimal
      matching: an assignment off the optimum shows here);
    - `grad_gap`: the gap between the two first gradients' norms, part by
      part, against the larger of the reference part's norm and the median
      part's; the third largest over the parts (`grad_gap_worst`, the
      largest, is reported): the relevance head's two parts swing from
      seed to seed (their gradient is a sum over every box that all but
      cancels at random weights, and the compute dtype's rounding of its
      terms moves it by up to 0.86 of itself), and a fault in three parts
      or more still shows;
    - `change_gap`: the same gap for the parameters' change over the
      steps; the largest over the parts;
    - `grad_diff`: the norm of the two first gradients' difference, part
      by part, against the same larger norm; the median part's;
    - `change_diff`: the same for the two parameter changes over the
      steps. Norms alone cannot tell steps taken over half of the batch's
      rows (at random weights every row's gradient is much alike); the
      change's direction can: AdamW's first update is about the sign of
      each gradient element, so small elements count as much as large;
    - `grad_gap_median`, `change_gap_median`: the median part's, reported."""
    out = {k: 0.0 for k in TRAIN_CHECKS}
    for got, want in zip(other["losses"], ref_run["losses"]):
        for k in TRAIN_LOSSES:
            out["loss_gap"] = max(out["loss_gap"], abs(got[k] - want[k])
                                  / max(abs(want[k]), 1e-3))
    if set(other["grad"]) != set(ref_run["grad"]):
        return {k: float("inf") for k in TRAIN_CHECKS}
    skip = set(left_out)
    gr = {n: v for n, v in _norms(parts(ref_run["grad"])).items()
          if n not in skip}
    gp = _norms(parts(other["grad"]))
    med = float(np.median(list(gr.values())))
    grad = {n: abs(gp[n] - gr[n]) / max(gr[n], med) for n in gr}
    dr = _norms(parts({n: ref_run["params"][n] - start[n]
                       for n in ref_run["grad"]}))
    dp = _norms(parts({n: other["params"][n].to(start[n].device) - start[n]
                       for n in ref_run["grad"]}))
    med_d = float(np.median([dr[n] for n in gr]))
    change = {n: abs(dp[n] - dr[n]) / max(dr[n], med_d) for n in gr}
    cv_r = parts({n: ref_run["params"][n] - start[n] for n in ref_run["grad"]})
    cv_p = parts({n: other["params"][n].to(start[n].device) - start[n]
                  for n in ref_run["grad"]})
    out["change_diff"] = float(np.median([float(torch.linalg.vector_norm(
        (cv_p[n] - cv_r[n]).float())) / max(dr[n], med_d) for n in gr]))
    gv_r, gv_p = parts(ref_run["grad"]), parts(other["grad"])
    diff = {n: float(torch.linalg.vector_norm(
        (gv_p[n].to(gv_r[n].device) - gv_r[n]).float())) / max(gr[n], med)
        for n in gr}
    out["grad_diff"] = float(np.median(list(diff.values())))
    ranked = sorted(grad.values())
    out["grad_gap"] = ranked[-min(3, len(ranked))]
    out["grad_gap_worst"] = ranked[-1]
    out["change_gap"] = max(change.values())
    out["grad_gap_median"] = float(np.median(list(grad.values())))
    out["change_gap_median"] = float(np.median(list(change.values())))
    for name, gaps, a, b in (("grad", grad, gp, gr), ("change", change, dp,
                                                      dr)):
        worst = sorted(gaps, key=gaps.get)[-5:]
        WORST[name] = [(n, gaps[n], a[n], b[n]) for n in worst]
    WORST["left_out"] = sorted(skip)
    return out


def dropout_rates(model: dict) -> List[float]:
    """Every dropout rate of the model's configuration."""
    co = model["co_att"]
    return [float(model["detr"]["dropout"]),
            float(model["text_decoder"].get("dropout",
                                            model["detr"]["dropout"]))] + [
        float(co.get(k, model["detr"]["dropout"])) for k in (
            "attention_probs_dropout_prob", "hidden_dropout_prob",
            "v_attention_probs_dropout_prob", "v_hidden_dropout_prob")]


def train_readings(ctx, items: List[List[dict]],
                   prog: dict) -> Dict[str, float]:
    """The training cell's readings: the program's checked steps (its
    losses, first gradient and parameters in `prog`) against the
    reference's steps over the same raw items from the same weights;
    with `ctx.control` also the control's, the reference in float8 in the
    program's place (`control_*`). The configuration's dropout rates have
    to be 0: the reference cannot see the masks."""
    ref = family.reference(ctx.config)
    rtrain = family.train_reference(ctx.config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(ctx.device)
    model, tr, conf = ctx.model, ctx.traffic, ctx.config
    if any(dropout_rates(model)):
        raise ValueError(f"dropout rates {dropout_rates(model)}: the "
                         "training check needs them 0")
    V = int(conf["vocab_size"])
    kinds = {n: k for n, _, k in ref.param_spec(model, V)}
    answer_words, bert_words = build.answer_words(V), build.bert_words(tr)
    batches = [rtrain.batch_tensors(it, answer_words, bert_words,
                                    int(tr["max_query_len"]),
                                    int(model["max_text_len"]), dev)
               for it in items]
    total = int(conf["steps_per_epoch"]) * int(conf["training"]["num_epochs"])

    def reference(P, steps):
        W = build.seeded_weights(ctx)
        start = {n: t.clone() for n, t in W.items()
                 if rtrain.trainable(n, kinds[n])}
        run = rtrain.train(P, W, kinds, model, conf["losses"],
                           conf["training"], steps, int(tr["start_update"]),
                           total, dev)
        run["params"] = {n: W[n] for n in run["leaves"]}
        return run, start

    P32 = ref.Precision("float32")
    again, _ = reference(P32, [rtrain.batch_tensors(
        items[0][::-1], answer_words, bert_words, int(tr["max_query_len"]),
        int(model["max_text_len"]), dev)])
    again = again["grad"]
    ref_run, start = reference(P32, batches)
    left_out = rounding_only(ref_run["grad"], again)
    del again
    out = compare_training(ref_run, start, prog, left_out)
    ctx.log(f"gpvbench: worst parts {WORST}")
    if ctx.control:
        ctl, _ = reference(ref.Precision("float8"), batches)
        out.update({f"control_{k}": v for k, v in compare_training(
            ref_run, start, ctl, left_out).items()})
    return out
