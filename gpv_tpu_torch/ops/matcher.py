"""DETR Hungarian matching (counterpart of `gpv_tpu/ops/matcher.py`).

Reference `utils/matcher.py`: the cost 5·L1 + 1·(−prob[target class]) +
2·(−GIoU) per image, solved with `scipy.optimize.linear_sum_assignment` on
the host. The cost matrices of the whole batch are built on the device in
one pass and copied to the host once; the native runtime's C++ solver
(`gpv_tpu_torch.native`, the port's copy of `gpv_tpu/native/lap.cc`) then
solves every image in one call. (The JAX package moved the solve onto the
TPU as a `while_loop` Jonker-Volgenant; in eager PyTorch a sequential
per-row solver would cost a launch and a synchronisation per row.) Both
solvers reach the optimum; on an exact tie the C++ solver may pick another
assignment than scipy, which stays the tests' oracle.

Ragged targets are padded to a fixed M: a padded target row costs 0 against
every query, a constant row, which adds the same amount to every complete
assignment and so leaves the real rows' optimum where it was. The solver
takes M <= Q, which the padding keeps (M is the collator's
`max_target_boxes`, at most the query count).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import span
from .boxes import box_cxcywh_to_xyxy, generalized_box_iou


def detr_cost_matrix(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                     tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                     cost_class: float = 1.0, cost_bbox: float = 5.0,
                     cost_giou: float = 2.0) -> torch.Tensor:
    """Matching cost, targets as rows: (..., Q, K+1), (..., Q, 4),
    (..., M), (..., M, 4) -> (..., M, Q). Leading batch axes are optional."""
    prob = pred_logits.softmax(-1)                                # (..,Q,K+1)
    labels = tgt_labels.long()[..., None, :].expand(
        *prob.shape[:-1], tgt_labels.shape[-1])
    c_class = -torch.gather(prob, -1, labels)                     # (..,Q,M)
    c_bbox = (pred_boxes[..., :, None, :]
              - tgt_boxes[..., None, :, :]).abs().sum(-1)
    c_giou = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                                  box_cxcywh_to_xyxy(tgt_boxes))
    c = cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou
    return c.transpose(-1, -2)


def match_costs(pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid,
                cost_class: float = 1.0, cost_bbox: float = 5.0,
                cost_giou: float = 2.0) -> torch.Tensor:
    """The batch's (B, M, Q) fp32 costs on the inputs' device: padded
    target rows 0, NaN and inf mapped to finite values."""
    c = detr_cost_matrix(pred_logits.float(), pred_boxes.float(), tgt_labels,
                         tgt_boxes.float(), cost_class, cost_bbox, cost_giou)
    c = torch.where(tgt_valid[..., None], c, 0.0)
    return torch.nan_to_num(c, nan=0.0, posinf=1e6, neginf=-1e6)


def solve_costs(costs: np.ndarray) -> np.ndarray:
    """(B, M, Q) host costs, M <= Q -> (B, M) int64: the query assigned to
    each target row, every image solved in one native call."""
    from ..native import solve_lsap_native
    B, M, Q = costs.shape
    if M > Q:
        raise ValueError(f"{M} target rows for {Q} queries: every target "
                         "needs its own query")
    return solve_lsap_native(costs).astype(np.int64)


@torch.no_grad()
def hungarian_match(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                    tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                    tgt_valid: torch.Tensor, cost_class: float = 1.0,
                    cost_bbox: float = 5.0,
                    cost_giou: float = 2.0) -> torch.Tensor:
    """Batched DETR matching.

    pred_logits (B,Q,K+1), pred_boxes (B,Q,4) cxcywh; tgt_labels (B,M),
    tgt_boxes (B,M,4), tgt_valid (B,M) bool. Returns query4target (B,M)
    int64 on the inputs' device; only entries with tgt_valid are
    meaningful. One device-to-host copy of the costs per call (the span
    `train.matcher.wait`: the host waits there for the forward), then the
    solve and the assignment's upload (`train.matcher.solve`: the card
    has nothing queued)."""
    costs = match_costs(pred_logits, pred_boxes, tgt_labels, tgt_boxes,
                        tgt_valid, cost_class, cost_bbox, cost_giou)
    with span("train.matcher.wait"):
        costs = costs.cpu().numpy()
    with span("train.matcher.solve"):
        return torch.from_numpy(solve_costs(costs)).to(pred_logits.device)
