"""Family `gpv_deform` (GPV-1 on Deformable DETR) and the four-card cell's
kernel group, added as new files: the family's reference and counts are
found by the lookup and expose what it asks for; the counts are pinned
and held to `FlopCounterMode` on the reference; the kernel kinds gain
`collective` and `msdeform` while every one-card cell's readings on a
recorded trace stay as they were; the new readers read what they say; a
launch counter that the program lacks counts nothing; the two new cells
run through the harness on the CPU, and a fault planted in the program
comes out as not correct in each."""
from __future__ import annotations

import json
import shutil
import sys
import types
from pathlib import Path

import pytest
import torch

from gpvbench import family, launch_counters, run, trace
from gpvbench.flops import launches_bound_ms
from gpvbench.tests.tiny import TINY_MODEL, merge
from gpvbench.trace import DeviceEvent, Profile, Spans, TraceData

ROOT = Path(__file__).resolve().parents[2]
CONF = json.loads((ROOT / "gpvbench" / "configs" /
                   "gpv1-deformable-r50.json").read_text())
MAN = run.manifest(ROOT)
OLD_KINDS = ("attention", "conv", "gemm", "copy")

# at the cell's sizes: B=20 480x640 images, 20 query tokens, 19 steps
PREDICT_FLOPS = 2879508664320.0
MSDEFORM_BOUND_MS = 0.5479622686567164


def test_the_family_is_found_by_the_lookup():
    assert family.name(CONF) == "gpv_deform"
    ref, counts = family.reference(CONF), family.counts(CONF)
    assert all(hasattr(ref, n) for n in family.REFERENCE)
    assert all(hasattr(counts, n) for n in family.COUNTS)
    with pytest.raises(NotImplementedError, match="no training cell"):
        counts.train_flops(CONF["model"], 10000, 120, 64, 480, 640, 20, 20)


def test_counts_at_the_cells_sizes():
    counts, model = family.counts(CONF), CONF["model"]
    assert counts.level_shapes(model, 480, 640) == [(60, 80), (30, 40),
                                                    (15, 20), (8, 10)]
    assert counts.predict_flops(model, 10000, 20, 480, 640, 20, 19) == \
        PREDICT_FLOPS
    work = counts.predict_work(model, 20, 480, 640, 20, 19)
    assert list(work) == ["attention", "msdeform"]
    samp = work["msdeform"]
    assert len(samp) == 12
    assert [(x.q, x.s) for x in samp] == [(6380, 6380)] * 6 + \
        [(300, 6380)] * 6
    assert launches_bound_ms(samp) == MSDEFORM_BOUND_MS
    # the operation's own inputs and outputs: value, offsets, logits,
    # reference points and output of the encoder's layer
    x = samp[0]
    assert x.bytes(2) == 20 * 6380 * (256 * 2 + 256 * 2 + 128 * 2 + 8 * 4
                                      + 256 * 2)
    assert x.flops() == 20 * 6380 * 8 * 16 * 32 * 10
    names = [a.name for a in work["attention"]]
    assert names == ["detr_decoder_self", "bert_self", "coattention",
                     "decode_self", "decode_cross"]
    assert work["attention"][-1].tk == 320


def test_counts_are_what_the_flop_counter_reads_on_the_reference():
    from torch.utils.flop_counter import FlopCounterMode
    ref, counts = family.reference(CONF), family.counts(CONF)
    model = merge(CONF["model"], TINY_MODEL)
    W = ref.make_weights(ref.param_spec(model, 64), 1, torch.device("cpu"))
    B, H, Wd, L = 2, 96, 128, 7
    imgs = torch.randint(0, 256, (B, H, Wd, 3), dtype=torch.uint8)
    ids = torch.randint(6, 20, (B, L))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.encode(ref.Precision("float32"), W, model, imgs, ids,
                   torch.ones(B, L, dtype=torch.bool))
    sampling = sum(x.calls * x.flops()
                   for x in counts.sampling_items(model, B, H, Wd))
    assert fc.get_total_flops() == B * counts.encode_flops(model, H, Wd, L) \
        - sampling


def test_kinds_gain_collective_and_msdeform():
    assert trace.kinds() == OLD_KINDS + ("collective", "msdeform")
    assert trace.counters()["msdeform"] == [
        "gpvbench.launch_counters:ms_deform_attn"]
    table = trace.group_table()
    assert trace.group_of("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)",
                          table) == "collective"
    assert trace.group_of("void (anonymous namespace)::gpv_msdeform_bf16_"
                          "kernel<1>(__nv_bfloat16 const*)",
                          table) == "msdeform"


# device kernels of the one-card cells' traces (their names as the
# profiler gives them), each 1 ms long, in sequence with 1 ms gaps
RECORDED = [
    "void gpv_attn::(anonymous namespace)::gpv_attn_tile_kernel<4>(x)",
    "void gpv_attn::(anonymous namespace)::gpv_attn_decode_kernel<2, "
    "false, false>(gpv_attn::(anonymous namespace)::Decode)",
    "void gpv_attn::(anonymous namespace)::gpv_attn_tile_bi_kernel<4>(x)",
    "nvjet_tst_128x288_64x4_2x1_v_bz_coopA_bias_TNT",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop>(x)",
    "Memcpy HtoD (Pageable -> Device)",
    "Memset (Device)",
    "void at::native::vectorized_elementwise_kernel<8, at::native::"
    "CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul> >(int)",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
    "<c10::BFloat16, float, false>(int, float)",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x128x8_stage3",
]


def _recorded_trace(steps_or_calls: dict) -> TraceData:
    events = [DeviceEvent(n, 2e-3 * i, 2e-3 * i + 1e-3)
              for i, n in enumerate(RECORDED * 3)]
    counts = dict(steps_or_calls, flops_per_call=1e12, flops_per_step=2e13,
                  launches={"attention": {
                      "fused_attention.tile": 3,
                      "fused_attention.decode": 3,
                      "fused_biattention.tile": 3}},
                  bound_ms={"attention": 0.5})
    p = Profile(events, 0.0, 2e-3 * len(events), counts)
    tr = TraceData({}, Spans(), p)
    tr.program = []
    return tr


def _readers(cell: str):
    """The cell's readers of the device trace (the others read the
    program's spans and counters, which no kernel group moves)."""
    _, _, layer = run.cell_entries(MAN, cell)
    return [m["name"] for m in layer if m["source"] == "device_trace"]


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]
                                  if w["chips"] == 1 and _readers(w["name"])
                                  and w["config"] != "gpv1-deformable-r50"])
def test_one_card_readings_stay_as_they_were(cell, tmp_path, monkeypatch):
    old = tmp_path / "kernels"
    old.mkdir()
    for path in (ROOT / "gpvbench" / "kernels").glob("*.json"):
        if path.stem.split("-", 1)[0] in OLD_KINDS:
            shutil.copy(path, old)
    rt = _recorded_trace({"calls": 3, "steps": 3})
    readings = {}
    for kernels in (old, trace.KERNELS):
        monkeypatch.setattr(trace, "KERNELS", kernels)
        for name in _readers(cell):
            mod = run.load_file(ROOT / "gpvbench" / "metrics" / f"{name}.py",
                                "m_" + name.replace(".", "_"))
            readings.setdefault(name, []).append(mod.read(rt))
    assert any(r[0] is not None for r in readings.values())
    for name, (before, after) in readings.items():
        assert before == after, name


def _reader(name: str):
    return run.load_file(ROOT / "gpvbench" / "metrics" / f"{name}.py",
                         "m_" + name.replace(".", "_"))


def test_msdeform_readers():
    ev = [DeviceEvent("void (anonymous namespace)::gpv_msdeform_bf16_"
                      "kernel<1>(x)", 0.01 * i, 0.01 * i + 0.004)
          for i in range(6)]
    ev.append(DeviceEvent("nvjet_tst_64x8", 0.1, 0.2))
    p = Profile(ev, 0.0, 0.3, {"calls": 2, "bound_ms": {"msdeform": 2.4},
                               "launches": {"msdeform": {
                                   "ms_deform_attn.bf16": 6}}})
    tr = TraceData({}, Spans(), p)
    assert _reader("msdeform_ms.predict").read(tr) == pytest.approx(12.0)
    assert _reader("msdeform_roofline_pct.predict").read(tr) == \
        pytest.approx(10.0)
    p.counts["launches"]["msdeform"]["ms_deform_attn.bf16"] = 7
    with pytest.raises(RuntimeError, match="msdeform launches"):
        _reader("msdeform_roofline_pct.predict").read(tr)
    # a cell whose model has no deformable attention reads nothing
    p.counts["bound_ms"] = {"attention": 1.0}
    assert _reader("msdeform_roofline_pct.predict").read(tr) is None


def test_allreduce_readers():
    nccl = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)"
    ev = [DeviceEvent("void at::native::elementwise_kernel", 0.0, 0.010),
          DeviceEvent(nccl, 0.006, 0.016),         # 4 ms hidden, 6 exposed
          DeviceEvent(nccl, 0.020, 0.022),         # 2 ms exposed
          DeviceEvent("nvjet_tst", 0.021, 0.030)]  # hides 1 ms of it
    p = Profile(ev, 0.0, 0.040, {"steps": 2})
    tr = TraceData({}, Spans(), p)
    assert _reader("allreduce_ms.train").read(tr) == pytest.approx(6.0)
    assert _reader("allreduce_exposed_ms.train").read(tr) == \
        pytest.approx(3.5)
    one_card = TraceData({}, Spans(), Profile(ev[:1], 0.0, 0.04,
                                              {"steps": 2}))
    assert _reader("allreduce_ms.train").read(one_card) is None
    assert _reader("allreduce_exposed_ms.train").read(one_card) is None


def test_a_counter_the_program_lacks_counts_nothing(monkeypatch):
    absent = launch_counters.program_counter("gpv_tpu_torch.ops.no_such",
                                             "op")
    assert absent.variant_launches == {}
    from gpv_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    assert launch_counters.ms_deform_attn is ms_deform_attn
    broken = types.ModuleType("gpvbench_broken_counter")
    monkeypatch.setitem(sys.modules, "gpvbench_broken_counter", broken)
    with pytest.raises(AttributeError):
        launch_counters.program_counter("gpvbench_broken_counter", "op")


def _alter_a_token(monkeypatch):
    """Every row's fourth served token one id further."""
    import gpv_tpu_torch.engine as engine
    real = engine.greedy_decode

    def altered(*args, **kwargs):
        tokens, logits, steps = real(*args, **kwargs)
        tokens[:, 3] = (tokens[:, 3] + 1) % 60
        return tokens, logits, steps
    monkeypatch.setattr(engine, "greedy_decode", altered)


def _float8_sampling(monkeypatch):
    """The deformable sampling's value and logits rounded to float8 e4m3
    (one scale a tensor) before the op."""
    import gpv_tpu_torch.nn.deformable_transformer as dt
    real = dt.ms_deform_attn

    def q8(x):
        scale = x.float().abs().amax().clamp_min(1e-30) / 448.0
        return ((x.float() / scale).to(torch.float8_e4m3fn).float()
                * scale).to(x.dtype)
    monkeypatch.setattr(dt, "ms_deform_attn",
                        lambda v, sh, r, o, lg: real(q8(v), sh, r, o, q8(lg)))


def _state_unchanged(monkeypatch):
    """Rank 0's AdamW skips its update."""
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


def _none(monkeypatch):
    """No fault."""


@pytest.mark.parametrize("cell,fault", [
    ("predict-greedy-deform", _none), ("predict-greedy-deform",
                                       _alter_a_token),
    ("predict-greedy-deform", _float8_sampling),
    ("train-ddp4-r50", _none), ("train-ddp4-r50", _state_unchanged)],
    ids=["deform-none", "deform-token", "deform-float8", "ddp4-none",
         "ddp4-unchanged"])
def test_the_new_cells_faults_are_not_correct(cell, fault, monkeypatch):
    """The new cells through the harness at tiny widths on the CPU (the
    four-card cell as two gloo ranks), clean and with a fault planted in
    the program (rank 0's, for the four-card cell)."""
    import time

    from gpvbench.tests.tiny import TINY_LIMITS, tiny
    fault(monkeypatch)
    ctx = tiny(run.make_ctx(MAN, cell, 5, 1.0, False, "cpu",
                            time.perf_counter(), ROOT))
    ctx.config = merge(ctx.config, {"limits": TINY_LIMITS})
    if cell == "train-ddp4-r50":
        ctx.traffic["ranks"] = 2
    ctx.log = lambda line: None
    out = run.run_cell(MAN, ctx)
    assert out["correct"] is (fault is _none), out["checks"]
    if fault is _float8_sampling:
        assert out["checks"]["msdeform_err"]["value"] > \
            out["checks"]["msdeform_err"]["limit"], out["checks"]
