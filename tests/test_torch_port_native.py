"""The port's native host runtime (`gpv_tpu_torch.native`) against the JAX
package's (`gpv_tpu.native`, the same sources built with the same flags)
and against scipy, on the CPU: the uint8 resize, the fused colour jitter
inside the train transforms, the batched linear-assignment solver behind
`ops.matcher.solve_costs`, and a build that fails."""
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from gpv_tpu import native as jax_native
from gpv_tpu.datasets import transforms as jax_transforms

from gpv_tpu_torch import native
from gpv_tpu_torch.datasets import transforms
from gpv_tpu_torch.datasets.image import resize_uint8
from gpv_tpu_torch.native import build
from gpv_tpu_torch.ops.matcher import solve_costs

TASKS = ("CocoCaptioning", "CocoDetection", "CocoClassification", "CocoVqa")


@pytest.mark.parametrize("src,dst", [
    ((96, 128), (48, 64)), ((48, 64), (97, 131)), ((480, 640), (480, 640)),
    ((427, 640), (480, 640)), ((640, 480), (480, 640)), ((7, 5), (3, 11)),
    ((1, 1), (4, 4))], ids=lambda s: "x".join(map(str, s)))
def test_resize_is_bit_equal_to_jax(src, dst):
    img = np.random.RandomState(sum(src)).randint(
        0, 256, (*src, 3)).astype(np.uint8)
    want = jax_native.resize_bilinear_native(img, *dst)
    calls = native.resize_bilinear_native.calls
    got = resize_uint8(img, *dst, method="native")
    assert got.dtype == np.uint8 and got.shape == (*dst, 3)
    np.testing.assert_array_equal(got, want)
    assert native.resize_bilinear_native.calls == calls + 1


@pytest.mark.parametrize("task", TASKS)
def test_train_stacks_on_the_fused_jitter_match_jax(task, monkeypatch):
    """Each task's stack with the fused jitter, over 40 seeds: bit-equal to
    the JAX stack on its own fused jitter, the same random stream consumed
    (the next draw agrees), and the C++ jitter really ran."""
    monkeypatch.setattr(jax_transforms, "_NATIVE", None)  # build, use C++
    img = np.random.RandomState(5).randint(0, 256, (36, 52, 3)).astype(
        np.uint8)
    calls = native.color_jitter_native.calls
    for seed in range(40):
        r_got, r_want = (np.random.RandomState(seed) for _ in range(2))
        got = transforms.train_transforms(task)(img, r_got)
        want = jax_transforms.train_transforms(task)(img, r_want)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert r_got.rand() == r_want.rand()
    assert jax_transforms._NATIVE is True
    assert native.color_jitter_native.calls > calls


@pytest.mark.parametrize("cls,args", [
    (transforms.ColorJitter, (0.4, 0.4, 0.4, 0.1)),
    (transforms.ColorJitter, (0.2, 0.2, 0.2, 0.0)),
    (transforms.RandomGrayscale, (0.5,))], ids=["jitter_hue", "jitter",
                                                "grayscale"])
def test_fused_and_numpy_paths_draw_the_same_stream(cls, args):
    """native=True and native=False consume the same draws and agree to
    float32 rounding (the fused pass keeps fp32 where numpy widens)."""
    img = np.random.RandomState(9).randint(0, 256, (24, 32, 3)).astype(
        np.uint8)
    for seed in range(20):
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        a = np.asarray(cls(*args)(img, r1, native=True), np.float32)
        b = np.asarray(cls(*args)(img, r2, native=False), np.float32)
        np.testing.assert_allclose(a, b, atol=2e-3)
        assert r1.rand() == r2.rand()


def _scipy_total(cost):
    rows, cols = linear_sum_assignment(cost)
    return float(cost[rows, cols].sum())


@pytest.mark.parametrize("shape", [(6, 8, 8), (5, 4, 10), (3, 1, 7),
                                   (120, 8, 100)], ids=str)
def test_batched_lsap_reaches_scipys_optimum(shape):
    """Every image's total cost equals scipy's; the assignment is a
    matching (distinct columns) and equals the JAX package's solver's."""
    cost = np.random.RandomState(shape[0]).rand(*shape).astype(np.float32)
    got = native.solve_lsap_native(cost)
    np.testing.assert_array_equal(got, jax_native.solve_lsap_native(cost))
    for b in range(shape[0]):
        assert len(set(got[b])) == shape[1]
        total = float(cost[b, np.arange(shape[1]), got[b]].sum())
        assert total == pytest.approx(_scipy_total(cost[b]), rel=1e-6)


def test_solve_costs_keeps_real_rows_optimal_under_zero_padding():
    """The matcher pads ragged targets with zero-cost rows: the real rows'
    total stays scipy's optimum of the unpadded problem, and with distinct
    random costs their assignment is scipy's."""
    rng = np.random.RandomState(0)
    n_real = (1, 3, 5, 8)
    costs = np.zeros((len(n_real), 8, 20), np.float32)
    for b, n in enumerate(n_real):
        costs[b, :n] = rng.rand(n, 20)
    got = solve_costs(costs)
    assert got.dtype == np.int64 and got.shape == (4, 8)
    for b, n in enumerate(n_real):
        rows, cols = linear_sum_assignment(costs[b, :n])
        np.testing.assert_array_equal(got[b, rows], cols)
        assert len(set(got[b])) == 8


def test_lsap_refuses_more_rows_than_columns():
    with pytest.raises(ValueError, match="own column"):
        native.solve_lsap_native(np.zeros((2, 5, 3), np.float32))
    with pytest.raises(ValueError, match="own query"):
        solve_costs(np.zeros((1, 5, 3), np.float32))


def test_a_failed_build_raises(monkeypatch):
    """No fallback: a compiler that cannot run is an error naming it."""
    monkeypatch.setenv("CXX", "/nonexistent/bin/g++")
    with pytest.raises(RuntimeError, match="/nonexistent/bin/g"):
        build.build_native(force=True)


def test_a_failed_compile_raises_with_the_compiler_output(monkeypatch,
                                                          tmp_path):
    bad = tmp_path / "lap.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "_DIR", tmp_path)
    (tmp_path / "imageproc.cc").write_text("")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="lap.cc"):
        build.build_native()
    assert not list((tmp_path / "_build").glob(".*"))
