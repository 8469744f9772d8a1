"""The port's offline prediction pipeline and eval CLIs against `gpv_tpu`,
on the CPU: the batch loader in each mode, `predict_dataset` /
`make_predictions` / `evaluate_predictions` through a JAX engine and a port
engine on the same fp32 weights (a reference `.pth`), and the CLIs
`compute_predictions`, `compute_test_predictions`, `predict_folder` and
`check_parity` against their JAX counterparts.
"""
import glob
import json
import re
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpv_tpu.datasets import coco as jax_coco
from gpv_tpu.engine import GPVEngine as JaxEngine
from gpv_tpu.infer import predictions as jax_predictions
from gpv_tpu.models.gpv import build_gpv as jax_build_gpv
from gpv_tpu.text.vocab import AnswerVocab as JaxVocab
from gpv_tpu.text.wordpiece import WordPieceTokenizer as JaxTok
from gpv_tpu.utils.config import load_config as jax_load_config

from gpv_tpu_torch.datasets import coco
from gpv_tpu_torch.infer import predictions
from gpv_tpu_torch.infer.build import build_engine
from gpv_tpu_torch.utils.config import load_config
from gpv_tpu_torch.weights import state_dict_from_jax

from _fake_data import IMG_H, IMG_W, TINY_OVERRIDES, make_fake_data
from test_torch_port_config import _random_batch_stats

ROOT = Path(__file__).resolve().parent.parent
TASK_CONFIG = {"CocoCaptioning": "coco_captioning",
               "CocoDetection": "coco_detection",
               "CocoClassification": "coco_classification",
               "CocoVqa": "coco_vqa", "RefCocop": "refcocop"}
BOX_TOL, REL_TOL = 2e-4, 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def at_repo_root(monkeypatch):
    """The CLIs read `configs/` relative to the working directory."""
    monkeypatch.chdir(ROOT)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The fake COCO tree, with `original_split` copies of the VQA and
    captioning samples for the test-server CLIs."""
    root = make_fake_data(tmp_path_factory.mktemp("gpv_data"))
    lpd = root / "learning_phase_data"
    for task in ("coco_captions", "coco_vqa"):
        d = lpd / task / "original_split"
        d.mkdir()
        (d / "val.json").write_text(
            (lpd / task / "gpv_split/val.json").read_text())
    return root


def _overrides(data_dir, exp_dir="exp"):
    return [f"data_dir={data_dir}", f"output_dir={data_dir}/{exp_dir}",
            "exp_name=e2e",
            "task_configs.image_size={H: %d, W: %d}" % (IMG_H, IMG_W)
            ] + TINY_OVERRIDES


@pytest.fixture(scope="module")
def bridge(data_dir, tmp_path_factory):
    """(JAX engine, .pth of its variables, port engine from that .pth)."""
    cfg = jax_load_config(ROOT / "configs", "exp/gpv",
                          _overrides(data_dir))
    vocab = JaxVocab.debug()
    model = jax_build_gpv(cfg.model, vocab_size=len(vocab))
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, IMG_H, IMG_W, 3)), jnp.zeros((1, 5), jnp.int32),
        jnp.zeros((1, 4), jnp.int32)))(jax.random.PRNGKey(3))
    variables = _random_batch_stats(variables, seed=1)
    path = tmp_path_factory.mktemp("ckpt") / "model.pth"
    torch.save({"model": {f"module.{k}": v for k, v in
                          state_dict_from_jax(variables).items()}}, path)
    jax_engine = JaxEngine(model, variables, vocab, JaxTok.debug())
    engine = build_engine(load_config(
        ROOT / "configs", "exp/gpv", _overrides(data_dir)
        + [f"ckpt={path}", "device=cpu", "tpu.dtype=float32"]))
    return jax_engine, path, engine


def _datasets(data_dir, task, subset="val"):
    over = _overrides(data_dir)
    jcfg = jax_load_config(ROOT / "configs", "exp/gpv", over)
    cfg = load_config(ROOT / "configs", "exp/gpv", over)
    node = TASK_CONFIG[task]
    return (jax_coco.DATASET_CLASSES[task](jcfg.task_configs[node], subset),
            coco.DATASET_CLASSES[task](cfg.task_configs[node], subset))


# ------------------------------------------------------------------ loader

class _SyntheticImageDataset:
    """Index-deterministic items that also record the rng's first draw."""

    def __init__(self, n=10, hw=(24, 32)):
        self.n, self.hw = n, hw

    def __len__(self):
        return self.n

    def get(self, i, rng):
        img = np.random.RandomState(1000 + i).randint(
            0, 255, (*self.hw, 3), dtype=np.uint8)
        return {"image": img, "query": f"what is {i}?", "idx": i,
                "draw": rng.rand()}


def _collect(batches):
    return [([{**it, "image": np.array(it["image"])} for it in items], n)
            for items, n in batches]


@pytest.mark.parametrize("kw", [
    {}, {"num_workers": 3, "loader": "threads"},
    {"num_workers": 3, "loader": "processes"},
    {"num_workers": 2, "loader": "processes", "prefetch": 1}],
    ids=["sequential", "threads", "processes", "processes_prefetch1"])
def test_loader_modes_give_the_jax_batches(kw):
    ds = _SyntheticImageDataset(n=10)
    want = _collect(jax_predictions.iter_padded_batches(ds, 4))
    got = _collect(predictions.iter_padded_batches(ds, 4, **kw))
    assert [n for _, n in got] == [n for _, n in want] == [4, 4, 2]
    for (g_items, _), (w_items, _) in zip(got, want):
        assert len(g_items) == 4
        for g, w in zip(g_items, w_items):
            assert (g["idx"], g["query"], g["draw"]) == \
                (w["idx"], w["query"], w["draw"])
            np.testing.assert_array_equal(g["image"], w["image"])
            assert g["image"].base is None  # owns its memory


def test_loader_modes_on_a_coco_dataset(data_dir):
    _, ds = _datasets(data_dir, "CocoClassification")
    runs = [_collect(predictions.iter_padded_batches(ds, 4, **kw))
            for kw in ({}, {"num_workers": 2, "loader": "threads"},
                       {"num_workers": 2, "loader": "processes"})]
    for other in runs[1:]:
        for (a, na), (b, nb) in zip(runs[0], other):
            assert na == nb
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x["image"], y["image"])
                assert x["sample"] == y["sample"]


def test_process_loader_frees_shared_memory():
    ds = _SyntheticImageDataset(n=8)
    before = set(glob.glob("/dev/shm/psm_*"))
    for _ in predictions.iter_padded_batches(ds, 4, num_workers=2,
                                             loader="processes"):
        pass
    gen = predictions.iter_padded_batches(ds, 4, num_workers=2,
                                          loader="processes")
    next(gen)
    gen.close()
    assert not set(glob.glob("/dev/shm/psm_*")) - before


def test_unknown_loader_rejected():
    with pytest.raises(ValueError, match="threads|processes"):
        next(predictions.iter_padded_batches(_SyntheticImageDataset(), 4,
                                             num_workers=2, loader="mpi"))


# ------------------------------------------------------- predict_dataset

def test_predict_dataset_threads_equal_processes(bridge, data_dir):
    _, _, engine = bridge
    _, ds = _datasets(data_dir, "CocoDetection")
    runs = [predictions.predict_dataset(engine, ds, "CocoDetection", 4,
                                        num_workers=2, loader=loader)
            for loader in ("threads", "processes")]
    (p1, b1), (p2, b2) = runs
    assert p1 == p2 and list(b1) == list(b2) == [str(200 + i)
                                                for i in range(6)]
    for k in b1:
        for f in ("boxes", "relevance"):
            np.testing.assert_array_equal(b1[k][f], b2[k][f])


def test_predict_dataset_caps_batches_and_keeps_real_rows(bridge, data_dir):
    _, _, engine = bridge
    _, ds = _datasets(data_dir, "CocoVqa")
    preds, boxes = predictions.predict_dataset(engine, ds, "CocoVqa", 4,
                                               num_eval_batches=1)
    assert list(preds) == [400, 401, 402, 403] and len(boxes) == 4
    preds, boxes = predictions.predict_dataset(engine, ds, "CocoVqa", 4)
    assert list(preds) == [400 + i for i in range(6)]  # no padded row


def test_predict_dataset_refuses_a_repeated_id(bridge, data_dir):
    _, _, engine = bridge
    _, ds = _datasets(data_dir, "CocoVqa")
    ds.samples[3]["question_id"] = ds.samples[1]["question_id"]
    with pytest.raises(ValueError, match="occurs twice"):
        predictions.predict_dataset(engine, ds, "CocoVqa", 4)


def test_in_memory_boxes_score_as_the_h5_file(bridge, data_dir, tmp_path):
    _, _, engine = bridge
    _, ds = _datasets(data_dir, "RefCocop")
    preds, boxes_path, _ = predictions.make_predictions(
        engine, ds, "RefCocop", 4, tmp_path, "val")
    _, boxes = predictions.predict_dataset(engine, ds, "RefCocop", 4)
    img_dir = ds.cfg.image_dir
    from_file = predictions.evaluate_predictions(
        "RefCocop", ds.samples, preds, boxes_path, tmp_path, "val",
        image_dir=img_dir)
    in_memory = predictions.evaluate_predictions(
        "RefCocop", ds.samples, preds, boxes, tmp_path / "mem", "val",
        image_dir=img_dir)
    assert from_file == in_memory


# ----------------------------------------------------- files against JAX

_PROBS = re.compile(r'"answer_probs": \[[^\]]*\]')


def _same_h5(got_path, want_path):
    with h5py.File(got_path, "r") as g, h5py.File(want_path, "r") as w:
        assert list(g) == list(w)
        for k in w:
            assert list(g[k]) == list(w[k]) == ["boxes", "relevance"]
            for f, tol in (("boxes", BOX_TOL), ("relevance", REL_TOL)):
                a, b = g[k][f][()], w[k][f][()]
                assert a.dtype == b.dtype and a.shape == b.shape, (k, f)
                np.testing.assert_allclose(a, b, atol=tol, rtol=0)


@pytest.mark.parametrize("task,beam", [
    ("CocoVqa", None), ("CocoCaptioning", None), ("CocoDetection", None),
    ("CocoClassification", None), ("RefCocop", None), ("CocoVqa", 3)],
    ids=["vqa", "captioning", "detection", "classification", "refcocop",
         "vqa_beam3"])
def test_files_match_jax(task, beam, bridge, data_dir, tmp_path):
    """make_predictions + evaluate_predictions through both packages:
    the same predictions JSON text (beam probabilities within 2e-3), the
    same HDF5 layout, boxes and relevance within tolerance, the same
    metrics file."""
    jax_engine, _, engine = bridge
    jax_ds, ds = _datasets(data_dir, task)
    img_dir = ds.cfg.image_dir if task in ("CocoDetection",
                                           "RefCocop") else None
    out = {}
    for name, mod, eng, d in (("jax", jax_predictions, jax_engine, jax_ds),
                              ("port", predictions, engine, ds)):
        eval_dir = tmp_path / name
        preds, boxes_path, pred_path = mod.make_predictions(
            eng, d, task, 4, eval_dir, "val", beam_size=beam)
        metrics = mod.evaluate_predictions(
            task, json.loads(json.dumps(d.samples)), preds, boxes_path,
            eval_dir, "val", image_dir=img_dir)
        out[name] = (pred_path, boxes_path, metrics,
                     eval_dir / f"{task}_gpv_split_val_metrics.json")
    (gp, gb, gm, gmp), (wp, wb, wm, wmp) = out["port"], out["jax"]
    assert gp.name == wp.name and gb.name == wb.name
    got, want = gp.read_text(), wp.read_text()
    if beam:
        assert _PROBS.sub("P", got) == _PROBS.sub("P", want)
        for k, w in json.loads(want).items():
            g = json.loads(got)[k]
            assert g["answers"][0] == g["answer"] and len(g["answers"]) == 3
            np.testing.assert_allclose(g["answer_probs"], w["answer_probs"],
                                       rtol=2e-3, atol=1e-12)
    else:
        assert got == want
    assert len(json.loads(got)) == 6
    _same_h5(gb, wb)
    assert gm == wm and gmp.read_text() == wmp.read_text()


def test_compute_test_predictions_functions_match_jax(bridge, data_dir,
                                                      tmp_path):
    jax_engine, _, engine = bridge
    for task, jfn, fn in (
            ("CocoVqa", jax_predictions.compute_vqa_test_predictions,
             predictions.compute_vqa_test_predictions),
            ("CocoCaptioning", jax_predictions.compute_cap_test_predictions,
             predictions.compute_cap_test_predictions)):
        jax_ds, ds = _datasets(data_dir, task)
        want = jfn(jax_engine, jax_ds, 4, tmp_path / f"j{task}.json")
        got = fn(engine, ds, 4, tmp_path / f"p{task}.json", num_workers=2,
                 loader="processes")
        assert got == want and len(got) == 6
        assert (tmp_path / f"p{task}.json").read_text() == \
            (tmp_path / f"j{task}.json").read_text()


# -------------------------------------------------------------------- CLIs

def _port_cli(data_dir, pth, exp, extra):
    return _overrides(data_dir, exp) + [
        f"eval.ckpt={pth}", "device=cpu", "tpu.dtype=float32",
        "eval.batch_size=4", "eval.num_workers=2"] + extra


@pytest.mark.parametrize("task", ["CocoVqa", "CocoDetection"])
def test_compute_predictions_cli_matches_jax(task, bridge, data_dir,
                                             monkeypatch, capsys):
    """The JAX CLI gets the JAX engine on the same weights (its own
    `.pth` converter is fixed to released depths); the port CLI loads the
    `.pth` itself. Then eval.predict=False re-scores the port's files."""
    import gpv_tpu.cli.compute_predictions as jax_cli
    import gpv_tpu.infer.build as jax_build
    from gpv_tpu_torch.cli import compute_predictions as cli

    jax_engine, pth, _ = bridge
    monkeypatch.setattr(jax_build, "build_engine", lambda cfg: jax_engine)
    args = [f"eval.task={task}", "eval.loader=processes"]
    want = jax_cli.main(_port_cli(data_dir, pth, f"cj{task}", args))
    got = cli.main(_port_cli(data_dir, pth, f"cp{task}", args))
    assert got == want
    eval_dir = Path(f"{data_dir}/cp{task}/e2e/eval")
    files = sorted(p.name for p in eval_dir.iterdir())
    assert files == sorted(p.name for p in Path(
        f"{data_dir}/cj{task}/e2e/eval").iterdir())
    assert (eval_dir / f"{task}_gpv_split_val_predictions.json"
            ).read_text() == Path(
        f"{data_dir}/cj{task}/e2e/eval/{task}_gpv_split_val_predictions.json"
    ).read_text()
    capsys.readouterr()
    again = cli.main(_port_cli(data_dir, "/nonexistent.pth", f"cp{task}",
                               args + ["eval.predict=False", "eval.ckpt=null"]))
    assert again == got
    assert str(got["everything"]) in capsys.readouterr().out


def test_compute_predictions_cli_refuses_a_missing_ckpt(data_dir):
    from gpv_tpu_torch.cli import compute_predictions as cli
    with pytest.raises(SystemExit, match="eval.ckpt not found"):
        cli.main(_port_cli(data_dir, "/nonexistent/model.pth", "cx", []))


@pytest.mark.parametrize("kind", ["vqa", "cap"])
def test_compute_test_predictions_cli_matches_jax(kind, bridge, data_dir,
                                                  monkeypatch, capsys):
    import gpv_tpu.cli.compute_test_predictions as jax_cli
    import gpv_tpu.infer.build as jax_build
    from gpv_tpu_torch.cli import compute_test_predictions as cli

    jax_engine, pth, _ = bridge
    monkeypatch.setattr(jax_build, "build_engine", lambda cfg: jax_engine)
    jax_cli.main(_port_cli(data_dir, pth, f"tj{kind}", [f"kind={kind}"]))
    cli.main(_port_cli(data_dir, pth, f"tp{kind}", [f"kind={kind}"]))
    name = f"e2e/eval/{kind}_val_predictions.json"
    got = Path(f"{data_dir}/tp{kind}/{name}").read_text()
    assert got == Path(f"{data_dir}/tj{kind}/{name}").read_text()
    assert len(json.loads(got)) == 6
    assert capsys.readouterr().out.count("wrote ") == 2


# ----------------------------------------------------------- predict_folder

@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (48, 64, 3), np.uint8)).save(
            d / f"img_{i}.png")
    # palette and RGBA PNGs must decode to RGB pixels
    Image.fromarray(rng.randint(0, 255, (48, 64, 3), np.uint8)).convert(
        "P", palette=Image.ADAPTIVE).save(d / "img_2_palette.png")
    Image.fromarray(rng.randint(0, 255, (40, 56, 4), np.uint8),
                    "RGBA").save(d / "img_3_rgba.png")
    (d / "notes.txt").write_text("not an image")
    return d


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("extra", [
    ["query=what is this?", "num_output_boxes=3"],
    ["queries={qfile}", "task=classification"],
    ["query=q", "resize=false", "task=classification_syns"]],
    ids=["query", "queries_classification", "native_syns"])
def test_predict_folder_matches_jax(extra, bridge, image_dir, tmp_path,
                                    monkeypatch):
    import gpv_tpu.cli.predict_folder as jax_cli
    import gpv_tpu.infer.build as jax_build
    from gpv_tpu_torch.cli import predict_folder as cli

    jax_engine, pth, _ = bridge
    monkeypatch.setattr(jax_build, "build_engine", lambda cfg: jax_engine)
    qfile = tmp_path / "queries.txt"
    qfile.write_text("\n".join(f"query {i}" for i in range(4)))
    extra = [e.format(qfile=qfile) for e in extra]
    common = [f"images={image_dir}", "batch=3",
              "task_configs.image_size={H: 48, W: 64}"] + TINY_OVERRIDES
    jax_cli.main(common + extra + ["ckpt=null", f"out={tmp_path}/j.jsonl"])
    cli.main(common + extra + [f"ckpt={pth}", "device=cpu",
                               "tpu.dtype=float32", f"out={tmp_path}/p.jsonl"])
    got, want = _rows(tmp_path / "p.jsonl"), _rows(tmp_path / "j.jsonl")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert (g["file"], g["query"], g["answer"]) == \
            (w["file"], w["query"], w["answer"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=BOX_TOL)
        np.testing.assert_allclose(g["relevance"], w["relevance"],
                                   atol=REL_TOL)


@pytest.mark.parametrize("args,match", [
    (["queries={bad}"], "paired"), (["task=clasification"], "unknown task"),
    (["images={empty}"], "no images"), (["query=q"], "ckpt=")],
    ids=["query_count", "unknown_task", "empty_dir", "missing_ckpt"])
def test_predict_folder_fails_fast(args, match, image_dir, tmp_path):
    from gpv_tpu_torch.cli import predict_folder as cli
    bad = tmp_path / "bad.txt"
    bad.write_text("only one line")
    (tmp_path / "empty").mkdir()
    args = [a.format(bad=bad, empty=tmp_path / "empty") for a in args]
    with pytest.raises(SystemExit, match=match):
        cli.main([f"images={image_dir}"] + args + TINY_OVERRIDES)


def test_load_rgb_converts_palette_and_rgba(image_dir):
    from PIL import Image

    from gpv_tpu_torch.cli.predict_folder import load_rgb
    from gpv_tpu_torch.datasets.image import load_image
    for name in ("img_2_palette.png", "img_3_rgba.png"):
        got = load_rgb(image_dir / name)
        assert got.dtype == np.uint8 and got.shape[2] == 3
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(image_dir / name).convert("RGB")))
    assert load_image(image_dir / "img_2_palette.png").ndim == 3  # tiled


@pytest.mark.parametrize("cli", ["compute_predictions",
                                 "compute_test_predictions",
                                 "predict_folder", "check_parity"])
def test_eval_clis_default_to_the_card(cli, bridge, data_dir, image_dir):
    """Without `device=`, each CLI builds its engine on the card, and
    refuses to run where there is none."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    _, pth, _ = bridge
    args = {
        "compute_predictions": _overrides(data_dir) + [f"eval.ckpt={pth}"],
        "compute_test_predictions": _overrides(data_dir) + [
            f"eval.ckpt={pth}", "kind=cap"],
        "predict_folder": [f"images={image_dir}", f"ckpt={pth}"]
        + TINY_OVERRIDES,
        "check_parity": [f"ckpt={pth}", f"image={image_dir}/img_0.png",
                         "query=q"] + TINY_OVERRIDES}[cli]
    main = importlib.import_module(f"gpv_tpu_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args)


# ------------------------------------------------------------ check_parity

def test_check_parity_round_trip_with_jax(bridge, tmp_path, capsys,
                                          monkeypatch):
    """JAX saves goldens from the `.pth`; the port, loading the same file
    with no converter, meets them (exact resize), and its own goldens
    agree with JAX's. The JAX CLI's eager random init, which it replaces
    with the converted weights at once, is skipped (about 25 s here)."""
    from PIL import Image

    from gpv_tpu.cli import check_parity as jax_cli
    from gpv_tpu_torch.cli import check_parity as cli

    init = JaxEngine.from_config.__func__
    monkeypatch.setattr(JaxEngine, "from_config", classmethod(
        lambda cls, *a, **kw: init(cls, *a, variables={"params": {}}, **kw)))
    _, pth, _ = bridge
    img = tmp_path / "img.png"
    Image.fromarray(np.random.RandomState(8).randint(
        0, 255, (40, 56, 3), np.uint8)).save(img)
    common = [f"ckpt={pth}", f"image={img}", "query=what is this?",
              "resize=true", "task_configs.image_size={H: 48, W: 64}"
              ] + TINY_OVERRIDES
    assert jax_cli.main(common + [f"save={tmp_path}/j.json"]) == 0
    capsys.readouterr()
    assert cli.main(common + [f"expect={tmp_path}/j.json", "atol=5e-4",
                              "device=cpu"]) == 0
    assert "PARITY OK" in capsys.readouterr().out
    assert cli.main(common + [f"save={tmp_path}/p.json", "device=cpu"]) == 0
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert got["answer"] == want["answer"]
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=BOX_TOL)
    # a wrong golden fails
    want["answer"] += "x"
    (tmp_path / "bad.json").write_text(json.dumps(want))
    assert cli.main(common + [f"expect={tmp_path}/bad.json",
                              "device=cpu"]) == 1
