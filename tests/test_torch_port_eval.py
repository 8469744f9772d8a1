"""The port's offline-eval data and metrics against `gpv_tpu`, on the CPU:
every COCO task dataset (eval and training, every host resize, the fused
C++ jitter and its numpy reference), the PTB
rules, BLEU, CIDEr-D, VOC AP and the five evaluators under each novelty
split, on the same seeded inputs.
"""
import functools
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from gpv_tpu.datasets import coco as jax_coco
from gpv_tpu.datasets import transforms as jax_transforms
from gpv_tpu.evaluation import (EVALUATOR_CLASSES as JAX_EVALUATORS,
                                bleu_corpus as jax_bleu, cider_d as jax_cider,
                                ptb_tokenize as jax_ptb, voc_ap as jax_voc_ap)
from gpv_tpu.utils.config import load_config as jax_load_config

from gpv_tpu_torch.datasets import coco
from gpv_tpu_torch.datasets import transforms
from gpv_tpu_torch.evaluation import (EVALUATOR_CLASSES, bleu_corpus,
                                      cider_d, coco_synonyms, ptb_tokenize,
                                      voc_ap)
from gpv_tpu_torch.utils.config import load_config

from _fake_data import IMG_H, IMG_W, TINY_OVERRIDES, make_fake_data

ROOT = Path(__file__).resolve().parent.parent

# dataset class -> its task config node
TASK_CONFIG = {
    "CocoCaptioning": "coco_captioning", "CocoDetection": "coco_detection",
    "CocoClassification": "coco_classification", "CocoVqa": "coco_vqa",
    "RefCocop": "refcocop",
    "CocoVqaTestOriginalSplitDataset": "coco_vqa",
    "CocoCapTestOriginalSplitDataset": "coco_captioning",
}
TEST_SPLITS = ("CocoVqaTestOriginalSplitDataset",
               "CocoCapTestOriginalSplitDataset")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The fake COCO tree, plus `original_split` sample files in which
    several captions share an image (the captioning test split dedups
    them per image)."""
    root = make_fake_data(tmp_path_factory.mktemp("gpv_data"))
    lpd = root / "learning_phase_data"
    for task in ("coco_captions", "coco_vqa"):
        samples = json.loads((lpd / task / "gpv_split/val.json").read_text())
        for j, s in enumerate(samples):
            s["image"] = {"subset": "train2014", "image_id": j // 2}
        d = lpd / task / "original_split"
        d.mkdir()
        for subset in ("train", "val"):
            (d / f"{subset}.json").write_text(json.dumps(samples))
    return root


def _overrides(data_dir, resize, split):
    return [f"data_dir={data_dir}", f"output_dir={data_dir}/exp",
            "exp_name=e2e", "learning_datasets=all",
            "task_configs.image_size={H: %d, W: %d}" % (IMG_H, IMG_W),
            f"task_configs.host_resize={resize}",
            f"task_configs.data_split={split}"] + TINY_OVERRIDES


def _configs(data_dir, resize, split="gpv_split"):
    over = _overrides(data_dir, resize, split)
    return (jax_load_config(ROOT / "configs", "exp/gpv", over),
            load_config(ROOT / "configs", "exp/gpv", over))


def _pin_jitter(monkeypatch, native: bool):
    """Both packages' ColorJitter and RandomGrayscale on the fused C++
    jitter (`native`) or on numpy."""
    monkeypatch.setattr(jax_transforms, "_NATIVE", None if native else False)
    for cls in (transforms.ColorJitter, transforms.RandomGrayscale):
        monkeypatch.setattr(cls, "__call__", functools.partialmethod(
            cls.__call__, native=native))


def _same_item(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


@pytest.mark.parametrize("native", [True, False], ids=["cxx", "numpy"])
@pytest.mark.parametrize("resize", ["pil", "exact", "native"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(TASK_CONFIG))
def test_dataset_items_match_jax(name, training, resize, native, data_dir,
                                 monkeypatch):
    """`get(i, RandomState(i))`: bit-equal pixels, equal boxes, answers
    and the other fields, both packages on the same jitter path."""
    _pin_jitter(monkeypatch, native)
    split = "original_split" if name in TEST_SPLITS else "gpv_split"
    jcfg, cfg = _configs(data_dir, resize, split)
    node = TASK_CONFIG[name]
    want_ds = jax_coco.DATASET_CLASSES[name](jcfg.task_configs[node], "val"
                                             if not training else "train",
                                             training)
    got_ds = coco.DATASET_CLASSES[name](cfg.task_configs[node], "val"
                                        if not training else "train",
                                        training)
    assert got_ds.samples == want_ds.samples and len(got_ds) == len(want_ds)
    if name == "CocoCapTestOriginalSplitDataset" and not training:
        assert len(got_ds) == 3  # six captions of three images
    for i in range(len(got_ds)):
        _same_item(got_ds.get(i, np.random.RandomState(i)),
                   want_ds.get(i, np.random.RandomState(i)))


@pytest.mark.parametrize("native", [True, False], ids=["cxx", "numpy"])
def test_multitask_dataset_matches_jax(data_dir, native, monkeypatch):
    _pin_jitter(monkeypatch, native)
    jcfg, cfg = _configs(data_dir, "native" if native else "pil")
    want = jax_coco.CocoMultitaskDataset(jcfg.learning_datasets,
                                         jcfg.task_configs, "train", True)
    got = coco.CocoMultitaskDataset(cfg.learning_datasets, cfg.task_configs,
                                    "train", True)
    assert got.names == want.names and len(got) == len(want) == 24
    for i in range(0, len(got), 4):
        _same_item(got.get(i, np.random.RandomState(i)),
                   want.get(i, np.random.RandomState(i)))


def test_max_samples_and_box_normalisation(data_dir):
    jcfg, cfg = _configs(data_dir, "pil")
    node = cfg.task_configs.coco_detection
    node.max_samples.val = 2
    ds = coco.CocoDetection(node, "val")
    assert len(ds) == 2
    item = ds.get(0, np.random.RandomState(0))
    # (10, 10, 40, 30) on a 128 x 96 image -> normalised cxcywh
    np.testing.assert_allclose(item["boxes"][0],
                               [30 / 128, 25 / 96, 40 / 128, 30 / 96],
                               rtol=1e-6)
    assert item["original_size"] == (96, 128)


def test_load_pixels_is_the_only_pixel_source(data_dir):
    """A subclass that supplies pixels runs the same crop, resize and box
    normalisation as a JPEG read: here the pixels are the JPEG's own."""
    _, cfg = _configs(data_dir, "exact")
    for cls in (coco.CocoClassification, coco.RefCocop):
        node = cfg.task_configs[TASK_CONFIG[cls.__name__]]
        base = cls(node, "val")
        pixels = {s["image"]["image_id"]: base.load_pixels(s)
                  for s in base.samples}

        class Supplied(cls):
            def load_pixels(self, sample):
                return pixels[sample["image"]["image_id"]]

        for i in range(len(base)):
            _same_item(Supplied(node, "val").get(i, np.random.RandomState(i)),
                       base.get(i, np.random.RandomState(i)))


@pytest.mark.parametrize("native", [True, False], ids=["cxx", "numpy"])
@pytest.mark.parametrize("task", ["CocoDetection", "CocoClassification",
                                  "CocoVqa"])
def test_train_transforms_match_jax(task, native, monkeypatch):
    """The jitter stacks on a 3-channel float image, over 20 seeds: the
    same draws in the same order give the same values."""
    _pin_jitter(monkeypatch, native)
    img = np.random.RandomState(3).randint(0, 256, (24, 32, 3)).astype(
        np.uint8)
    for seed in range(20):
        got = transforms.train_transforms(task)(img,
                                                np.random.RandomState(seed))
        want = jax_transforms.train_transforms(task)(
            img, np.random.RandomState(seed))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ------------------------------------------------------------------ metrics

TRICKY = [
    "A man riding a horse.", "a cat. a dog on the mat!", "Mr. Jones and "
    "Dr. Smith's cat", "a flag of the U.S.", "a (red) car [left] {x}",
    'he said "hello" -- twice...', "two-toned bus; it's red, isn't it?",
    "a sign reading `stop'", "line one\nline two", "Jan. 5th at 3 p.m.",
    "", "   ", "a 3.5 inch screen", "St. Louis vs. Chicago, Inc.",
]


def test_ptb_tokenize_matches_jax():
    caps = {i: [{"caption": c}] for i, c in enumerate(TRICKY)}
    got = ptb_tokenize(caps)
    assert got == jax_ptb(caps)
    assert "-lrb-" in got[4][0]  # the reference's escape quirk


def _corpus(seed, n=40):
    rng = np.random.RandomState(seed)
    words = "a the man dog cat on in riding red blue two of with".split()

    def sent():
        return " ".join(rng.choice(words, rng.randint(1, 12)))
    refs = {k: [sent() for _ in range(rng.randint(1, 6))] for k in range(n)}
    hyps = {k: [sent()] for k in range(n)}
    return refs, hyps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bleu_and_cider_match_jax(seed):
    refs, hyps = _corpus(seed)
    for got, want in zip(bleu_corpus(refs, hyps, 4), jax_bleu(refs, hyps, 4)):
        assert abs(got - want) <= 1e-12
    assert abs(cider_d(refs, hyps) - jax_cider(refs, hyps)) <= 1e-12


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_voc_ap_matches_jax(seed):
    rng = np.random.RandomState(seed)
    gt = np.concatenate([rng.rand(rng.randint(1, 5), 2) * 0.6,
                         0.1 + rng.rand(1, 2) * 0.3 + np.zeros((1, 2))], 0)
    gt = np.concatenate([gt[:, :2], 0.1 + 0.3 * rng.rand(len(gt), 2)], 1)
    pred = np.concatenate([gt + 0.05 * rng.randn(*gt.shape),
                           rng.rand(6, 4) * 0.5], 0)
    scores = rng.rand(len(pred))
    scores[3] = scores[1]  # a tie: stable order
    for method in ("every_point", "eleven_point"):
        got = voc_ap(pred, scores, gt, 0.5, method)
        want = jax_voc_ap(pred, scores, gt, 0.5, method)
        assert abs(got - want) <= 1e-12


# ----------------------------------------------------------- evaluators

ID_FIELD = {"CocoVqa": "question_id", "CocoClassification": "id",
            "CocoCaptioning": "cap_id", "CocoDetection": "id",
            "RefCocop": "sent_id"}


def seeded_eval_inputs(task, seed=0, n=30):
    """(samples, predictions, boxes) of `task`: a third of the samples
    hold unseen categories, a few have no prediction."""
    rng = np.random.RandomState(seed)
    classes = sorted(coco_synonyms())[:6]
    words = "a the man dog cat on in riding red two of".split()
    field = ID_FIELD[task]
    samples, preds, boxes = [], {}, {}
    for i in range(n):
        s = {field: 1000 + i,
             "image": {"subset": "val2014", "image_id": i // 2,
                       "W": 640, "H": 480},
             "coco_categories": {"seen": ["dog"],
                                 "unseen": ["cat"] if i % 3 == 0 else []}}
        if task == "CocoVqa":
            s["all_answers"] = {w: int(rng.randint(1, 6))
                                for w in rng.choice(words, 3, replace=False)}
            s["anno"] = {"answer_type": ["number", "yes/no"][i % 2],
                         "question_type": ["how many", "is the"][i % 3 > 0]}
            answer = str(rng.choice(words))
        elif task == "CocoClassification":
            s["answer"] = classes[i % len(classes)]
            answer = str(rng.choice(coco_synonyms()[s["answer"]] + ["dog"]))
        elif task == "CocoCaptioning":
            s["answer"] = " ".join(rng.choice(words, 6)).capitalize() + "."
            answer = " ".join(rng.choice(words, rng.randint(2, 8)))
        else:
            b = np.stack([rng.uniform(0, 400, 2), rng.uniform(20, 200, 2)])
            s["boxes"] = [[*b[0], *b[1]]]
            if task == "CocoDetection":
                s["boxes"].append([50.0, 60.0, 100.0, 80.0])
                s["category_name"] = classes[i % 2]
            answer = ""
        samples.append(s)
        if i % 7 == 5:
            continue  # absent
        preds[str(1000 + i)] = {"answer": answer}
        gt = np.asarray(s.get("boxes", [[0, 0, 1, 1]]), np.float64)
        gt = gt / [640, 480, 640, 480]
        gt[:, :2] += gt[:, 2:] / 2
        q = np.concatenate([gt + 0.02 * rng.randn(*gt.shape),
                            rng.rand(8, 4) * 0.5], 0).astype(np.float32)
        boxes[str(1000 + i)] = {"boxes": q,
                                "relevance": rng.rand(len(q)).astype(
                                    np.float32)}
    return samples, preds, boxes


@pytest.mark.parametrize("novelty", ["everything", "seen_concepts",
                                     "held_out_concepts"])
@pytest.mark.parametrize("task", sorted(ID_FIELD))
def test_evaluators_match_jax(task, novelty):
    samples, preds, boxes = seeded_eval_inputs(task)
    got = EVALUATOR_CLASSES[task](samples, preds, boxes).evaluate(novelty)
    want = JAX_EVALUATORS[task](samples, preds, boxes).evaluate(novelty)
    assert got == want
    assert json.dumps(got, default=str) == json.dumps(want, default=str)
    if task == "CocoVqa":
        assert got["absent"] > 0 and got["total"]["all"] > 0
    if task in ("CocoDetection", "RefCocop"):
        assert 0 < got["mAP"] < 1 and isinstance(got["total"], Counter)
