"""The port's offline data preparation against `gpv_tpu`'s, on the CPU.

- Modules: every case of tests/test_data_pipeline.py's TestPreprocessors,
  TestSplits (the pos-gate cases included), TestSynonymGenerator (no nltk
  data: an injected lemma source) and TestVocabBuilder runs on both
  packages; each asserts what the original asserts, and the two packages'
  results must be equal. The vendored tables (pos-gate word lists, morphy
  lexicon, templates, aliases, URL tree) must be equal as they are.
- Pipelines: one seeded raw tree in COCO 2014 / VQA v2 schema
  (`chip_smoke.write_raw_coco`, 200 train2014 + 100 val2014 images) goes
  through both packages' `preprocess`, `make_sce_split` and `data_stats`
  CLIs into two directories: every file written is byte-equal, and the
  lines printed are equal.
- Download: the stubbed URL lists of tests/test_cli_pipeline.py for both
  packages are equal.
"""
import contextlib
import importlib
import importlib.util
import io
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("gpv_tpu", "gpv_tpu_torch")


def _pkg(name):
    m = {k: importlib.import_module(f"{name}.{mod}") for k, mod in (
        ("data", "data"), ("splits", "data.splits"),
        ("pos_gate", "data.pos_gate"), ("morphy", "data.morphy"),
        ("synonyms", "data.synonyms"), ("preprocess", "data.preprocess"),
        ("vocab_builder", "data.vocab_builder"), ("index", "data.index"),
        ("download", "data.download"), ("io", "utils.io"),
        ("treebank", "text.treebank"))}
    ev = "evaluation.evaluators" if name == "gpv_tpu" else \
        "evaluation.vocab_mask"
    m["coco_synonyms"] = importlib.import_module(f"{name}.{ev}").coco_synonyms
    m["syn_path"] = ROOT / name / "evaluation" / "coco_synonyms.json"
    return SimpleNamespace(**m)


@pytest.fixture(scope="module")
def pkgs():
    return [_pkg(n) for n in PACKAGES]


def fake_instances():
    return {
        "images": [{"id": 1, "file_name": "COCO_train2014_000000000001.jpg"},
                   {"id": 2, "file_name": "COCO_train2014_000000000002.jpg"}],
        "categories": [{"id": 18, "name": "dog"},
                       {"id": 1, "name": "person"}],
        "annotations": [
            {"image_id": 1, "category_id": 18, "id": 101,
             "bbox": [10, 10, 30, 30]},
            {"image_id": 1, "category_id": 18, "id": 102,
             "bbox": [50, 50, 20, 20]},
            {"image_id": 1, "category_id": 1, "id": 103,
             "bbox": [5, 5, 10, 40]},
            {"image_id": 2, "category_id": 1, "id": 104,
             "bbox": [0, 0, 10, 10]},
        ],
    }


def _names(assigner, sample):
    return [c["name"] for c in assigner.assign(sample)]


# ---------------------------------------------------------------- cases
# Each case takes one package's modules, asserts what its counterpart in
# tests/test_data_pipeline.py asserts, and returns what it computed.

def case_detection_groups_per_image_category(m):
    ds = m.data.preprocess_detection(fake_instances())
    assert len(ds) == 3
    dog = [s for s in ds if s["category_name"] == "dog"][0]
    assert len(dog["boxes"]) == 2 and dog["id"] == 101
    assert "dog" in dog["query"].lower()
    assert dog["image"] == {"subset": "train2014", "image_id": 1}
    return ds


def case_classification_smallest_id_box(m):
    ds = m.data.preprocess_classification(fake_instances())
    dog = [s for s in ds if s["answer"] == "dog"][0]
    assert dog["boxes"] == [10, 10, 30, 30] and dog["id"] == 101
    return ds


def case_captions(m):
    caps = {"images": [{"id": 1,
                        "file_name": "COCO_train2014_000000000001.jpg"}],
            "annotations": [{"image_id": 1, "id": 7, "caption": "a dog."}]}
    ds = m.data.preprocess_captions(caps)
    assert ds[0]["answer"] == "a dog." and ds[0]["cap_id"] == 7
    test_ds = m.data.preprocess_captions(caps, test=True)
    assert "answer" not in test_ds[0]
    return ds, test_ds


def case_vqa(m):
    qs = {"data_subtype": "train2014",
          "questions": [{"image_id": 1, "question": "how many dogs?",
                         "question_id": 11}]}
    annos = {"annotations": [{
        "question_id": 11, "image_id": 1,
        "multiple_choice_answer": "2", "question_type": "how many",
        "answer_type": "number",
        "answers": [{"answer": "2"}] * 7 + [{"answer": "3"}] * 3}]}
    ds = m.data.preprocess_vqa(qs, annos)
    assert ds[0]["answer"] == "2" and ds[0]["all_answers"] == {"2": 7, "3": 3}
    assert ds[0]["anno"]["answer_type"] == "number"
    return ds


def case_category_split_counts(m):
    cats = [{"id": i, "name": f"c{i}"} for i in range(2, 81)] + [
        {"id": 1, "name": "person"}]
    split = m.data.split_categories(cats, seed=0)
    assert [len(split[k]) for k in ("shared", "held_from_vqa",
                                    "held_from_det")] == [40, 10, 30]
    assert split["shared"][0]["name"] == "person"
    assert split["held_from_cap"] == split["held_from_vqa"]
    return split


def case_image_split(m):
    out = m.data.split_images(list(range(100)), "train", "train2014",
                              train_frac=0.9, seed=0)
    assert len(out["train"]["image_ids"]) == 90
    assert len(out["val"]["image_ids"]) == 10
    assert not (set(out["train"]["image_ids"]) & set(out["val"]["image_ids"]))
    return out


def case_assign_categories(m):
    a = m.splits.AssignCocoCategories(
        [{"id": 18, "name": "dog"}, {"id": 3, "name": "car"}],
        m.coco_synonyms())
    got = [_names(a, {"query": "locate the dogs"}),
           _names(a, {"query": "what is this?", "answer": "car"}),
           _names(a, {"query": "a man eating a hot dog"})]
    assert got == [["dog"], ["car"], []]
    return got


def case_clock_watch_special_case(m):
    a = m.splits.AssignCocoCategories([{"id": 85, "name": "clock"}],
                                      m.coco_synonyms())
    keep = ("what time is on the watch", "do you watch",
            "locate the watches", "is he wearing a gold watch")
    drop = ("do you watch tv at home", "they watch birds outside",
            "the man watches the game on sunday")
    got = [_names(a, {"query": q}) for q in keep + drop]
    assert got == [["clock"]] * len(keep) + [[]] * len(drop)
    return got


def case_orange_special_case(m):
    a = m.splits.AssignCocoCategories([{"id": 55, "name": "orange"}],
                                      m.coco_synonyms())
    keep = ("an orange on the table", "how many oranges are in the bowl",
            "a glass of orange juice", "what color is the orange",
            "peeling an orange")
    drop = ("is there an orange cat", "the shirt is orange",
            "an orange and white dog")
    got = [_names(a, {"query": q}) for q in keep + drop]
    got += [_names(a, {"query": "what fruit is on the plate",
                       "answer": "orange"}),
            _names(a, {"query": "what color is the cat", "answer": "orange"})]
    assert got == ([["orange"]] * len(keep) + [[]] * len(drop)
                   + [["orange"], []])
    return got


POS_CASES = (  # (gate, text, NOUN?) from TestSplits.test_pos_gate_decision_table
    ("orange", "two oranges sit on a plate", True),
    ("orange", "orange juice in a glass", True),
    ("orange", "an orange frisbee", False),
    ("orange", "an orange traffic cone", False),
    ("orange", "orange traffic light", False),
    ("orange", "an orange tennis ball on the court", False),
    ("orange", "the orange baseball hat", False),
    ("orange", "an orange delivery truck", False),
    ("orange", "a glass of orange juice on the table", True),
    ("orange", "is the orange a fruit", True),
    ("orange", "the orange is food", True),
    ("orange", "an orange and banana on a table", True),
    ("orange", "the orange and the apple", True),
    ("orange", "the walls are painted orange", False),
    ("orange", "she is eating an orange", True),
    ("watch", "a silver watch on his wrist", True),
    ("watch", "people watch the game", False),
    ("watch", "he likes to watch television", False),
    ("watch", "she watches birds", False),
    ("watch", "the watches are on display", True),
    ("watch", "a man wearing a hat and watch by the door", True),
    ("watch", "they sit and watch the waves", False),
    ("watch", "are there two gold watches in the picture", True),
    ("watch", "the man watches the game on sunday", False),
)


def case_pos_gate_decision_table(m):
    gates = {"orange": m.pos_gate.any_orange_noun,
             "watch": m.pos_gate.any_watch_noun}
    got = [gates[g](m.treebank.word_tokenize(t.lower()))
           for g, t, _ in POS_CASES]
    assert got == [want for _, _, want in POS_CASES]
    return got


def case_pos_gate_synonym_vocabulary_sweep(m):
    pg, tok = m.pos_gate, m.treebank.word_tokenize
    syn = m.coco_synonyms()
    phrases = sorted({p.lower() for ps in syn.values() for p in ps}
                     | {c.lower() for c in syn})
    assert len(phrases) > 300
    got = []
    for t in m.preprocess.DETECTION_TEMPLATES:
        for name in ("orange", "oranges"):
            got.append(pg.any_orange_noun(tok(t.format(name).lower())))
            assert got[-1], t.format(name)
    for p in phrases:
        words = p.split()
        if {"orange", "oranges", "watch", "watches"} & set(words):
            continue
        attributive = pg.any_orange_noun(tok(f"an orange {p}"))
        assert attributive == (words[0] in pg._ORANGE_COMPOUND_HEADS), p
        colour = pg.any_orange_noun(tok(f"what color is the {p} orange"))
        conjunct = pg.any_watch_noun(tok(f"a {words[-1]} and watch"))
        assert not colour and conjunct, p
        got += [attributive, colour, conjunct]
    return got


def case_split_data_drops_unseen_train_samples(m):
    category_split = {"shared": [{"id": 1, "name": "person"}],
                      "held_from_vqa": [{"id": 18, "name": "dog"}],
                      "held_from_det": [{"id": 3, "name": "car"}]}
    samples = [{"query": "how many dogs?", "answer": "2",
                "image": {"subset": "train2014", "image_id": 1}},
               {"query": "how many people?", "answer": "3",
                "image": {"subset": "train2014", "image_id": 1}}]
    image_split = {"subset": "train2014", "image_ids": [1]}
    kept, discarded, counts = m.data.split_data_by_categories(
        samples, category_split, "vqa", "train", image_split,
        m.coco_synonyms())
    assert len(kept) == 1 and len(discarded) == 1
    assert kept[0]["query"] == "how many people?"
    kept_t, _, _ = m.data.split_data_by_categories(
        samples, category_split, "vqa", "test", image_split,
        m.coco_synonyms())
    assert len(kept_t) == 2
    assert kept_t[0]["coco_categories"]["unseen"] == ["dog"]
    return kept, discarded, {k: dict(v) for k, v in counts.items()}, kept_t


LEMMAS = {"dogs": "dog", "people": "people", "benches": "bench",
          "glass": "glass", "glasses": "glass", "bus": "bus", "buses": "bus",
          "men": "man", "women": "woman", "children": "child", "skis": "ski",
          "knives": "knife", "trees": "trees"}


def case_lemmatize(m):
    got = {w: m.data.lemmatize(w) for w in LEMMAS}
    assert got == LEMMAS
    return got


def case_morphy_exceptions_block_rule_paths(m):
    got = [m.data.lemmatize("busses"), m.data.lemmatize("scissors")]
    assert got == ["bus", "scissors"]
    return got


def _all_category_assigner(m):
    import json
    syn = json.loads(m.syn_path.read_text())
    return syn, m.splits.AssignCocoCategories(
        [{"name": n, "id": i} for i, n in enumerate(syn)], syn)


def case_every_synonym_phrase_self_matches(m):
    syn, assigner = _all_category_assigner(m)
    got = {f"{n}/{p}": _names(assigner, {"query": f"a photo of a {p}"})
           for n, ps in syn.items() for p in ps}
    assert all(k.split("/")[0] in v for k, v in got.items())
    return got


def case_inflected_synonyms_match(m):
    _, assigner = _all_category_assigner(m)
    cases = {"two dogs run in the park": "dog",
             "men riding horses": "person",
             "the children play frisbee": "person",
             "many buses on the street": "bus",
             "knives on the dining table": "knife",
             "people skiing on skis": "skis"}
    got = {t: _names(assigner, {"query": t}) for t in cases}
    assert all(cases[t] in got[t] for t in cases)
    return got


def case_aliases_merged_verbatim(m):
    out = m.synonyms.generate_candidate_synonyms(
        ["tv", "couch", "sports ball"], wn_lemmas=lambda w: set())
    assert "television" in out["tv"] and "sofa" in out["couch"]
    assert {"ball", "football", "basketball"} <= set(out["sports ball"])
    assert len(m.synonyms.ALIASES) == 16
    return out


def case_wordnet_lemma_normalization_and_variants(m):
    out = m.synonyms.generate_candidate_synonyms(
        ["motorcycle"], wn_lemmas=lambda w: {"Motor_Bike", "bike"})
    got = set(out["motorcycle"])
    assert {"motor bike", "motorbike", "motor-bike", "bike",
            "motorcycle"} <= got
    assert {"motor cycle", "motorcycle", "motor-cycle"} <= got
    return out


def case_candidates_superset_of_curated_aliases(m):
    curated = m.coco_synonyms()
    out = m.synonyms.generate_candidate_synonyms(m.synonyms.ALIASES,
                                                 wn_lemmas=lambda w: set())
    for name, aliases in m.synonyms.ALIASES.items():
        for s in curated.get(name, []):
            if s in aliases or s == name:
                assert s in out[name], (name, s)
    return out


def case_real_wordnet_path_gated(m):
    """The nltk path works, or raises LookupError without the corpus: the
    two packages must do the same."""
    try:
        out = m.synonyms.generate_candidate_synonyms(["dog"])
    except LookupError:
        return "LookupError"
    assert "dog" in out["dog"]
    return out


def case_vocab_min_count_and_specials(m):
    vocab, cnt = m.data.build_vocab(["a dog"] * 12 + ["a cat"] * 5,
                                    min_count=10)
    assert "dog" in vocab and "a" in vocab and "cat" not in vocab
    assert {"__pad__", "__cls__", "__stop__", "__unk__"} <= set(vocab)
    assert vocab == sorted(vocab)
    return vocab, dict(cnt)


def case_synonyms_resolve_lazily(m):
    table = m.synonyms.SYNONYMS
    assert table == m.coco_synonyms() and len(table) == 80
    return table


def case_image_index_and_stats(m):
    samples = {"vqa": [{"image": {"subset": "train2014", "image_id": i % 3}}
                       for i in range(7)],
               "cap": [{"image": {"subset": "val2014", "image_id": 1}}]}
    index = m.index.create_image_index(samples)
    stats = m.index.data_stats({t: {"train": s} for t, s in samples.items()})
    assert index["train2014_0"] == {"vqa": [0, 3, 6]}
    assert stats["vqa"]["train"] == {"num_samples": 7, "num_images": 3}
    return index, stats


CASES = {n[len("case_"):]: f for n, f in dict(globals()).items()
         if n.startswith("case_")}


@pytest.mark.parametrize("name", list(CASES))
def test_module_case_matches_jax(pkgs, name):
    jax_out, port_out = (CASES[name](m) for m in pkgs)
    assert port_out == jax_out


TABLES = (  # (module key, attribute) holding vendored data
    [("pos_gate", n) for n in (
        "_DETERMINERS", "_VERB_TRIGGERS", "_COPULAS",
        "_ORANGE_COMPOUND_HEADS", "_PERSON_NOUNS", "_OBJECT_NOUNS",
        "_ATTRIB_INTERMEDIATES", "_COLORS", "_SYNONYM_HEADS",
        "_SYNONYM_INTERMEDIATES", "_ORANGE_ADJ_HEADS", "_COMMON_NOUNS",
        "_FUNCTION_WORDS", "_WATCH_OBJECT_CUES")]
    + [("morphy", n) for n in ("_SUBSTITUTIONS", "NOUN_EXCEPTIONS",
                               "_BLOCKERS")]
    + [("preprocess", n) for n in ("DETECTION_TEMPLATES", "CAPTION_TEMPLATES",
                                   "CLASSIFICATION_TEMPLATES")]
    + [("synonyms", "ALIASES"), ("download", "URLS"),
       ("splits", "AssignCocoCategories.SPECIAL")])


@pytest.mark.parametrize("mod,attr", TABLES,
                         ids=[f"{m}.{a}" for m, a in TABLES])
def test_vendored_tables_equal(pkgs, mod, attr):
    def get(m):
        obj = getattr(m, mod)
        for part in attr.split("."):
            obj = getattr(obj, part)
        return obj
    jax_t, port_t = (get(m) for m in pkgs)
    assert port_t == jax_t and len(port_t) > 0


def test_default_lexicon_equal(pkgs):
    jax_l, port_l = (m.morphy.default_lexicon() for m in pkgs)
    assert port_l == jax_l and len(port_l) > 300


@pytest.mark.parametrize("compressed", [False, True])
def test_json_io_equal(pkgs, tmp_path, compressed):
    obj = {"a": [1, 2.5, None], "b": {"c": "d"}, "p": Path("x")}
    outs = []
    for i, m in enumerate(pkgs):
        path = tmp_path / f"{i}" / "o.json"
        m.io.dump_json_object(obj, path, compressed=compressed, indent=1)
        assert m.io.load_json_object(path, compressed=compressed) == \
            {**obj, "p": "x"}
        outs.append(m.io.load_json_object(path, compressed=compressed))
    m.io.mkdir_if_not_exists(tmp_path / "x" / "y")
    assert (tmp_path / "x" / "y").is_dir() and outs[0] == outs[1]


# ------------------------------------------------------------ pipelines

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """{package: (data_dir, [printed lines])}: one raw tree, copied, then
    prepared by each package's CLIs."""
    raw = tmp_path_factory.mktemp("raw")
    _chip_smoke().write_raw_coco(raw, 200, 100, seed=3)
    out = {}
    for name in PACKAGES:
        data = tmp_path_factory.mktemp(name)
        shutil.copytree(raw, data, dirs_exist_ok=True)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            for cli, extra in (("preprocess", []),
                               ("make_sce_split", ["seed=0",
                                                   "train_frac=0.9"]),
                               ("data_stats", ["split=gpv_split"]),
                               ("data_stats", ["split=original_split"])):
                importlib.import_module(f"{name}.cli.{cli}").main(
                    [f"data_dir={data}"] + extra)
        out[name] = (data, printed.getvalue().replace(str(data), "<d>"))
    return out


def test_pipelines_write_byte_equal_files(prepared):
    (jax_dir, _), (port_dir, _) = (prepared[n] for n in PACKAGES)
    jax_files = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*")
                       if p.is_file())
    port_files = sorted(p.relative_to(port_dir) for p in port_dir.rglob("*")
                        if p.is_file())
    assert port_files == jax_files
    written = [f for f in jax_files if "coco/annotations" not in str(f)
               and not str(f).startswith("learning_phase_data/vqa/")]
    for want in ("coco_sce/category_split.json", "coco_sce/image_splits.json",
                 "vocab/vocab.json", "vocab/vocab_count.json",
                 "coco_vqa/gpv_split/train_category_counts.json",
                 "coco_detection/original_split/val.json",
                 "image_index_gpv_split.json"):
        assert Path("learning_phase_data", want) in written, want
    for f in written:
        assert (port_dir / f).read_bytes() == (jax_dir / f).read_bytes(), f


def test_pipelines_print_equal_lines(prepared):
    (_, jax_out), (_, port_out) = (prepared[n] for n in PACKAGES)
    assert port_out == jax_out
    assert "vocab size:" in port_out and "kept" in port_out
    assert "image index (" in port_out


def test_pipeline_split_is_sound(prepared):
    """The category split is 40/10/30 with person shared; no train/val
    sample carries an unseen category; train and val images are disjoint;
    test comes from val2014."""
    import json
    lp = prepared["gpv_tpu_torch"][0] / "learning_phase_data"
    split = json.loads((lp / "coco_sce/category_split.json").read_text())
    assert [len(split[k]) for k in ("shared", "held_from_vqa",
                                    "held_from_det")] == [40, 10, 30]
    assert split["shared"][0]["name"] == "person"
    for task in ("coco_vqa", "coco_captions", "coco_detection",
                 "coco_classification"):
        subs = {s: json.loads((lp / task / "gpv_split" / f"{s}.json")
                              .read_text()) for s in ("train", "val", "test")}
        for s in ("train", "val"):
            assert subs[s] and not any(x["coco_categories"]["unseen"]
                                       for x in subs[s])
        ids = [{x["image"]["image_id"] for x in subs[s]}
               for s in ("train", "val")]
        assert not ids[0] & ids[1]
        assert {x["image"]["subset"] for x in subs["test"]} == {"val2014"}


# ------------------------------------------------------------- download

DOWNLOAD_ARGS = {
    "images_only": ["download_coco_images_only=True"],
    "mirror": ["download_coco_images_only=True",
               "urls.coco.images.train2014=http://mirror/train2014.zip"],
    "legacy_images_only": ["images_only=true"],
    "legacy_test_images": ["include_test_images=1"],
    "full_tree": [],
}


@pytest.mark.parametrize("args", list(DOWNLOAD_ARGS))
def test_download_urls_match_jax(monkeypatch, tmp_path, args):
    lists = []
    for name in PACKAGES:
        dl = importlib.import_module(f"{name}.data.download")
        got = []
        monkeypatch.setattr(dl, "download_url", lambda url, dest, got=got:
                            got.append((url, str(dest))) or
                            (tmp_path / "x.zip"))
        monkeypatch.setattr(dl, "unzip", lambda a, d: None)
        importlib.import_module(f"{name}.cli.download").main(
            [f"data_dir={tmp_path}"] + DOWNLOAD_ARGS[args])
        lists.append(got)
    assert lists[1] == lists[0] and lists[1]
    urls = [u for u, _ in lists[1]]
    if args == "mirror":
        assert urls[0] == "http://mirror/train2014.zip"
    if args == "full_tree":
        assert any("v2_Questions_Train" in u for u in urls)
        assert any("refcoco+.zip" in u for u in urls)
