"""The port's config layer against `gpv_tpu`, on the CPU: its YAML reader
against pyyaml on every file under configs/, override parsing,
`load_config`, `build_gpv` (parameters and config checks), `build_engine`
(a reference `.pth` predicts as the JAX engine on the same variables) and
the inference entry points' printed lines.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from gpv_tpu.engine import GPVEngine as JaxEngine
from gpv_tpu.models.gpv import build_gpv as jax_build_gpv
from gpv_tpu.text.vocab import AnswerVocab as JaxVocab
from gpv_tpu.text.wordpiece import WordPieceTokenizer as JaxTok
from gpv_tpu.utils import config as jax_config

from gpv_tpu_torch.infer.build import build_engine
from gpv_tpu_torch.models.gpv import build_gpv
from gpv_tpu_torch.utils import config as port_config
from gpv_tpu_torch.utils import yaml_subset
from gpv_tpu_torch.weights import state_dict_from_jax

from _fake_data import TINY_OVERRIDES

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "configs"
YAML_FILES = sorted(CONFIGS.rglob("*.yaml"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def at_repo_root(monkeypatch):
    """The loaders and CLIs read `configs/` relative to the working dir."""
    monkeypatch.chdir(ROOT)


# ------------------------------------------------------------- YAML reader

@pytest.mark.parametrize("path", YAML_FILES,
                         ids=lambda p: str(p.relative_to(CONFIGS)))
def test_yaml_reader_matches_pyyaml(path):
    text = path.read_text()
    assert yaml_subset.load(text, floats12=True) == \
        yaml.load(text, Loader=jax_config._YamlLoader)


OVERRIDE_VALUES = [
    "null", "~", "", "True", "false", "yes", "Off", "7", " 5 ", "-3", "0x1F",
    "017", "1_000", "1e-4", "5e-2", "1.5", ".5", "1.", "-.inf", "float32",
    "/tmp/gpv", "exp/gpv", "what is this?", "it's a dog", "a #b", "a:b",
    "http://x.y/z", "[1,1,1,1]", "[a, [b, c], {d: e}]", "[]", "{}",
    "{num_layers: 1, hidden: 32}", "{H: 48, W: 64}", "{a: 1e-4}",
    "{coco_vqa: 4, coco_cap: 4}", "'quoted'", '"dq \\"x\\""', "a: b: c",
    "*alias", "[unclosed", "{a: 1",
]


@pytest.mark.parametrize("value", OVERRIDE_VALUES)
def test_parse_scalar_matches_jax(value):
    got, want = port_config._parse_scalar(value), \
        jax_config._parse_scalar(value)
    assert got == want and type(got) is type(want)


def test_yaml_dump_round_trips():
    cfg = port_config.load_config("configs", "exp/gpv_inference",
                                  TINY_OVERRIDES)
    data = port_config.to_dict(cfg)
    data["extra"] = {"odd strings": ["", " x", "1e-4", "yes", "a: b", "#c",
                                     "line\nbreak", "null"],
                     "floats": [1e-5, 0.1, float("inf"), 1e16, -2.5],
                     "empty": {}, "none": None, "nested": [[1, 2], []]}
    text = yaml_subset.dump(data)
    assert yaml.safe_load(text) == data
    assert yaml_subset.load(text) == data


# ------------------------------------------------------------- load_config

@pytest.mark.parametrize("group", [[], ["learning_datasets=all"]],
                         ids=["defaults", "group_override"])
@pytest.mark.parametrize("name", ["exp/gpv", "exp/gpv_ft",
                                  "exp/gpv_inference"])
def test_load_config_matches_jax(name, group):
    overrides = TINY_OVERRIDES + group + ["model.vocab=/x/vocab.json"]
    assert port_config.load_config("configs", name, overrides) == \
        jax_config.load_config("configs", name, overrides)


def test_unknown_group_option_raises():
    with pytest.raises(ValueError, match="unknown option 'tpyo'"):
        port_config.load_config("configs", "exp/gpv",
                                ["learning_datasets=tpyo"])


def test_interpolation_cycle_raises(tmp_path):
    (tmp_path / "c.yaml").write_text("a: ${b}\nb: x${a}\n")
    for mod in (port_config, jax_config):
        with pytest.raises(ValueError, match="cycle"):
            mod.load_config(tmp_path, "c")


def test_save_config_reads_back(tmp_path):
    cfg = port_config.load_config("configs", "exp/gpv", TINY_OVERRIDES)
    port_config.save_config(cfg, tmp_path / "c.yaml")
    assert yaml.safe_load((tmp_path / "c.yaml").read_text()) == \
        port_config.to_dict(cfg)


# --------------------------------------------------------------- build_gpv

VOCAB = 30
VARIANTS = {
    "released": [],
    "linear_head": ["model.answer_head=linear"],
    "no_roi_head": ["model.roi_head=False", "model.detr_joiner.detr_dim=32"],
    "no_relevance_conditioning": ["model.relevance_conditioning=False"],
    "learned_pos": ["model.detr.position_embedding=learned"],
    "v3_pre_norm_resnet26": ["model.detr.position_embedding=v3",
                             "model.detr.pre_norm=True",
                             "model.detr.backbone_layers=null",
                             "model.detr.backbone=resnet26"],
}


def _model_cfg(extra=()):
    return port_config.load_config("configs", "exp/gpv",
                                   TINY_OVERRIDES + list(extra)).model


def _jax_shapes(cfg):
    """state_dict_from_jax of the JAX model's init, by shapes alone."""
    model = jax_build_gpv(cfg, vocab_size=VOCAB)
    tree = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, 48, 64, 3)), jnp.zeros((1, 5), jnp.int32),
        jnp.zeros((1, 4), jnp.int32)), jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    return {k: tuple(v.shape) for k, v in state_dict_from_jax(tree).items()}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_build_gpv_parameters_match_jax(variant):
    cfg = _model_cfg(VARIANTS[variant])
    got = {k: tuple(v.shape) for k, v in
           build_gpv(cfg, vocab_size=VOCAB).state_dict().items()}
    assert got == _jax_shapes(cfg)


BAD_NODES = [
    ("model.detr.masks=True", ValueError),
    ("model.detr.frozenbatchnorm=False", ValueError),
    ("model.detr.backbone=resnet99", ValueError),
    ("model.detr.position_embedding=fourier", ValueError),
    ("model.detr.last_layer_only=False", ValueError),
    ("model.co_att.hidden_size=64", ValueError),
    ("model.co_att.v_output_size=64", ValueError),
    ("model.co_att.hidden_act=tanh", ValueError),
    ("model.co_att.visualization=True", ValueError),
    ("model.text_decoder.hidden_dim=64", ValueError),
    ("model.detr_joiner.detr_dim=2304", ValueError),
    ("model.detr_joiner.out_dim=16", ValueError),
    ("model.bert_joiner.out_dim=16", ValueError),
    ("model.bert_joiner.bert_dim=768", ValueError),
]


@pytest.mark.parametrize("override,exc", BAD_NODES,
                         ids=[b[0].split("=")[0][6:] for b in BAD_NODES])
def test_build_gpv_config_checks_match_jax(override, exc):
    cfg = _model_cfg([override])
    with pytest.raises(exc) as want:
        jax_build_gpv(cfg, vocab_size=VOCAB)
    with pytest.raises(exc) as got:
        build_gpv(cfg, vocab_size=VOCAB)
    assert str(got.value) == str(want.value)


def test_stem_s2d_is_refused_naming_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 21"):
        build_gpv(_model_cfg(["model.detr.stem_s2d=True"]), VOCAB)


# ------------------------------------------------------------ build_engine

def _random_batch_stats(variables, seed=0):
    rng = np.random.RandomState(seed)

    def stat(path, x):
        x = np.asarray(x)
        if path[-1].key in ("weight", "running_var"):
            return (rng.rand(*x.shape) + 0.5).astype(np.float32)
        return (0.1 * rng.randn(*x.shape)).astype(np.float32)
    return {"params": jax.tree.map(np.asarray, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stat, variables["batch_stats"])}


ENGINE_VARIANTS = {
    "released": [],
    "variants": ["model.answer_head=linear", "model.roi_head=False",
                 "model.detr_joiner.detr_dim=32",
                 "model.relevance_conditioning=False",
                 "model.detr.position_embedding=learned"],
}


@pytest.fixture(scope="module", params=list(ENGINE_VARIANTS))
def pth_pair(request, tmp_path_factory):
    """(JAX engine, port overrides naming a .pth of the same variables)."""
    extra = ENGINE_VARIANTS[request.param]
    cfg = jax_config.load_config("configs", "exp/gpv_inference",
                                 TINY_OVERRIDES + extra)
    vocab = JaxVocab.debug()
    model = jax_build_gpv(cfg.model, vocab_size=len(vocab))
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 48, 64, 3)), jnp.zeros((1, 5), jnp.int32),
        jnp.zeros((1, 4), jnp.int32)))(jax.random.PRNGKey(2))
    variables = _random_batch_stats(variables)
    path = tmp_path_factory.mktemp("ckpt") / "model.pth"
    torch.save({"model": {f"module.{k}": v for k, v in
                          state_dict_from_jax(variables).items()},
                "epoch": 3}, path)
    engine = JaxEngine(model, variables, vocab, JaxTok.debug())
    return engine, TINY_OVERRIDES + extra + [
        f"ckpt={path}", "device=cpu", "tpu.dtype=float32"]


def test_build_engine_from_pth_predicts_as_jax(pth_pair):
    jax_engine, overrides = pth_pair
    engine = build_engine(port_config.load_config(
        "configs", "exp/gpv_inference", overrides))
    assert engine.device.type == "cpu"
    assert engine.model.dtype == torch.float32
    rng = np.random.RandomState(5)
    images = rng.randint(0, 255, (2, 48, 64, 3)).astype(np.uint8)
    queries = ["what is the man riding?", "dog"]
    for got, ref in zip(engine.predict(images, queries),
                        jax_engine.predict(images, queries)):
        assert got["answer"] == ref["answer"]
        np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=2e-4,
                                   rtol=0)
        np.testing.assert_allclose(got["relevance"], ref["relevance"],
                                   atol=5e-4, rtol=0)


@pytest.mark.parametrize("extra,exc,match", [
    (["ckpt=/nonexistent/model.pth"], FileNotFoundError, "not found"),
    (["ckpt={tmp}"], NotImplementedError, "orbax"),
    (["ckpt=null", "tpu.infer_data_parallel=2"], ValueError, "one card"),
    (["ckpt=null", "tpu.dtype=float16"], ValueError, "tpu.dtype"),
], ids=["missing", "orbax_dir", "data_parallel", "dtype"])
def test_build_engine_refuses(tmp_path, extra, exc, match):
    extra = [e.format(tmp=tmp_path) for e in extra]
    cfg = port_config.load_config("configs", "exp/gpv_inference",
                                  TINY_OVERRIDES + extra + ["device=cpu"])
    with pytest.raises(exc, match=match):
        build_engine(cfg)


def test_build_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    cfg = port_config.load_config("configs", "exp/gpv_inference",
                                  TINY_OVERRIDES + ["ckpt=null"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(cfg)


# ------------------------------------------------------------ entry points

@pytest.mark.parametrize("cli", ["inference", "inference_beam_search"])
def test_cli_prints_what_the_root_cli_prints(cli, pth_pair, tmp_path,
                                             monkeypatch, capsys):
    """The root CLI runs the JAX engine on the same variables (its own
    `.pth` converter is fixed to released depths, so the engine is handed
    to it); the port CLI loads the `.pth` itself."""
    import importlib

    from PIL import Image
    jax_engine, overrides = pth_pair
    img = tmp_path / "img.png"
    Image.fromarray(np.random.RandomState(8).randint(
        0, 255, (40, 56, 3), np.uint8)).save(img)
    args = overrides + [f"image_path={img}", "query=what is this?",
                        "beam_size=3", "num_output_boxes=4",
                        "task_configs.image_size={H: 48, W: 64}"]
    monkeypatch.syspath_prepend(str(ROOT))
    root = importlib.import_module(cli)
    monkeypatch.setattr(importlib.import_module("inference"),
                        "build_engine", lambda cfg: jax_engine)
    root.main(args)
    want = capsys.readouterr().out
    importlib.import_module(f"gpv_tpu_torch.cli.{cli}").main(args)
    got = capsys.readouterr().out
    assert re.search(r"relevance \d\.\d{4}", got)
    assert got == want


# ------------------------------------------------------------ weight files

@pytest.mark.parametrize("prefix", ["", "bert.", "module.bert.model."])
def test_load_bert_weights_takes_hf_names(prefix):
    """An HF-named BERT state dict (under any prefix, with the pooler,
    the `position_ids` buffer and a pre-training head beside it) loads
    into the port's BertEncoder as the JAX package's converter reads it."""
    from gpv_tpu.train.checkpoint import convert_bert_torch
    from gpv_tpu_torch.nn.bert import BertEncoder
    from gpv_tpu_torch.weights import bert as bert_sd
    from gpv_tpu_torch.weights import init_random, load_bert_weights

    src = init_random(BertEncoder(2, 32, 4, 64, 100, 16), seed=4)
    hf = {prefix + k[len("model."):]: v for k, v in src.state_dict().items()}
    hf[prefix + "pooler.dense.weight"] = torch.zeros(32, 32)
    hf[prefix + "embeddings.position_ids"] = torch.arange(16)[None]
    hf["cls.predictions.bias"] = torch.zeros(100)
    got = load_bert_weights(BertEncoder(2, 32, 4, 64, 100, 16), hf)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)
    params = convert_bert_torch(
        {k.removeprefix("module."): v.numpy() for k, v in hf.items()},
        prefix=prefix.removeprefix("module."), num_layers=2, dim=32)
    for k, v in bert_sd(params).items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)


def test_load_torch_state_dict_strips_ddp_prefix(tmp_path):
    from gpv_tpu_torch.weights import load_torch_state_dict
    sd = {"module.a.weight": torch.ones(2), "module.b": torch.zeros(1)}
    torch.save(sd, tmp_path / "plain.pth")
    torch.save({"model": sd, "epoch": 1}, tmp_path / "train.pth")
    for name in ("plain.pth", "train.pth"):
        got = load_torch_state_dict(tmp_path / name)
        assert sorted(got) == ["a.weight", "b"]
