"""Weights for the port: the bridge from the JAX package's variables, and
seeded random weights.

`state_dict_from_jax(variables)` turns the JAX package's
`{"params", "batch_stats"}` trees (numpy leaves) into this package's
`state_dict`, whose names are those of the reference torch state dict
(`detr.backbone.0.body.layer1.0.conv1.weight`, packed
`...self_attn.in_proj_weight`, `bert.model.encoder.layer.{i}.attention.
self.query.weight`, `co_att_transformer.{i}.biattention.query1.weight`,
`answer_head.vocab_embed`, ...). The per-module functions below return
names relative to their module, so a test can load one module alone.

`init_random(model, seed)` fills every parameter and buffer from a
`torch.Generator`, for runs without a released checkpoint.

`load_torch_state_dict(path)` reads a reference `.pth` (a state dict, or a
dict holding one under `model`, the DDP `module.` prefix stripped): its
names are this package's, so `GPV.load_state_dict(sd, strict=True)` takes
it as it is. `load_bert_weights(bert, sd)` loads an HF-named BERT state
dict (`embeddings.*`, `encoder.layer.*` under any prefix) into a
`BertEncoder`.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict

import numpy as np
import torch
from torch import nn

from .nn.layers import FrozenBatchNorm
from .nn.resnet import ResNet
from .ops.stem_s2d import s2d_stem_kernel

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _prefix(prefix: str, sd: StateDict) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def linear(p) -> StateDict:
    """flax Dense {kernel (in,out), bias} -> torch Linear {weight, bias}."""
    out = {"weight": _t(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def layernorm(p) -> StateDict:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def mha(p) -> StateDict:
    """Separate q/k/v/out Dense -> torch MHA packed in_proj + out_proj."""
    qkv = [linear(p[n]) for n in ("q_proj", "k_proj", "v_proj")]
    return {"in_proj_weight": torch.cat([x["weight"] for x in qkv]),
            "in_proj_bias": torch.cat([x["bias"] for x in qkv]),
            **_prefix("out_proj", linear(p["out_proj"]))}


def conv(p) -> StateDict:
    """flax Conv HWIO kernel -> torch OIHW weight (+ bias)."""
    out = {"weight": _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def frozen_bn(s) -> StateDict:
    return {k: _t(s[k]) for k in ("weight", "bias", "running_mean",
                                  "running_var")}


def resnet(params, stats) -> StateDict:
    sd = {**_prefix("conv1", conv(params["conv1"])),
          **_prefix("bn1", frozen_bn(stats["bn1"]))}
    for stage in range(1, 5):
        blocks = params[f"layer{stage}"]
        for b in range(len(blocks)):
            p, s = blocks[f"block{b}"], stats[f"layer{stage}"][f"block{b}"]
            base = f"layer{stage}.{b}"
            for i in (1, 2, 3):
                sd.update(_prefix(f"{base}.conv{i}", conv(p[f"conv{i}"])))
                sd.update(_prefix(f"{base}.bn{i}", frozen_bn(s[f"bn{i}"])))
            if "downsample_conv" in p:
                sd.update(_prefix(f"{base}.downsample.0",
                                  conv(p["downsample_conv"])))
                sd.update(_prefix(f"{base}.downsample.1",
                                  frozen_bn(s["downsample_bn"])))
    return sd


def detr_transformer(p) -> StateDict:
    sd: StateDict = {}
    n_enc = sum(k.startswith("encoder_layer") for k in p)
    n_dec = sum(k.startswith("decoder_layer") for k in p)
    for i in range(n_enc):
        lp, base = p[f"encoder_layer{i}"], f"encoder.layers.{i}"
        sd.update(_prefix(f"{base}.self_attn", mha(lp["self_attn"])))
        for n in ("linear1", "linear2"):
            sd.update(_prefix(f"{base}.{n}", linear(lp[n])))
        for n in ("norm1", "norm2"):
            sd.update(_prefix(f"{base}.{n}", layernorm(lp[n])))
    for i in range(n_dec):
        lp, base = p[f"decoder_layer{i}"], f"decoder.layers.{i}"
        sd.update(_prefix(f"{base}.self_attn", mha(lp["self_attn"])))
        sd.update(_prefix(f"{base}.multihead_attn", mha(lp["cross_attn"])))
        for n in ("linear1", "linear2"):
            sd.update(_prefix(f"{base}.{n}", linear(lp[n])))
        for n in ("norm1", "norm2", "norm3"):
            sd.update(_prefix(f"{base}.{n}", layernorm(lp[n])))
    sd.update(_prefix("decoder.norm", layernorm(p["decoder_norm"])))
    if "encoder_norm" in p:
        sd.update(_prefix("encoder.norm", layernorm(p["encoder_norm"])))
    return sd


def detr(params, stats) -> StateDict:
    sd = _prefix("backbone.0.body", resnet(params["backbone"],
                                           stats["backbone"]))
    if "position_embedding" in params:  # learned 2-D, the Joiner's slot 1
        for n in ("row_embed", "col_embed"):
            sd[f"backbone.1.{n}.weight"] = _t(params["position_embedding"][n])
    sd.update(_prefix("input_proj", conv(params["input_proj"])))
    sd["query_embed.weight"] = _t(params["query_embed"])
    sd.update(_prefix("transformer", detr_transformer(params["transformer"])))
    sd.update(_prefix("class_embed", linear(params["class_embed"])))
    for i in range(3):
        sd.update(_prefix(f"bbox_embed.layers.{i}",
                          linear(params["bbox_embed"][f"layer{i}"])))
    return sd


def bert(p) -> StateDict:
    """JAX BertEncoder params -> names under the port's `BertEncoder`."""
    emb = p["embeddings"]
    sd = {f"model.embeddings.{n}.weight": _t(emb[n]["embedding"])
          for n in ("word_embeddings", "position_embeddings",
                    "token_type_embeddings")}
    sd.update(_prefix("model.embeddings.LayerNorm",
                      layernorm(emb["LayerNorm"])))
    for i in range(sum(k.startswith("layer") for k in p)):
        lp, base = p[f"layer{i}"], f"model.encoder.layer.{i}"
        att = lp["attention"]
        for jax_name, name in (("q_proj", "query"), ("k_proj", "key"),
                               ("v_proj", "value")):
            sd.update(_prefix(f"{base}.attention.self.{name}",
                              linear(att[jax_name])))
        sd.update(_prefix(f"{base}.attention.output.dense",
                          linear(att["out_proj"])))
        sd.update(_prefix(f"{base}.attention.output.LayerNorm",
                          layernorm(lp["attention_norm"])))
        sd.update(_prefix(f"{base}.intermediate.dense",
                          linear(lp["intermediate"])))
        sd.update(_prefix(f"{base}.output.dense", linear(lp["output"])))
        sd.update(_prefix(f"{base}.output.LayerNorm",
                          layernorm(lp["output_norm"])))
    return sd


def co_attention_layer(p) -> StateDict:
    """Stream 1 (text) -> the reference's `v_*` weights, stream 2 -> `t_*`."""
    sd: StateDict = {}
    for proj in ("query", "key", "value"):
        for s in ("1", "2"):
            sd.update(_prefix(f"biattention.{proj}{s}",
                              linear(p["biattention"][f"{proj}{s}"])))
    for s in ("1", "2"):
        sd.update(_prefix(f"biOutput.dense{s}", linear(p[f"dense{s}"])))
        sd.update(_prefix(f"biOutput.LayerNorm{s}",
                          layernorm(p[f"attn_norm{s}"])))
    for s, tag in (("1", "v"), ("2", "t")):
        sd.update(_prefix(f"{tag}_intermediate.dense",
                          linear(p[f"ffn_in{s}"])))
        sd.update(_prefix(f"{tag}_output.dense", linear(p[f"ffn_out{s}"])))
        sd.update(_prefix(f"{tag}_output.LayerNorm",
                          layernorm(p[f"ffn_norm{s}"])))
    return sd


def text_decoder(p) -> StateDict:
    sd: StateDict = {}
    for i in range(sum(k.startswith("layer") for k in p)):
        lp, base = p[f"layer{i}"], f"layers.{i}"
        sd.update(_prefix(f"{base}.self_attn", mha(lp["self_attn"])))
        sd.update(_prefix(f"{base}.multihead_attn", mha(lp["cross_attn"])))
        for n in ("linear1", "linear2"):
            sd.update(_prefix(f"{base}.{n}", linear(lp[n])))
        for n in ("norm1", "norm2", "norm3"):
            sd.update(_prefix(f"{base}.{n}", layernorm(lp[n])))
    return sd


def state_dict_from_jax(variables) -> StateDict:
    """The JAX package's GPV `{"params", "batch_stats"}` -> this package's
    GPV `state_dict` (reference torch names)."""
    p, stats = variables["params"], variables["batch_stats"]
    sd = _prefix("detr", detr(p["detr"], stats["detr"]))
    sd.update(_prefix("detr_joiner", linear(p["detr_joiner"])))
    sd.update(_prefix("bert", bert(p["bert"])))
    sd.update(_prefix("bert_joiner", linear(p["bert_joiner"])))
    for i in range(sum(k.startswith("co_att") for k in p)):
        sd.update(_prefix(f"co_att_transformer.{i}",
                          co_attention_layer(p[f"co_att{i}"])))
    sd.update(_prefix("relevance_predictor",
                      linear(p["relevance_predictor"])))
    sd.update(_prefix("text_decoder", text_decoder(p["text_decoder"])))
    sd["answer_head.vocab_embed"] = _t(p["vocab_embed"])
    if "classifier" in p:  # answer_head: linear
        sd.update(_prefix("answer_head.classifier", linear(p["classifier"])))
    else:
        sd.update(_prefix("answer_head.classifier_transform",
                          linear(p["classifier_transform"])))
    sd.update(_prefix("answer_input_embedings.transform",
                      linear(p["answer_input_transform"])))
    for n in ("vision_token", "lang_token", "relevance_tokens"):
        sd[n] = _t(p[n])
    return sd


def _s2d_stem(model: nn.Module, conv_name: str) -> bool:
    """Whether `conv_name` is the conv1 of a ResNet with the s2d stem."""
    parent, _, leaf = conv_name.rpartition(".")
    trunk = model.get_submodule(parent)
    return (leaf == "conv1" and isinstance(trunk, ResNet)
            and trunk.stem_s2d)


@torch.no_grad()
def init_random(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter and persistent buffer of `model` from a seeded
    generator: weight matrices and conv kernels N(0, 1/fan_in), biases 0,
    LayerNorm scales 1, embeddings and the GPV tokens N(0, 0.1^2), frozen-BN
    statistics near identity (Deformable DETR's GroupNorms as the
    LayerNorms, its level embedding as a weight matrix). The same seed
    gives the same weights whatever the model's device. A space-to-depth
    stem takes the 7x7 kernel the plain stem would draw, rewritten
    (`ops.stem_s2d`), so both stems give one function for one seed."""
    g = torch.Generator().manual_seed(seed)

    def randn(shape, std):
        return torch.randn(shape, generator=g) * std

    def near_one(shape):
        return torch.rand(shape, generator=g) + 0.5

    for name, t in model.state_dict(keep_vars=True).items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        shape = t.shape
        if isinstance(owner, FrozenBatchNorm):
            val = (near_one(shape) if leaf in ("weight", "running_var")
                   else randn(shape, 0.1))
        elif isinstance(owner, (nn.LayerNorm, nn.GroupNorm)):
            val = torch.ones(shape) if leaf == "weight" else torch.zeros(shape)
        elif leaf.endswith("bias"):
            val = torch.zeros(shape)
        elif leaf == "weight" and _s2d_stem(model, owner_name):
            c = shape[1] // 4
            val = s2d_stem_kernel(randn((shape[0], c, 7, 7),
                                        1.0 / math.sqrt(c * 49)))
        elif t.dim() >= 2 and not isinstance(owner, nn.Embedding) \
                and leaf not in ("vocab_embed", "relevance_tokens"):
            val = randn(shape, 1.0 / math.sqrt(math.prod(shape[1:])))
        else:  # embeddings, vocab embedding, GPV tokens
            val = randn(shape, 0.1)
        t.copy_(val)
    return model


def strip_ddp_prefix(sd: StateDict) -> StateDict:
    """Drop the DDP `module.` prefix (reference inference.py:57-62)."""
    if any(k.startswith("module.") for k in sd):
        return {k[len("module."):] if k.startswith("module.") else k: v
                for k, v in sd.items()}
    return sd


def load_torch_state_dict(path: str | Path) -> StateDict:
    """A reference torch checkpoint -> its state dict on the CPU: the
    `model` entry of a training checkpoint, or the file's dict itself,
    with the DDP prefix stripped. Loaded with `weights_only=True`, so the
    file can hold tensors and plain containers only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return strip_ddp_prefix(dict(ckpt.get("model", ckpt)))


def orbax_refusal(path) -> str:
    """The message for a checkpoint directory: an orbax checkpoint of the
    JAX package, which this package reads only once converted."""
    return (f"{path} is a directory, an orbax checkpoint of the JAX package: "
            "gpv_tpu_torch reads it once converted, where JAX is installed: "
            "python convert_orbax_checkpoint.py exp_dir=<JAX run> "
            f"name={Path(path).name} out=<dir>; then pass <dir>/"
            f"{Path(path).name}")


def load_bert_weights(bert: nn.Module, sd: StateDict) -> nn.Module:
    """Load an HF-named BERT state dict (`<prefix>embeddings.*` and
    `<prefix>encoder.layer.*`, the prefix found from the word embedding,
    e.g. '' for `BertModel`, `bert.` or the reference's `bert.model.`)
    into a `BertEncoder`, strictly; the pooler, the pre-training heads and
    the `position_ids` buffer are left out."""
    sd = strip_ddp_prefix(sd)
    word = "embeddings.word_embeddings.weight"
    prefix = next((k[:-len(word)] for k in sd if k.endswith(word)), None)
    if prefix is None:
        raise KeyError(f"no '{word}' in the state dict: not a BERT")
    body = {}
    for k, v in sd.items():
        rest = k[len(prefix):]
        if k.startswith(prefix) and rest.startswith(("embeddings.",
                                                     "encoder.layer.")) \
                and rest != "embeddings.position_ids":
            body[f"model.{rest}"] = torch.as_tensor(v)
    bert.load_state_dict(body, strict=True)
    return bert
