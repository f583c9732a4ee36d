"""Torch-checkpoint importers (port of evoke_tpu/models/torch_import.py):
torchvision ResNet-101, HF BERT (SciBERT, CheXbert), distilgpt2,
BertGeneration and EVOKE's released FineTune checkpoint (``model_best.pth``).

Each importer maps EVOKE's / HF's state-dict keys straight onto the port's
keys (the flax paths joined by ``.``, ``params.py``). The port's tensors
already have torch's layouts (``Dense.weight`` is ``[out, in]``, a ``Conv``
weight OIHW), so a torch ``Linear`` or ``Conv2d`` weight is copied as it is.
Two sources are not in torch's layout: GPT-2's ``Conv1D`` weights are
``[in, out]`` (transposed here; its fused ``c_attn`` is split into q / k / v)
and the projection heads' ``Conv1d(k=1)`` weights are ``[out, in, 1]``
(squeezed).

A target is a port module (filled in place) or its ``state_dict`` (a new
dict is returned; the given one is left as it was). Every importer returns
``(target, report)``, the JAX importer's report: ``loaded``, ``mismatched``
(skipped for their shape, the reference's ``ignore_mismatched_sizes``, e.g.
token embeddings under another vocab) and ``missing`` (no such tensor in the
target), with the source keys of the last two in ``mismatched_keys`` /
``missing_keys`` (``"<source> -> <port key>..."``). Values are cast to float32
first, the dtype of every leaf of the JAX tree, and then to the target's
dtype, as ``params.load_flax_variables`` carries JAX weights over.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

Target = Union[torch.nn.Module, Mapping[str, torch.Tensor]]
Report = Dict[str, Any]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """``torch.load`` on the CPU; a ``state_dict`` / ``model_state_dict``
    wrapper is unwrapped; tensors come back as numpy arrays."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in blob.items()
            if hasattr(v, "detach")}


class _Tensors:
    """The target's tensors by port key, seen under ``prefix`` (what a flax
    sub-tree is to the JAX importers)."""

    def __init__(self, tensors: Dict[str, torch.Tensor], inplace: bool, prefix: str = ""):
        self.tensors, self.inplace, self.prefix = tensors, inplace, prefix

    def sub(self, prefix: str) -> "_Tensors":
        return _Tensors(self.tensors, self.inplace, self.prefix + prefix)

    def get(self, key: str) -> Optional[torch.Tensor]:
        return self.tensors.get(self.prefix + key)

    def has(self, child: str) -> bool:
        head = self.prefix + child + "."
        return any(k.startswith(head) for k in self.tensors)

    def count(self, stem: str) -> int:
        """Children named ``<stem><digits>`` (the JAX importers' layer count)."""
        n = len(self.prefix)
        names = {k[n:].split(".", 1)[0] for k in self.tensors if k.startswith(self.prefix)}
        return len([c for c in names if c.startswith(stem) and c[len(stem):].isdigit()])

    def put(self, key: str, value: np.ndarray) -> None:
        src = torch.from_numpy(np.asarray(value).astype(np.float32, copy=False))
        full = self.prefix + key
        if self.inplace:
            with torch.no_grad():
                self.tensors[full].copy_(src)
        else:
            old = self.tensors[full]
            self.tensors[full] = src.to(device=old.device, dtype=old.dtype, copy=True)


def _open(target) -> _Tensors:
    if isinstance(target, _Tensors):
        return target
    if isinstance(target, torch.nn.Module):
        return _Tensors(target.state_dict(), inplace=True)
    return _Tensors(dict(target), inplace=False)


def _close(target, t: _Tensors) -> Target:
    return target if t.inplace or isinstance(target, _Tensors) else t.tensors


def _numpy(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
            for k, v in state_dict.items()}


def _new_report() -> Report:
    return {"loaded": 0, "mismatched": 0, "missing": 0}


def _assign(t: _Tensors, key: str, value, report: Report, src: str) -> None:
    """Copy ``value`` to the port key ``key``, or count it missing (no such
    tensor) or mismatched (another shape), as JAX's ``_assign`` does."""
    have = t.get(key)
    if have is None:
        report["missing"] += 1
        report.setdefault("missing_keys", []).append(f"{src} -> {t.prefix}{key}")
        return
    if tuple(have.shape) != tuple(value.shape):
        report["mismatched"] += 1
        report.setdefault("mismatched_keys", []).append(
            f"{src} -> {t.prefix}{key}: {tuple(have.shape)} vs {value.shape}")
        return
    t.put(key, value)
    report["loaded"] += 1


def _torch_layout(w) -> np.ndarray:
    """A torch ``Linear`` / ``Conv2d`` weight is already in the port's layout.
    An absent key (``None``) becomes a 0-d array and counts as mismatched,
    as JAX's transpose of it does."""
    return np.asarray(w)


def _add(report: Report, other: Report) -> None:
    for k in ("loaded", "mismatched", "missing"):
        report[k] += other[k]


def import_resnet101(state_dict: Mapping[str, Any], target: Target
                     ) -> Tuple[Target, Report]:
    """A torchvision resnet101 state_dict onto a ``VisualExtractor`` (keys
    ``backbone.*``). The blocks are the target's own: ResNet-101's
    (3, 4, 23, 3) unless it was built with other stage sizes."""
    state_dict = _numpy(state_dict)
    t = _open(target)
    params = t.sub("backbone.")
    report = _new_report()

    def put_bn(src: str, dst: str):
        _assign(params, f"{dst}.weight", state_dict[f"{src}.weight"], report, src)
        _assign(params, f"{dst}.bias", state_dict[f"{src}.bias"], report, src)
        _assign(params, f"{dst}.running_mean", state_dict[f"{src}.running_mean"], report, src)
        _assign(params, f"{dst}.running_var", state_dict[f"{src}.running_var"], report, src)

    _assign(params, "conv1.weight", _torch_layout(state_dict["conv1.weight"]), report, "conv1")
    put_bn("bn1", "bn1")
    s = 1
    while params.has(f"layer{s}_0"):
        i = 0
        while params.has(f"layer{s}_{i}"):
            src, dst = f"layer{s}.{i}", f"layer{s}_{i}"
            for c in ("conv1", "conv2", "conv3"):
                _assign(params, f"{dst}.{c}.weight",
                        _torch_layout(state_dict[f"{src}.{c}.weight"]), report, src)
            for b in ("bn1", "bn2", "bn3"):
                put_bn(f"{src}.{b}", f"{dst}.{b}")
            if f"{src}.downsample.0.weight" in state_dict:
                _assign(params, f"{dst}.downsample_conv.weight",
                        _torch_layout(state_dict[f"{src}.downsample.0.weight"]), report, src)
                put_bn(f"{src}.downsample.1", f"{dst}.downsample_bn")
            i += 1
        s += 1
    return _close(target, t), report


def import_bert_encoder(state_dict: Mapping[str, Any], target: Target, prefix: str = ""
                        ) -> Tuple[Target, Report]:
    """An HF BertModel state_dict (keys under ``prefix``) onto a port
    ``TextEncoder``. Shape-mismatched tensors (e.g. word embeddings under an
    overridden vocab) are skipped, as ``ignore_mismatched_sizes=True`` does;
    layers beyond the target's depth are ignored (the reference keeps the
    first N), and a layer the checkpoint lacks is left as it was."""
    state_dict = _numpy(state_dict)
    params = _open(target)
    report = _new_report()

    def sd(key: str):
        return state_dict.get(prefix + key)

    emb = params.sub("embeddings.")
    for src, dst in (("embeddings.word_embeddings.weight", "word_embeddings.weight"),
                     ("embeddings.position_embeddings.weight", "position_embeddings.weight"),
                     ("embeddings.token_type_embeddings.weight",
                      "token_type_embeddings.weight"),
                     ("embeddings.LayerNorm.weight", "LayerNorm_0.weight"),
                     ("embeddings.LayerNorm.bias", "LayerNorm_0.bias")):
        v = sd(src)
        if v is not None:
            _assign(emb, dst, v, report, src)

    for i in range(params.count("layer_")):
        if sd(f"encoder.layer.{i}.attention.self.query.weight") is None:
            continue
        lp = params.sub(f"layer_{i}.")
        att = f"encoder.layer.{i}.attention"
        for name, dstk in (("query", "wq"), ("key", "wk"), ("value", "wv")):
            _assign(lp, f"attention.{dstk}.weight",
                    _torch_layout(sd(f"{att}.self.{name}.weight")), report, att)
            _assign(lp, f"attention.{dstk}.bias", sd(f"{att}.self.{name}.bias"), report, att)
        _assign(lp, "attention.out.Dense_0.weight",
                _torch_layout(sd(f"{att}.output.dense.weight")), report, att)
        _assign(lp, "attention.out.Dense_0.bias", sd(f"{att}.output.dense.bias"), report, att)
        _assign(lp, "attention.out.LayerNorm_0.weight", sd(f"{att}.output.LayerNorm.weight"),
                report, att)
        _assign(lp, "attention.out.LayerNorm_0.bias", sd(f"{att}.output.LayerNorm.bias"),
                report, att)
        ff = f"encoder.layer.{i}"
        _import_ffn(lp.sub("ffn."), lambda k, r=ff: sd(f"{r}.{k}"), report, ff, ff)
    return _close(target, params), report


def detect_bert_prefix(state_dict: Mapping[str, Any]) -> str:
    for cand in ("", "bert.", "bert_model.", "model.", "module.bert."):
        if f"{cand}embeddings.word_embeddings.weight" in state_dict:
            return cand
    return ""


# --------------------------------------------------------------------------
# Full FineTune import (released EVOKE model_best.pth format)
# --------------------------------------------------------------------------

def _strip_module(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Drop a DataParallel 'module.' prefix if every key carries it."""
    if state_dict and all(k.startswith("module.") for k in state_dict):
        return {k[len("module."):]: v for k, v in state_dict.items()}
    return state_dict


def _sub_dict(state_dict: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


_RESNET_SEQ = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
               "6": "layer3", "7": "layer4"}


def _resnet_seq_to_named(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """EVOKE wraps torchvision resnet children in nn.Sequential
    (modules/visual_extractor.py:15-16), so keys are 'model.0.weight' etc.
    Remap the Sequential indices back to torchvision names; the others
    (ReLU, MaxPool, the pooling head) hold no tensors and are dropped."""
    out = {}
    for k, v in sd.items():
        idx, _, rest = k.partition(".")
        name = _RESNET_SEQ.get(idx)
        if name is None:
            continue
        out[f"{name}.{rest}" if rest else name] = v
    return out


SD = Callable[[str], Any]


def _import_ffn(ffn: _Tensors, sd: SD, report: Report, src_in: str, src_out: str) -> None:
    """HF BertIntermediate + BertOutput -> the port's ``ffn`` (Dense_0,
    BertSelfOutput_0)."""
    _assign(ffn, "Dense_0.weight", _torch_layout(sd("intermediate.dense.weight")),
            report, src_in)
    _assign(ffn, "Dense_0.bias", sd("intermediate.dense.bias"), report, src_in)
    _assign(ffn, "BertSelfOutput_0.Dense_0.weight", _torch_layout(sd("output.dense.weight")),
            report, src_out)
    _assign(ffn, "BertSelfOutput_0.Dense_0.bias", sd("output.dense.bias"), report, src_out)
    _assign(ffn, "BertSelfOutput_0.LayerNorm_0.weight", sd("output.LayerNorm.weight"),
            report, src_out)
    _assign(ffn, "BertSelfOutput_0.LayerNorm_0.bias", sd("output.LayerNorm.bias"),
            report, src_out)


def _import_bert_hf_layer(lp: _Tensors, sd: SD, at: str, report: Report) -> None:
    """One HF-format Bert(Cross)Layer attention block: sd keys rooted at
    '{at}.self.*' / '{at}.output.*' -> the port's BertAttentionBlock ``lp``."""
    for name, dstk in (("query", "wq"), ("key", "wk"), ("value", "wv")):
        w = sd(f"{at}.self.{name}.weight")
        if w is None:
            report["missing"] += 1
            continue
        _assign(lp, f"{dstk}.weight", _torch_layout(w), report, at)
        _assign(lp, f"{dstk}.bias", sd(f"{at}.self.{name}.bias"), report, at)
    if sd(f"{at}.output.dense.weight") is not None:
        _assign(lp, "out.Dense_0.weight", _torch_layout(sd(f"{at}.output.dense.weight")),
                report, at)
        _assign(lp, "out.Dense_0.bias", sd(f"{at}.output.dense.bias"), report, at)
        _assign(lp, "out.LayerNorm_0.weight", sd(f"{at}.output.LayerNorm.weight"), report, at)
        _assign(lp, "out.LayerNorm_0.bias", sd(f"{at}.output.LayerNorm.bias"), report, at)


def _import_fusion_block(lp: _Tensors, sd: SD, report: Report, cross: bool) -> None:
    """BertLayer / BertCrossLayer (reference bert_model.py:444,548)."""
    _import_bert_hf_layer(lp.sub("attention."), sd, "attention", report)
    if cross:
        _import_bert_hf_layer(lp.sub("crossattention."), sd, "crossattention", report)
    _import_ffn(lp.sub("ffn."), sd, report, "intermediate", "output")


def _import_projection_head(head: _Tensors, sd: SD, report: Report) -> None:
    """VisualProjectionHeadFinetune / TextProjectionHeadFinetune
    (utils_v0511.py:171-209): Conv1d(k=1) -> BN -> ReLU -> Conv1d(k=1) ->
    BN(affine=False). A Conv1d weight [out, in, 1] is a Dense weight once
    squeezed."""
    def conv1d(w):
        return w[:, :, 0]

    bn0, bn1 = "SeqBatchNorm_0.BatchNorm_0", "SeqBatchNorm_1.BatchNorm_0"
    _assign(head, "Dense_0.weight", conv1d(sd("head.0.weight")), report, "head.0")
    _assign(head, "Dense_0.bias", sd("head.0.bias"), report, "head.0")
    _assign(head, f"{bn0}.weight", sd("head.1.weight"), report, "head.1")
    _assign(head, f"{bn0}.bias", sd("head.1.bias"), report, "head.1")
    _assign(head, f"{bn0}.running_mean", sd("head.1.running_mean"), report, "head.1")
    _assign(head, f"{bn0}.running_var", sd("head.1.running_var"), report, "head.1")
    _assign(head, "Dense_1.weight", conv1d(sd("head.3.weight")), report, "head.3")
    _assign(head, "Dense_1.bias", sd("head.3.bias"), report, "head.3")
    # trailing BN is affine-free: running stats only
    _assign(head, f"{bn1}.running_mean", sd("head.4.running_mean"), report, "head.4")
    _assign(head, f"{bn1}.running_var", sd("head.4.running_var"), report, "head.4")


def _import_linear(t: _Tensors, dst: str, sd: SD, src: str, report: Report,
                   at: str) -> None:
    _assign(t, f"{dst}.weight", _torch_layout(sd(f"{src}.weight")), report, at)
    _assign(t, f"{dst}.bias", sd(f"{src}.bias"), report, at)


def _import_mha(lp: _Tensors, sd: SD, prefix: str, report: Report) -> None:
    """Reference MultiHeadedAttention (encoder_decoder.py:182-207): linears.{0..3}
    = q, k, v, out -> the port's wq / wk / wv / wo."""
    for i, dst in enumerate(("wq", "wk", "wv", "wo")):
        _import_linear(lp, dst, sd, f"{prefix}.linears.{i}", report, prefix)


def _import_cln(lp: _Tensors, sd: SD, prefix: str, report: Report) -> None:
    """ConditionalLayerNorm (encoder_decoder.py:144-178): gamma/beta +
    mlp_gamma/mlp_beta Sequentials (indices 0 and 2 are the Linears)."""
    _assign(lp, "gamma", sd(f"{prefix}.gamma"), report, prefix)
    _assign(lp, "beta", sd(f"{prefix}.beta"), report, prefix)
    for mlp in ("mlp_gamma", "mlp_beta"):
        _import_linear(lp, f"{mlp}_0", sd, f"{prefix}.{mlp}.0", report, prefix)
        _import_linear(lp, f"{mlp}_1", sd, f"{prefix}.{mlp}.2", report, prefix)


def _import_feed_forward(lp: _Tensors, sd: SD, base: str, report: Report) -> None:
    _import_linear(lp, "ff.Dense_0", sd, f"{base}.feed_forward.w_1", report, base)
    _import_linear(lp, "ff.Dense_1", sd, f"{base}.feed_forward.w_2", report, base)


def _import_rm_decoder(params: _Tensors, sd: SD, report: Report) -> None:
    """EVOKE EncoderDecoder (encoder_decoder.py:303-404) -> the port's RMDecoder."""
    _import_linear(params, "att_embed", sd, "att_embed.0", report, "att_embed")

    for i in range(params.count("enc_")):
        lp = params.sub(f"enc_{i}.")
        base = f"model.encoder.layers.{i}"
        _import_mha(lp.sub("self_attn."), sd, f"{base}.self_attn", report)
        for j, norm in ((0, "norm1"), (1, "norm2")):
            _assign(lp, f"{norm}.gamma", sd(f"{base}.sublayer.{j}.norm.gamma"), report, base)
            _assign(lp, f"{norm}.beta", sd(f"{base}.sublayer.{j}.norm.beta"), report, base)
        _import_feed_forward(lp, sd, base, report)
    _assign(params, "enc_norm.gamma", sd("model.encoder.norm.gamma"), report, "enc_norm")
    _assign(params, "enc_norm.beta", sd("model.encoder.norm.beta"), report, "enc_norm")

    for i in range(params.count("dec_")):
        lp = params.sub(f"dec_{i}.")
        base = f"model.decoder.layers.{i}"
        _import_mha(lp.sub("self_attn."), sd, f"{base}.self_attn", report)
        _import_mha(lp.sub("src_attn."), sd, f"{base}.src_attn", report)
        for j, cln in ((0, "cln1"), (1, "cln2"), (2, "cln3")):
            _import_cln(lp.sub(f"{cln}."), sd, f"{base}.sublayer.{j}.norm", report)
        _import_feed_forward(lp, sd, base, report)
    _assign(params, "dec_norm.gamma", sd("model.decoder.norm.gamma"), report, "dec_norm")
    _assign(params, "dec_norm.beta", sd("model.decoder.norm.beta"), report, "dec_norm")

    _assign(params, "tgt_embed.lut.weight", sd("model.tgt_embed.0.lut.weight"),
            report, "tgt_embed")
    _import_mha(params.sub("rm.attn."), sd, "model.rm.attn", report)
    _import_linear(params, "rm.mlp1", sd, "model.rm.mlp.0", report, "rm")
    _import_linear(params, "rm.mlp2", sd, "model.rm.mlp.2", report, "rm")
    _import_linear(params, "rm.W", sd, "model.rm.W", report, "rm")
    _import_linear(params, "rm.U", sd, "model.rm.U", report, "rm")
    _import_linear(params, "logit", sd, "logit", report, "logit")


def import_gpt2_decoder(state_dict: Mapping[str, Any], target: Target
                        ) -> Tuple[Target, Report]:
    """An HF GPT-2 (distilgpt2) state_dict onto a port ``CausalDecoder``.

    Mirrors the reference's DistilGPT2TextDecoderModel construction
    (language_model.py:161 — GPT2LMHeadModel inside an EncoderDecoderModel):
    the causal-LM stack loads from the checkpoint, cross-attention blocks stay
    freshly initialized (HF adds them randomly too). GPT-2 Conv1D weights are
    stored [in, out] and are transposed here; c_attn is fused qkv, split here.
    The position table is sliced to the target's max_positions; token
    embeddings (and the tied LM head) load when the vocab matches
    (ignore_mismatched_sizes semantics otherwise)."""
    state_dict = _strip_module(_numpy(state_dict))
    if any(k.startswith("transformer.") for k in state_dict):
        state_dict = _sub_dict(state_dict, "transformer.")
    t = _open(target)
    report = _new_report()

    wte = state_dict.get("wte.weight")
    if wte is not None:
        _assign(t, "tok_embed.weight", wte, report, "wte")
        # tied LM head: the logit weight [vocab, d] is wte itself
        _assign(t, "logit.weight", wte, report, "lm_head")
    wpe = state_dict.get("wpe.weight")
    if wpe is not None:
        n_pos = t.get("pos_embed.weight").shape[0]
        _assign(t, "pos_embed.weight", wpe[:n_pos], report, "wpe")

    for i in range(t.count("layer_")):
        if f"h.{i}.ln_1.weight" not in state_dict:
            continue
        lp = t.sub(f"layer_{i}.")
        h = f"h.{i}."
        _assign(lp, "ln1.weight", state_dict[h + "ln_1.weight"], report, "ln_1")
        _assign(lp, "ln1.bias", state_dict[h + "ln_1.bias"], report, "ln_1")
        ca_w = state_dict[h + "attn.c_attn.weight"]      # [d, 3d], Conv1D [in, out]
        ca_b = state_dict[h + "attn.c_attn.bias"]
        d = ca_w.shape[0]
        for j, name in enumerate(("wq", "wk", "wv")):
            _assign(lp, f"self_attn.{name}.weight", ca_w[:, j * d:(j + 1) * d].T,
                    report, "c_attn")
            _assign(lp, f"self_attn.{name}.bias", ca_b[j * d:(j + 1) * d], report, "c_attn")
        _assign(lp, "self_attn.wo.weight", state_dict[h + "attn.c_proj.weight"].T,
                report, "c_proj")
        _assign(lp, "self_attn.wo.bias", state_dict[h + "attn.c_proj.bias"], report, "c_proj")
        # GPT-2's pre-FFN norm maps to ln3 (ln2 guards the added cross block)
        _assign(lp, "ln3.weight", state_dict[h + "ln_2.weight"], report, "ln_2")
        _assign(lp, "ln3.bias", state_dict[h + "ln_2.bias"], report, "ln_2")
        _assign(lp, "ff.Dense_0.weight", state_dict[h + "mlp.c_fc.weight"].T, report, "mlp")
        _assign(lp, "ff.Dense_0.bias", state_dict[h + "mlp.c_fc.bias"], report, "mlp")
        _assign(lp, "ff.Dense_1.weight", state_dict[h + "mlp.c_proj.weight"].T, report, "mlp")
        _assign(lp, "ff.Dense_1.bias", state_dict[h + "mlp.c_proj.bias"], report, "mlp")
    _assign(t, "final_ln.weight", state_dict["ln_f.weight"], report, "ln_f")
    _assign(t, "final_ln.bias", state_dict["ln_f.bias"], report, "ln_f")
    return _close(target, t), report


def import_bertgeneration_decoder(state_dict: Mapping[str, Any], target: Target
                                  ) -> Tuple[Target, Report]:
    """An HF BertGenerationDecoder (or plain BERT encoder) state_dict onto a
    port ``BertGenerationDecoder``.

    Mirrors the reference's ``TextDecoderModel`` construction
    (models/language_encoder/language_model.py:24-37):
    ``AutoModelForCausalLM.from_pretrained(text_checkpoint, is_decoder=True,
    add_cross_attention=True, ignore_mismatched_sizes=True)``. Semantics:
    shape-mismatched tensors (e.g. word embeddings under an overridden vocab)
    are skipped; ``crossattention`` blocks and the LM head load when the
    checkpoint carries them (a saved BertGenerationDecoder) and stay freshly
    initialized when it is a plain encoder checkpoint; token-type embeddings
    are dropped (the bert_generation architecture has none)."""
    state_dict = _strip_module(_numpy(state_dict))
    prefix = detect_bert_prefix(state_dict)
    t = _open(target)
    report = _new_report()

    def sd(key: str):
        return state_dict.get(prefix + key)

    emb = t.sub("embeddings.")
    for src, dst in (("embeddings.word_embeddings.weight", "word_embeddings.weight"),
                     ("embeddings.position_embeddings.weight", "position_embeddings.weight"),
                     ("embeddings.LayerNorm.weight", "LayerNorm_0.weight"),
                     ("embeddings.LayerNorm.bias", "LayerNorm_0.bias")):
        v = sd(src)
        if v is not None:
            if dst == "position_embeddings.weight":
                v = v[:emb.get(dst).shape[0]]
            _assign(emb, dst, v, report, src)

    for i in range(t.count("layer_")):
        root = f"encoder.layer.{i}"
        if sd(f"{root}.attention.self.query.weight") is None:
            continue
        layer_sd = lambda key, r=root: sd(f"{r}.{key}")
        has_cross = sd(f"{root}.crossattention.self.query.weight") is not None
        lp = t.sub(f"layer_{i}.")
        _import_bert_hf_layer(lp.sub("attention."), layer_sd, "attention", report)
        if has_cross:
            _import_bert_hf_layer(lp.sub("crossattention."), layer_sd, "crossattention",
                                  report)
        _import_ffn(lp.sub("ffn."), layer_sd, report, root, root)

    # BertGenerationOnlyLMHead: lm_head.decoder [vocab, hidden] + bias
    head_w = state_dict.get("lm_head.decoder.weight")
    if head_w is not None:
        _assign(t, "lm_head.weight", _torch_layout(head_w), report, "lm_head")
        head_b = state_dict.get("lm_head.decoder.bias")
        if head_b is None:
            head_b = state_dict.get("lm_head.bias")
        if head_b is not None:
            _assign(t, "lm_head.bias", head_b, report, "lm_head")
    return _close(target, t), report


def import_finetune_checkpoint(state_dict: Mapping[str, Any], target: Target
                               ) -> Tuple[Target, Report]:
    """A full EVOKE FineTune state_dict (the released ``model_best.pth``
    trees, models/model_pretrain_finetune_v0425_ablation.py:23-231) onto a
    port ``FinetuneModel`` built with ``fusion_wide_qkv=True`` (the
    reference's attention dimensioning, modules/utils_v0511.py:210-281);
    shapes that do not fit are skipped and counted. The co-attention stacks
    and the decoder's depth are the target's own. BatchNorm
    ``num_batches_tracked`` tensors have no counterpart and are not read.
    """
    state_dict = _strip_module(_numpy(state_dict))
    t = _open(target)
    report = _new_report()

    # visual extractor (Sequential-index remap -> torchvision names)
    resnet_sd = _resnet_seq_to_named(_sub_dict(state_dict, "visual_extractor.model."))
    _, r = import_resnet101(resnet_sd, t.sub("visual_extractor."))
    _add(report, r)

    # text encoder (HF BertModel under text_encoder.encoder.)
    _, r = import_bert_encoder(state_dict, t.sub("text_encoder."),
                               prefix="text_encoder.encoder.")
    _add(report, r)

    # multiview fusion: the two LayerNorms live on the top-level reference model
    fus = t.sub("fusion.")
    for ln in ("layer_norm_1", "layer_norm_2"):
        _assign(fus, f"{ln}.weight", state_dict[f"{ln}.weight"], report, ln)
        _assign(fus, f"{ln}.bias", state_dict[f"{ln}.bias"], report, ln)
    for fc in ("fc_q", "fc_k", "fc_v", "fc_o"):
        _assign(fus, f"cross.{fc}.weight",
                _torch_layout(state_dict[f"multiview_cross_attention.{fc}.weight"]),
                report, fc)
        _assign(fus, f"cross.{fc}.bias", state_dict[f"multiview_cross_attention.{fc}.bias"],
                report, fc)

    def sub_sd(prefix):
        d = _sub_dict(state_dict, prefix)
        return lambda k: d.get(k)

    _import_projection_head(t.sub("visual_head."), sub_sd("visual_head."), report)
    _import_projection_head(t.sub("text_head."), sub_sd("text_head."), report)

    # indication co-attention / self-attention stacks
    i = 0
    while t.has(f"multimodal_fusion_layers_{i}"):
        _import_fusion_block(t.sub(f"multimodal_fusion_layers_{i}."),
                             sub_sd(f"multimodal_fusion_layers.{i}."), report, cross=True)
        i += 1
    i = 0
    while t.has(f"visual_self_atten_layers_{i}"):
        _import_fusion_block(t.sub(f"visual_self_atten_layers_{i}."),
                             sub_sd(f"visual_self_atten_layers.{i}."), report, cross=False)
        i += 1

    # R2Gen decoder
    _import_rm_decoder(t.sub("text_decoder."), sub_sd("text_decoder."), report)
    return _close(target, t), report


def load_finetune_checkpoint(path: str, target: Target) -> Tuple[Target, Report]:
    """Load a released EVOKE ``model_best.pth`` (README.md:22-27) into a port
    ``FinetuneModel`` (or its state_dict). The .pth is a dict with a
    'state_dict' entry (trainer_v0401.py:160-176)."""
    return import_finetune_checkpoint(load_torch_state_dict(path), target)
