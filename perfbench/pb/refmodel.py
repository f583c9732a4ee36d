"""Plain PyTorch reference of the EVOKE finetune model, in float32.

The benchmark's yardstick for ``correct``: written from the architecture
(EVOKE's FineTune model, arXiv 2411.10224, with the R2Gen and R2GenCMN
decoders), functional over a flat parameter dict whose names are the
serving model's state-dict names, so one set of weights made by the
benchmark loads into both. Nothing here imports the program.

Every matrix product, convolution and table lookup passes its operands
through ``q``: the identity for the reference, and a fake quantizer for the
control (``fp8_quantizer``), which computes the same model in float8 e4m3
operands with float32 accumulation.

Inference paths only: BatchNorms use their running statistics, no dropout.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NEG = -1e9


def identity(x):
    return x


def fp8_quantizer(x):
    """float8 e4m3 fake quantization with one scale per tensor (its absmax
    mapped to 448, the format's largest value); float32 out."""
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = 448.0 / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


# ---- parameter names, shapes and initial values ----

def _dense(spec, name, din, dout, dt, init="normal"):
    spec.append((f"{name}.weight", (dout, din), dt, init))
    spec.append((f"{name}.bias", (dout,), dt, "zero"))


def _bn(spec, name, c, affine=True, scale="one"):
    if affine:
        spec.append((f"{name}.weight", (c,), "f32", scale))
        spec.append((f"{name}.bias", (c,), "f32", "zero"))
    spec.append((f"{name}.running_mean", (c,), "f32", "zero"))
    spec.append((f"{name}.running_var", (c,), "f32", "one"))


def _ln(spec, name, c, torch_style=False):
    a, b = ("gamma", "beta") if torch_style else ("weight", "bias")
    spec.append((f"{name}.{a}", (c,), "f32", "one"))
    spec.append((f"{name}.{b}", (c,), "f32", "zero"))


def _bert_attention(spec, name, d):
    for p in ("wq", "wk", "wv"):
        _dense(spec, f"{name}.{p}", d, d, "compute")
    _dense(spec, f"{name}.out.Dense_0", d, d, "compute")
    _ln(spec, f"{name}.out.LayerNorm_0", d)


def _bert_ffn(spec, name, d, inter):
    _dense(spec, f"{name}.Dense_0", d, inter, "compute")
    _dense(spec, f"{name}.BertSelfOutput_0.Dense_0", inter, d, "compute")
    _ln(spec, f"{name}.BertSelfOutput_0.LayerNorm_0", d)


def _mha(spec, name, d, dt="compute", init="normal"):
    for p in ("wq", "wk", "wv", "wo"):
        _dense(spec, f"{name}.{p}", d, d, dt, init)


RESNET_STAGES = (3, 4, 23, 3)
# Two departures from N(0, 1 / fan_in) keep the random model's arithmetic
# well conditioned, as a trained one is:
# - The relational memory is a gated recurrence over the report. At full scale
#   its random matrices make it chaotic: a 0.1 % change of its input (the bf16
#   rounding of the token embedding) grows to 47 % of its state in 100 steps;
#   at a quarter of that scale it stays under 1 %.
# - Each bottleneck's last BatchNorm scale starts at 0.1, so every residual
#   branch starts small (Goyal et al. 2017 start it at 0).
# Neither changes a shape or an operation count.
RM_INIT = "normal:0.25"
BN3_INIT = "fill:0.1"


def param_spec(m: Dict) -> List[Tuple[str, tuple, str, str]]:
    """[(name, shape, 'compute' | 'f32', init)] of the model described by the
    configuration's ``model`` block; init 'normal' is N(0, 1 / fan_in),
    'normal:s' the same times s, 'one', 'zero' and 'fill:v' constants."""
    s: list = []
    v = "visual_extractor.backbone"
    s.append((f"{v}.conv1.weight", (64, 3, 7, 7), "compute", "normal"))
    _bn(s, f"{v}.bn1", 64)
    cin = 64
    for stage, n in enumerate(RESNET_STAGES):
        f = 64 * 2 ** stage
        for i in range(n):
            b = f"{v}.layer{stage + 1}_{i}"
            s.append((f"{b}.conv1.weight", (f, cin, 1, 1), "compute", "normal"))
            _bn(s, f"{b}.bn1", f)
            s.append((f"{b}.conv2.weight", (f, f, 3, 3), "compute", "normal"))
            _bn(s, f"{b}.bn2", f)
            s.append((f"{b}.conv3.weight", (4 * f, f, 1, 1), "compute", "normal"))
            _bn(s, f"{b}.bn3", 4 * f, scale=BN3_INIT)
            if i == 0:
                s.append((f"{b}.downsample_conv.weight", (4 * f, cin, 1, 1), "compute",
                          "normal"))
                _bn(s, f"{b}.downsample_bn", 4 * f)
            cin = 4 * f
    h, vocab = m["encoder_hidden_size"], m["vocab_size"]
    t = "text_encoder"
    s.append((f"{t}.embeddings.word_embeddings.weight", (vocab, h), "compute", "normal"))
    s.append((f"{t}.embeddings.position_embeddings.weight", (512, h), "compute", "normal"))
    s.append((f"{t}.embeddings.token_type_embeddings.weight", (2, h), "compute", "normal"))
    _ln(s, f"{t}.embeddings.LayerNorm_0", h)
    for i in range(m["encoder_num_layers"]):
        _bert_attention(s, f"{t}.layer_{i}.attention", h)
        _bert_ffn(s, f"{t}.layer_{i}.ffn", h, m["encoder_intermediate_size"])
    dvf, out = m["d_vf"], m["output_dim"]
    for name, din in (("visual_head", dvf), ("text_head", h)):
        _dense(s, f"{name}.Dense_0", din, out, "compute")
        _bn(s, f"{name}.SeqBatchNorm_0.BatchNorm_0", out)
        _dense(s, f"{name}.Dense_1", out, out, "compute")
        _bn(s, f"{name}.SeqBatchNorm_1.BatchNorm_0", out, affine=False)
    _ln(s, "fusion.layer_norm_1", dvf)
    _ln(s, "fusion.layer_norm_2", dvf)
    hd = m["proj_num_heads"] * (dvf if m["fusion_wide_qkv"] else dvf // m["proj_num_heads"])
    for p in ("fc_q", "fc_k", "fc_v"):
        _dense(s, f"fusion.cross.{p}", dvf, hd, "compute")
    _dense(s, "fusion.cross.fc_o", hd, dvf, "compute")
    for i in range(m["sk_fusion_num_layers"]):
        c = f"multimodal_fusion_layers_{i}"
        _bert_attention(s, f"{c}.attention", out)
        _bert_attention(s, f"{c}.crossattention", out)
        _bert_ffn(s, f"{c}.ffn", out, m["fusion_intermediate_size"])
        c = f"visual_self_atten_layers_{i}"
        _bert_attention(s, f"{c}.attention", out)
        _bert_ffn(s, f"{c}.ffn", out, m["fusion_intermediate_size"])
    d, dff = m["d_model"], m["d_ff"]
    dec = "text_decoder"
    _dense(s, f"{dec}.att_embed", out, d, "compute")
    if m["decoder_kind"] == "cmn":
        _mha(s, f"{dec}.cmn", d)
        s.append((f"{dec}.memory_matrix", (m["cmm_size"], m["cmm_dim"]), "f32", "normal"))
    for i in range(m["num_layers"]):
        e = f"{dec}.enc_{i}"
        _mha(s, f"{e}.self_attn", d)
        _dense(s, f"{e}.ff.Dense_0", d, dff, "compute")
        _dense(s, f"{e}.ff.Dense_1", dff, d, "compute")
        _ln(s, f"{e}.norm1", d, True)
        _ln(s, f"{e}.norm2", d, True)
    _ln(s, f"{dec}.enc_norm", d, True)
    mem = m["rm_num_slots"] * m["rm_d_model"]
    for i in range(m["num_layers"]):
        e = f"{dec}.dec_{i}"
        _mha(s, f"{e}.self_attn", d)
        _mha(s, f"{e}.src_attn", d)
        _dense(s, f"{e}.ff.Dense_0", d, dff, "compute")
        _dense(s, f"{e}.ff.Dense_1", dff, d, "compute")
        if m["decoder_kind"] == "cmn":
            for j in (1, 2, 3):
                _ln(s, f"{e}.norm{j}", d, True)
        else:
            for j in (1, 2, 3):
                c = f"{e}.cln{j}"
                _ln(s, c, d, True)
                _dense(s, f"{c}.mlp_gamma_0", mem, d, "f32")
                _dense(s, f"{c}.mlp_gamma_1", d, d, "f32")
                _dense(s, f"{c}.mlp_beta_0", mem, d, "f32")
                _dense(s, f"{c}.mlp_beta_1", d, d, "f32")
    _ln(s, f"{dec}.dec_norm", d, True)
    s.append((f"{dec}.tgt_embed.lut.weight", (vocab + 1, d), "compute", "normal"))
    if m["decoder_kind"] != "cmn":
        _mha(s, f"{dec}.rm.attn", d, "f32", RM_INIT)
        _dense(s, f"{dec}.rm.mlp1", d, d, "f32", RM_INIT)
        _dense(s, f"{dec}.rm.mlp2", d, d, "f32", RM_INIT)
        _dense(s, f"{dec}.rm.W", d, 2 * d, "f32", RM_INIT)
        _dense(s, f"{dec}.rm.U", d, 2 * d, "f32", RM_INIT)
    _dense(s, f"{dec}.logit", d, vocab + 1, "compute")
    return s


# ---- building blocks ----

class Ref:
    """The model over parameters ``P`` (name -> float32 tensor) and the
    configuration's ``model`` block ``m``; ``q`` quantizes operands."""

    def __init__(self, P: Dict[str, torch.Tensor], m: Dict, q: Callable = identity):
        self.P, self.m, self.q = P, m, q

    def dense(self, name, x):
        q = self.q
        return q(x) @ q(self.P[f"{name}.weight"]).t() + self.P[f"{name}.bias"]

    def conv(self, name, x, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(self.P[f"{name}.weight"]), stride=stride,
                        padding=padding)

    def bn(self, name, x, axis):
        """BatchNorm over every axis but ``axis`` with its running statistics
        (eps 1e-5)."""
        P = self.P
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
        y = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + 1e-5)
        if f"{name}.weight" in P:
            y = y * P[f"{name}.weight"].reshape(shape) + P[f"{name}.bias"].reshape(shape)
        return y

    def layer_norm(self, name, x, eps):
        """Biased variance, eps inside the root."""
        return F.layer_norm(x, x.shape[-1:], self.P[f"{name}.weight"], self.P[f"{name}.bias"],
                            eps)

    def torch_ln(self, name, x, eps=1e-6):
        """The reference decoders' LayerNorm: unbiased std, eps added to it."""
        mean = x.mean(-1, keepdim=True)
        std = x.std(-1, keepdim=True, unbiased=True)
        return self.P[f"{name}.gamma"] * (x - mean) / (std + eps) + self.P[f"{name}.beta"]

    def attention(self, q, k, v, mask=None):
        """q [..., h, Tq, dk], k / v [..., h, Tk, dk]; mask True = attend."""
        s = self.q(q) @ self.q(k).transpose(-1, -2) / math.sqrt(q.shape[-1])
        if mask is not None:
            s = s.masked_fill(~mask, NEG)
        return self.q(torch.softmax(s, -1)) @ self.q(v)

    @staticmethod
    def heads(x, h):
        b, t, d = x.shape
        return x.reshape(b, t, h, d // h).transpose(1, 2)

    @staticmethod
    def merge(x):
        b, h, t, dk = x.shape
        return x.transpose(1, 2).reshape(b, t, h * dk)

    # ---- visual encoder ----

    def bottleneck(self, b, x, stride, project):
        y = F.relu(self.bn(f"{b}.bn1", self.conv(f"{b}.conv1", x), 1))
        y = F.relu(self.bn(f"{b}.bn2", self.conv(f"{b}.conv2", y, stride, 1), 1))
        y = self.bn(f"{b}.bn3", self.conv(f"{b}.conv3", y), 1)
        if project:
            x = self.bn(f"{b}.downsample_bn", self.conv(f"{b}.downsample_conv", x, stride), 1)
        return F.relu(y + x)

    def resnet(self, x):
        """NCHW images -> [B, 2048, H/32, W/32]."""
        v = "visual_extractor.backbone"
        x = F.relu(self.bn(f"{v}.bn1", self.conv(f"{v}.conv1", x, 2, 3), 1))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage, n in enumerate(RESNET_STAGES):
            for i in range(n):
                x = self.bottleneck(f"{v}.layer{stage + 1}_{i}", x,
                                    2 if stage > 0 and i == 0 else 1, i == 0)
        return x

    def image_tokens(self, images):
        """uint8 or float NHWC images -> [B, 1 + P, 2048]: the mean patch, then
        the patches."""
        if images.dtype == torch.uint8:
            mean = torch.tensor(IMAGENET_MEAN, device=images.device)
            std = torch.tensor(IMAGENET_STD, device=images.device)
            images = (images.float() / 255.0 - mean) / std
        feats = self.resnet(images.float().permute(0, 3, 1, 2))
        b, c, hh, ww = feats.shape
        patches = feats.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        return torch.cat([patches.mean(1, keepdim=True), patches], 1)

    def fusion(self, tokens, pids, valid, n_anchor):
        """Each anchor's tokens attend the tokens of every other valid view of
        its study (dense form), then
        residual + LayerNorm; an anchor with no such view passes through the
        first LayerNorm."""
        m = self.m
        x = self.layer_norm("fusion.layer_norm_1", tokens, 1e-5)
        b, t, d = x.shape
        h = m["proj_num_heads"]
        same = (pids[:n_anchor, None] == pids[None, :]) & valid[:n_anchor, None] & valid[None, :]
        same &= ~torch.eye(n_anchor, b, dtype=torch.bool, device=x.device)
        xq = x[:n_anchor]
        kv = x
        # the anchors' tokens as one block of queries over every view's tokens
        q = self.heads(self.dense("fusion.cross.fc_q", xq).reshape(1, n_anchor * t, -1), h)
        k = self.heads(self.dense("fusion.cross.fc_k", kv).reshape(1, b * t, -1), h)
        v = self.heads(self.dense("fusion.cross.fc_v", kv).reshape(1, b * t, -1), h)
        mask = same.repeat_interleave(t, 1).repeat_interleave(t, 0)[None, None]
        out = self.merge(self.attention(q, k, v, mask)).reshape(n_anchor, t, -1)
        out = self.dense("fusion.cross.fc_o", out)
        fused = self.layer_norm("fusion.layer_norm_2", out + xq, 1e-5)
        return torch.where(same.any(1)[:, None, None], fused, xq)

    def head(self, name, x):
        x = self.dense(f"{name}.Dense_0", x)
        x = F.relu(self.bn(f"{name}.SeqBatchNorm_0.BatchNorm_0", x, -1))
        x = self.dense(f"{name}.Dense_1", x)
        return self.bn(f"{name}.SeqBatchNorm_1.BatchNorm_0", x, -1)

    # ---- BERT blocks ----

    def bert_attention(self, name, x, kv, mask, h):
        q, k, v = (self.heads(self.dense(f"{name}.{p}", src), h)
                   for p, src in (("wq", x), ("wk", kv), ("wv", kv)))
        ctx = self.merge(self.attention(q, k, v, mask))
        return self.layer_norm(f"{name}.out.LayerNorm_0",
                               self.dense(f"{name}.out.Dense_0", ctx) + x, 1e-12)

    def bert_ffn(self, name, x):
        y = F.gelu(self.dense(f"{name}.Dense_0", x))
        y = self.dense(f"{name}.BertSelfOutput_0.Dense_0", y)
        return self.layer_norm(f"{name}.BertSelfOutput_0.LayerNorm_0", y + x, 1e-12)

    def text_encoder(self, ids, mask):
        m, q = self.m, self.q
        t = "text_encoder.embeddings"
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = (F.embedding(ids.long(), q(self.P[f"{t}.word_embeddings.weight"]))
             + q(self.P[f"{t}.position_embeddings.weight"])[pos][None]
             + q(self.P[f"{t}.token_type_embeddings.weight"])[0])
        x = self.layer_norm(f"{t}.LayerNorm_0", x, 1e-12)
        keys = mask.bool()[:, None, None, :]
        for i in range(m["encoder_num_layers"]):
            x = self.bert_attention(f"text_encoder.layer_{i}.attention", x, x, keys,
                                    m["encoder_num_heads"])
            x = self.bert_ffn(f"text_encoder.layer_{i}.ffn", x)
        return x

    def encode(self, images, pids, valid, n_anchor, inc_ids=None, inc_mask=None):
        """-> [n_anchor, 1 + P, output_dim], the model's fused visual tokens."""
        m = self.m
        x = self.fusion(self.image_tokens(images), pids, valid.bool(), n_anchor)
        x = self.head("visual_head", x)
        h = m["fusion_num_heads"]
        if inc_ids is not None:
            feats = self.head("text_head", self.text_encoder(inc_ids, inc_mask))
            keys = inc_mask.bool()[:, None, None, :]
            for i in range(m["sk_fusion_num_layers"]):
                c = f"multimodal_fusion_layers_{i}"
                x = self.bert_attention(f"{c}.attention", x, x, None, h)
                x = self.bert_attention(f"{c}.crossattention", x, feats, keys, h)
                x = self.bert_ffn(f"{c}.ffn", x)
        else:
            for i in range(m["sk_fusion_num_layers"]):
                c = f"visual_self_atten_layers_{i}"
                x = self.bert_ffn(f"{c}.ffn", self.bert_attention(f"{c}.attention", x, x,
                                                                   None, h))
        return x

    # ---- report decoders ----

    def mha(self, name, x, kv, mask=None):
        h = self.m["num_heads"]
        q, k, v = (self.heads(self.dense(f"{name}.{p}", src), h)
                   for p, src in (("wq", x), ("wk", kv), ("wv", kv)))
        return self.dense(f"{name}.wo", self.merge(self.attention(q, k, v, mask)))

    def ffn(self, name, x):
        return self.dense(f"{name}.Dense_1", F.relu(self.dense(f"{name}.Dense_0", x)))

    def memory_read(self, x):
        """CMN: multi-head attention over the memory matrix, each query
        keeping its top-k slots per head."""
        m, dec = self.m, "text_decoder"
        h = m["num_heads"]
        mem = self.P[f"{dec}.memory_matrix"][None]
        q = self.heads(self.dense(f"{dec}.cmn.wq", x), h)
        k = self.heads(self.dense(f"{dec}.cmn.wk", mem), h)[0]             # [h, M, dk]
        v = self.heads(self.dense(f"{dec}.cmn.wv", mem), h)[0]
        s = torch.einsum("bhtd,hmd->bhtm", self.q(q), self.q(k)) / math.sqrt(q.shape[-1])
        top, idx = s.topk(m["cmn_topk"], dim=-1)
        p = torch.softmax(top, -1)
        hsel = torch.arange(h, device=x.device)[None, :, None, None]
        out = torch.einsum("bhtk,bhtkd->bhtd", self.q(p), self.q(v)[hsel, idx])
        return self.dense(f"{dec}.cmn.wo", self.merge(out))

    def decoder_memory(self, att_feats):
        """The decoder's encoder over the image tokens [B, P, output_dim]."""
        m, dec = self.m, "text_decoder"
        x = F.relu(self.dense(f"{dec}.att_embed", att_feats))
        if m["decoder_kind"] == "cmn":
            x = x + self.memory_read(x)
            x = x + sinusoid(x.shape[1], m["d_model"], x.device)[None]
        for i in range(m["num_layers"]):
            e = f"{dec}.enc_{i}"
            hh = self.torch_ln(f"{e}.norm1", x)
            x = x + self.mha(f"{e}.self_attn", hh, hh)
            x = x + self.ffn(f"{e}.ff", self.torch_ln(f"{e}.norm2", x))
        return self.torch_ln(f"{dec}.enc_norm", x)

    def memory_start(self, b, device):
        """The relational memory before the first token: [b, S, D]."""
        s, d = self.m["rm_num_slots"], self.m["rm_d_model"]
        eye = torch.zeros(s, d, device=device)
        eye[:, :s] = torch.eye(s, device=device)
        return eye[None].repeat(b, 1, 1)

    def memory_step(self, mem, x):
        """One step of the relational memory: mem [B, S, D], x [B, D]."""
        dec, h, d = "text_decoder.rm", self.m["rm_num_heads"], mem.shape[-1]
        kv = torch.cat([mem, x[:, None]], 1)
        q, k, v = (self.heads(self.dense(f"{dec}.attn.{p}", src), h)
                   for p, src in (("wq", mem), ("wk", kv), ("wv", kv)))
        nxt = mem + self.dense(f"{dec}.attn.wo", self.merge(self.attention(q, k, v)))
        nxt = nxt + F.relu(self.dense(f"{dec}.mlp2", F.relu(self.dense(f"{dec}.mlp1", nxt))))
        gates = self.dense(f"{dec}.W", x[:, None]) + self.dense(f"{dec}.U", torch.tanh(mem))
        ig, fg = gates.split(d, -1)
        return torch.sigmoid(ig) * torch.tanh(nxt) + torch.sigmoid(fg) * mem

    def relational_memory(self, xs):
        """xs [B, T, D] -> the memory after each step [B, T, S*D]."""
        b, t, _ = xs.shape
        mem = self.memory_start(b, xs.device)
        outs = []
        for i in range(t):
            mem = self.memory_step(mem, xs[:, i])
            outs.append(mem.reshape(b, -1))
        return torch.stack(outs, 1)

    def cln(self, name, x, mem):
        mean = x.mean(-1, keepdim=True)
        std = x.std(-1, keepdim=True, unbiased=True)
        dg = self.dense(f"{name}.mlp_gamma_1", F.relu(self.dense(f"{name}.mlp_gamma_0", mem)))
        db = self.dense(f"{name}.mlp_beta_1", F.relu(self.dense(f"{name}.mlp_beta_0", mem)))
        return ((self.P[f"{name}.gamma"] + dg) * (x - mean) / (std + 1e-6)
                + self.P[f"{name}.beta"] + db)

    def embed(self, ids):
        """The decoder's input at every position of ``ids`` [B, T]."""
        d, dec = self.m["d_model"], "text_decoder"
        return (F.embedding(ids.long(), self.q(self.P[f"{dec}.tgt_embed.lut.weight"]))
                * math.sqrt(d) + sinusoid(ids.shape[1], d, ids.device)[None])

    def decode_logits(self, enc, ids, mem=None):
        """Teacher-forced logits [B, T, V + 1] of the next token at every
        position of ``ids`` [B, T] (position t sees ids[:, :t + 1]) over the
        decoder memory ``enc`` [B, P, D]; R2Gen's relational memory after each
        position is ``mem`` [B, T, S*D] where the caller has it."""
        m, dec = self.m, "text_decoder"
        t = ids.shape[1]
        x = self.embed(ids)
        causal = torch.ones(t, t, dtype=torch.bool, device=ids.device).tril()
        cmn = m["decoder_kind"] == "cmn"
        if cmn:
            x = x + self.memory_read(x)
        elif mem is None:
            mem = self.relational_memory(x)
        for i in range(m["num_layers"]):
            e = f"{dec}.dec_{i}"
            norm = ((lambda j, y: self.torch_ln(f"{e}.norm{j}", y)) if cmn
                    else (lambda j, y: self.cln(f"{e}.cln{j}", y, mem)))
            hh = norm(1, x)
            x = x + self.mha(f"{e}.self_attn", hh, hh, causal)
            x = x + self.mha(f"{e}.src_attn", norm(2, x), enc)
            x = x + self.ffn(f"{e}.ff", norm(3, x))
        return self.dense(f"{dec}.logit", self.torch_ln(f"{dec}.dec_norm", x))


def sinusoid(t: int, d: int, device) -> torch.Tensor:
    """[t, d] sine / cosine position table."""
    pe = np.zeros((t, d), np.float32)
    pos = np.arange(t, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * -(math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device)


def beam_decode(ref: Ref, enc: torch.Tensor, n: int, beam: int, bos: int,
                banned: List[int]) -> np.ndarray:
    """Beam search over ``ref`` for ``n`` tokens of one study, as the serving
    loops search: each step's candidates are every beam's ``beam`` best next
    tokens scored by log-probability (``banned`` ids out of contention), the
    ``beam`` best running sums survive (at the first step only the first
    beam's), and the best sum is served. ``enc`` [1, P, D] is the decoder
    memory. -> the served tokens [n]."""
    dev = enc.device
    enc = enc.expand(beam, -1, -1)
    ids = torch.full((beam, 1), bos, dtype=torch.long, device=dev)
    scores = torch.zeros(beam, device=dev)
    r2gen = ref.m["decoder_kind"] != "cmn"
    if r2gen:
        state = ref.memory_start(beam, dev)
        mems = torch.zeros(beam, 0, state[0].numel(), device=dev)
    for t in range(n):
        mem = None
        if r2gen:
            state = ref.memory_step(state, ref.embed(ids)[:, -1])
            mem = torch.cat([mems, state.reshape(beam, 1, -1)], 1)
        lg = ref.decode_logits(enc, ids, mem)[:, -1]
        lse = torch.logsumexp(lg, -1)
        lg[:, banned] = -float("inf")
        vals, tok = lg.topk(beam, -1)
        cand = scores[:, None] + vals - lse[:, None]
        if t == 0:
            cand[1:] = -float("inf")
        scores, flat = cand.reshape(-1).topk(beam)
        src = flat // beam
        ids = torch.cat([ids[src], tok.reshape(-1)[flat][:, None]], 1)
        if r2gen:
            state, mems = state[src], mem[src]
    return ids[int(scores.argmax()), 1:].cpu().numpy()


def study_memory(ref: Ref, batch: Dict[str, torch.Tensor], with_indication: bool
                 ) -> torch.Tensor:
    """The decoder memory [1, P, D] of one study: ``batch`` holds its anchor
    (first) and its views."""
    inc = (batch["inc_ids"], batch["inc_mask"]) if with_indication else (None, None)
    hidden = ref.encode(batch["images"], batch["pids"], batch["valid"], 1, *inc)
    return ref.decoder_memory(hidden[:, 1:])


def report_logits(ref: Ref, enc: torch.Tensor, toks: np.ndarray, bos: int) -> torch.Tensor:
    """Teacher-forced logits [len(toks), V + 1] of a report over the decoder
    memory ``enc`` [1, P, D]: row t scores token t."""
    ids = torch.tensor(np.concatenate([[bos], toks[:-1]]), device=enc.device)[None]
    return ref.decode_logits(enc, ids)[0]
