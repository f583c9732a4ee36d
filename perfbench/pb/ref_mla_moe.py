"""Plain PyTorch reference of EVOKE's encoder with Kimi-VL-A3B's language model
as the report decoder (the ``mla_moe`` configurations), and their weights.

The benchmark's yardstick for ``correct`` on those cells, frozen here: a
change to the program cannot change it. Written from the published
description: DeepSeek-V2's multi-head latent attention in its non-absorbed
form (arXiv 2405.04434: each head's keys and values materialised from the
latent), DeepSeek-V3's routing (arXiv 2412.19437: sigmoid scores in float32,
the top-k of score + correction bias, the chosen scores normalised and times
``routed_scaling_factor``, the shared experts added), RoPE with DeepSeek's
interleave permutation, RMSNorm, SwiGLU, an untied head, as Kimi-VL's
language model uses them (arXiv 2504.07491). Departures from Kimi-VL, the
configuration's own: EVOKE's encoder (``pb/refmodel.Ref``, imported) stands in
MoonViT's place, and the projector is LayerNorm -> Linear -> GELU -> Linear
over its 49 patch tokens without the pixel shuffle (7 x 7 does not divide).
Nothing here imports the program.

The language model's weights stay in bfloat16 (the float32 copy would take
63 GB) and each matrix is cast to float32 where it is used, which is exact;
every product runs in float32 with TF32 off. Every matrix product passes its
operands through ``q``: the identity for the reference, the float8 e4m3 fake
quantizer for the control (``refmodel.fp8_quantizer``, one scale per tensor,
per expert for the experts), whose weights are quantized once and kept in
float8.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pb import refmodel
from pb.refmodel import fp8_quantizer, identity
from pb.tokens import SpelledIds

# the language model's keys, as the configuration file carries them (published)
LM_KEYS = ("vocab_size", "max_position_embeddings", "hidden_size", "intermediate_size",
           "moe_intermediate_size", "num_hidden_layers", "num_attention_heads",
           "n_shared_experts", "n_routed_experts", "ep_size", "routed_scaling_factor",
           "kv_lora_rank", "q_lora_rank", "qk_rope_head_dim", "v_head_dim", "qk_nope_head_dim",
           "topk_method", "n_group", "topk_group", "num_experts_per_tok", "moe_layer_freq",
           "first_k_dense_replace", "norm_topk_prob", "scoring_func", "seq_aux",
           "num_key_value_heads", "hidden_act", "rms_norm_eps", "rope_theta", "rope_scaling",
           "attention_bias", "tie_word_embeddings")
PREFIX = "text_decoder"
NEG = -1e9
# One departure from N(0, 1 / fan_in) keeps the random model's arithmetic well
# conditioned, as a trained one is: at full scale a routing flip (a near-tie
# among the top-k that rounding decides) swaps ~0.4 of the layer's routed
# output for another expert's, a change of ~10 % of the token's residual that
# the later layers' routing amplifies. Measured at hidden 512, 27 layers, 64
# experts top 6 on the CPU: bfloat16 against float32 flips a route in 27 % of
# the tokens by layer 5 and 98 % by layer 26, and the logits lie 0.44 apart
# (std), as far as a 1e-3 perturbation of the prefix moves them; with the
# routed experts' down projections at a quarter of that scale 5 % / 18 % of
# the tokens flip and the logits lie 0.05 apart. It changes no shape or
# operation count.
EXPERT_DOWN_INIT = "normal:0.25"


def lm_config(cfg: Dict) -> Dict:
    return {k: cfg[k] for k in LM_KEYS}


def model_kwargs(cfg: Dict) -> Dict:
    """The program's ``FinetuneModel`` keywords of the configuration."""
    return dict(cfg["model"], mla_moe=lm_config(cfg))


# ---- weights ----

def param_spec(cfg: Dict) -> List[Tuple[str, tuple, str, str]]:
    """[(name, shape, 'compute' | 'f32', init)]: EVOKE's encoder as
    ``refmodel.param_spec`` gives it, then the projector and the language
    model under the program's state-dict names. Init 'normal' is
    N(0, 1 / fan_in), fan_in a matrix's input width (an expert's, for the
    stacked experts), 'normal:s' the same times s; 'one' and 'zero'
    constants."""
    m, c = cfg["model"], lm_config(cfg)
    enc = dict(m, decoder_kind="r2gen", num_layers=0, d_model=8, d_ff=8, rm_num_slots=1,
               rm_d_model=8, rm_num_heads=1)
    s = [e for e in refmodel.param_spec(enc) if not e[0].startswith(PREFIX + ".")]
    h, d_vf = c["hidden_size"], m["output_dim"]
    heads, nope, r, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                          c["qk_rope_head_dim"], c["v_head_dim"])
    lat, e, i = c["kv_lora_rank"], c["n_routed_experts"], c["moe_intermediate_size"]

    def add(name, shape, kind="compute", init="normal"):
        s.append((f"{PREFIX}.{name}", tuple(shape), kind, init))

    add("proj_norm.weight", (d_vf,), "f32", "one")
    add("proj_norm.bias", (d_vf,), "f32", "zero")
    add("proj_fc1", (h, d_vf))
    add("proj_fc1_bias", (h,), init="zero")
    add("proj_fc2", (h, h))
    add("proj_fc2_bias", (h,), init="zero")
    add("embed_tokens", (c["vocab_size"], h))
    for n in range(c["num_hidden_layers"]):
        p = f"layers.{n}"
        add(f"{p}.input_layernorm.weight", (h,), "f32", "one")
        add(f"{p}.post_attention_layernorm.weight", (h,), "f32", "one")
        add(f"{p}.self_attn.q_proj", (heads * (nope + r), h))
        add(f"{p}.self_attn.kv_a_proj_with_mqa", (lat + r, h))
        add(f"{p}.self_attn.kv_a_layernorm.weight", (lat,), "f32", "one")
        add(f"{p}.self_attn.kv_b_proj", (heads * (nope + vd), lat))
        add(f"{p}.self_attn.o_proj", (h, heads * vd))
        if n < c["first_k_dense_replace"]:
            add(f"{p}.mlp.gate_up_proj", (2 * c["intermediate_size"], h))
            add(f"{p}.mlp.down_proj", (h, c["intermediate_size"]))
        else:
            add(f"{p}.mlp.gate", (e, h), "f32")
            add(f"{p}.mlp.e_score_correction_bias", (e,), "f32", "zero")
            add(f"{p}.mlp.experts_gate_up", (e, 2 * i, h))
            add(f"{p}.mlp.experts_down", (e, h, i), init=EXPERT_DOWN_INIT)
            add(f"{p}.mlp.shared_experts.gate_up_proj", (2 * i * c["n_shared_experts"], h))
            add(f"{p}.mlp.shared_experts.down_proj", (h, i * c["n_shared_experts"]))
    add("norm.weight", (h,), "f32", "one")
    add("lm_head", (c["vocab_size"], h))
    return s


def make_weights(cfg: Dict, seed: int, device, compute_dtype) -> Dict[str, torch.Tensor]:
    """name -> tensor for every entry of ``param_spec``, drawn on ``device``
    from one generator seeded with ``seed``, each tensor an allocation of its
    own (so every one is aligned as a fresh tensor is). The same seed on the
    same device gives the same values."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dts = {"compute": compute_dtype, "f32": torch.float32}
    out: Dict[str, torch.Tensor] = {}
    for name, shape, kind, init in param_spec(cfg):
        if init.startswith("normal"):
            fan = shape[-1] if len(shape) == 3 else math.prod(shape[1:])
            scale = float(init.partition(":")[2] or 1.0)
            w = torch.randn(shape, generator=gen, device=device, dtype=dts[kind])
            out[name] = w.mul_(scale / math.sqrt(fan))
        else:
            fill = {"one": 1.0, "zero": 0.0}[init] if init in ("one", "zero") else float(
                init.partition(":")[2])
            out[name] = torch.full(shape, fill, dtype=dts[kind], device=device)
    return out


# ---- the language model ----

def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rotate_half(x):
    x1, x2 = x.chunk(2, -1)
    return torch.cat([-x2, x1], -1)


def rope(x, positions, theta, dim):
    """DeepSeek's ``apply_rotary_pos_emb`` on x [..., T, dim]: the interleave
    permutation, then the rotate-half form, in float32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim))
    freqs = torch.outer(positions.float(), inv)
    emb = torch.cat([freqs, freqs], -1)
    *lead, t, d = x.shape
    x = x.reshape(*lead, t, d // 2, 2).transpose(-1, -2).reshape(*lead, t, d)
    return x * emb.cos() + rotate_half(x) * emb.sin()


class LM:
    """The projector and the language model over ``P`` (name -> tensor, the
    matrices in bfloat16) and the language model's keys ``c``; ``q``
    quantizes operands."""

    def __init__(self, P: Dict[str, torch.Tensor], c: Dict, q: Callable = identity):
        self.P, self.c, self.q = P, c, q
        self._packed: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def w(self, name: str, expert=None) -> torch.Tensor:
        """A weight in float32 (one expert's of a stacked expert tensor), its
        operand quantization applied to a matrix: the control's float8 copy
        is made once per matrix (per expert) and kept."""
        t = self.P[f"{PREFIX}.{name}"]
        t = t if expert is None else t[expert]
        if self.q is identity or t.dim() < 2:
            return t.float()
        key = f"{name}/{expert}"
        if key not in self._packed:
            amax = t.abs().amax().float().clamp_min(1e-12)
            scale = 448.0 / amax
            self._packed[key] = ((t.float() * scale).to(torch.float8_e4m3fn), scale)
        w8, scale = self._packed[key]
        return w8.float() / scale

    def mm(self, x, name, expert=None):
        return self.q(x) @ self.w(name, expert).t()

    def project(self, att_feats):
        """EVOKE's patch tokens [..., P, d_vf] -> [..., P, H]."""
        x = F.layer_norm(att_feats.float(), att_feats.shape[-1:], self.w("proj_norm.weight"),
                         self.w("proj_norm.bias"), 1e-5)
        x = F.gelu(self.mm(x, "proj_fc1") + self.w("proj_fc1_bias"))
        return self.mm(x, "proj_fc2") + self.w("proj_fc2_bias")

    def embed(self, ids):
        if self.q is identity:
            return self.P[f"{PREFIX}.embed_tokens"][ids].float()
        return self.w("embed_tokens")[ids]

    def attention(self, p, x):
        """Causal MLA over x [B, T, H]."""
        c = self.c
        b, t, _ = x.shape
        h, nope, r, vd = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                          c["v_head_dim"])
        pos = torch.arange(t, device=x.device)
        q = self.mm(x, f"{p}.q_proj").view(b, t, h, nope + r).transpose(1, 2)
        q_nope, q_pe = q.split([nope, r], -1)
        lat, k_pe = self.mm(x, f"{p}.kv_a_proj_with_mqa").split([c["kv_lora_rank"], r], -1)
        lat = rms(lat, self.w(f"{p}.kv_a_layernorm.weight"), c["rms_norm_eps"])
        kv = self.mm(lat, f"{p}.kv_b_proj").view(b, t, h, nope + vd).transpose(1, 2)
        k_nope, v = kv.split([nope, vd], -1)
        q_pe = rope(q_pe, pos, c["rope_theta"], r)
        k_pe = rope(k_pe[:, None], pos, c["rope_theta"], r).expand(-1, h, -1, -1)
        qq, kk = torch.cat([q_nope, q_pe], -1), torch.cat([k_nope, k_pe], -1)
        s = self.q(qq) @ self.q(kk).transpose(-1, -2) / math.sqrt(nope + r)
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool, device=x.device).tril(), NEG)
        ctx = (self.q(torch.softmax(s, -1)) @ self.q(v)).transpose(1, 2).reshape(b, t, h * vd)
        return self.mm(ctx, f"{p}.o_proj")

    def swiglu(self, x, up, down, expert=None):
        g, u = self.mm(x, up, expert).chunk(2, -1)
        return self.mm(F.silu(g) * u, down, expert)

    def moe(self, p, x):
        """x [T, H] -> [T, H]: each token through its chosen experts, an expert
        at a time over the tokens that chose it, plus the shared experts."""
        c = self.c
        scores = torch.sigmoid(self.mm(x, f"{p}.gate"))
        choice = scores + self.w(f"{p}.e_score_correction_bias")
        idx = torch.topk(choice, c["num_experts_per_tok"], -1).indices
        w = scores.gather(1, idx)
        if c["norm_topk_prob"]:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        w = w * c["routed_scaling_factor"]
        out = self.swiglu(x, f"{p}.shared_experts.gate_up_proj", f"{p}.shared_experts.down_proj")
        for e in torch.unique(idx).tolist():
            tok, slot = (idx == e).nonzero(as_tuple=True)
            y = self.swiglu(x[tok], f"{p}.experts_gate_up", f"{p}.experts_down", e)
            out = out.index_add(0, tok, y * w[tok, slot][:, None])
        return out

    def forward(self, x):
        """x [B, T, H] float32 (prefix rows, then token rows) -> logits [B, T, V]."""
        c = self.c
        b, t, h = x.shape
        eps = c["rms_norm_eps"]
        for n in range(c["num_hidden_layers"]):
            p = f"layers.{n}"
            h_in = rms(x, self.w(f"{p}.input_layernorm.weight"), eps)
            x = x + self.attention(f"{p}.self_attn", h_in)
            y = rms(x, self.w(f"{p}.post_attention_layernorm.weight"), eps).reshape(b * t, h)
            if n < c["first_k_dense_replace"]:
                y = self.swiglu(y, f"{p}.mlp.gate_up_proj", f"{p}.mlp.down_proj")
            else:
                y = self.moe(f"{p}.mlp", y)
            x = x + y.view(b, t, h)
        return self.mm(rms(x, self.w("norm.weight"), eps), "lm_head")

    def report_logits(self, prefix, toks, bos: int):
        """Teacher-forced logits [len(toks), V] of a report over one study's
        projected prefix [P, H] (or [1, P, H]): row t scores token t."""
        prefix = prefix.reshape(-1, prefix.shape[-1])
        ids = torch.as_tensor(np.concatenate([[bos], np.asarray(toks)[:-1]]),
                              device=prefix.device).long()
        x = torch.cat([prefix, self.embed(ids)], 0)[None]
        return self.forward(x)[0, prefix.shape[0]:]

    def beam_decode(self, prefix, n: int, beam: int, bos: int, banned: List[int]) -> np.ndarray:
        """``refmodel.beam_decode``'s search over this model: ``n`` tokens of one
        study over its projected prefix [P, H], each step recomputed from the
        start. -> the served tokens [n]."""
        prefix = prefix.reshape(-1, prefix.shape[-1])
        dev = prefix.device
        ids = torch.full((beam, 1), bos, dtype=torch.long, device=dev)
        scores = torch.zeros(beam, device=dev)
        for t in range(n):
            x = torch.cat([prefix[None].expand(beam, -1, -1), self.embed(ids)], 1)
            lg = self.forward(x)[:, -1]
            lse = torch.logsumexp(lg, -1)
            lg[:, banned] = -float("inf")
            vals, tok = lg.topk(beam, -1)
            cand = scores[:, None] + vals - lse[:, None]
            if t == 0:
                cand[1:] = -float("inf")
            scores, flat = cand.reshape(-1).topk(beam)
            ids = torch.cat([ids[flat // beam], tok.reshape(-1)[flat][:, None]], 1)
        return ids[int(scores.argmax()), 1:].cpu().numpy()


class StudyRef:
    """The whole model: EVOKE's encoder (``refmodel.Ref``, float32 weights)
    and the language model (``LM``)."""

    def __init__(self, P: Dict[str, torch.Tensor], cfg: Dict, q: Callable = identity):
        enc = {k: v.float() for k, v in P.items() if not k.startswith(PREFIX + ".")}
        self.encoder = refmodel.Ref(enc, cfg["model"], q)
        self.lm = LM(P, lm_config(cfg), q)

    def prefix(self, batch: Dict[str, torch.Tensor], with_indication: bool) -> torch.Tensor:
        """One study's projected prefix [P, H]: ``batch`` holds its anchor
        (first) and its views."""
        inc = (batch["inc_ids"], batch["inc_mask"]) if with_indication else (None, None)
        hidden = self.encoder.encode(batch["images"], batch["pids"], batch["valid"], 1, *inc)
        return self.lm.project(hidden[0, 1:])


def reference_gaps(cfg: Dict, seed: int, device, gen, picked, with_indication: bool,
                   control: bool = False) -> Dict[str, Dict]:
    """``pb/serving.reference_gaps`` over this reference: the widest gap by
    which a served token's reference logit lies below the reference's k-th
    best at its position, EOS out of contention before a forced end, the
    forced EOS not compared, UNK out when suppressed; with ``control`` the
    same for the float8 control serving each study by its own beam search."""
    from pb.weights import DTYPES

    dec = cfg["decode"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P = make_weights(cfg, seed, device, DTYPES[cfg["dtype"]])
    ref = StudyRef(P, cfg)
    ctl = StudyRef(P, cfg, fp8_quantizer) if control else None
    tok = SpelledIds(cfg["model"]["vocab_size"])
    k = int(dec["beam_size"])
    out = {"program": {"served_gap": 0.0, "tokens_compared": 0}}
    if control:
        out["control"] = {"served_gap": 0.0, "tokens_compared": 0}
    with torch.no_grad():
        for s in picked:
            inputs = {name: torch.as_tensor(v).to(device) for name, v in
                      gen.study_inputs(s.pool, [s.row]).items()}
            n = len(s.tokens) - (1 if s.target is not None else 0)
            if n <= 0:
                continue
            banned = (([tok.unk_id] if dec.get("suppress_unk") else [])
                      + ([tok.eos_id] if s.target is not None else []))
            served = {"program": np.asarray(s.tokens[:n])}
            if ctl is not None:
                served["control"] = ctl.lm.beam_decode(ctl.prefix(inputs, with_indication), n,
                                                       k, tok.bos_id, banned)
            prefix = ref.prefix(inputs, with_indication)
            for side, toks in served.items():
                masked = ref.lm.report_logits(prefix, toks, tok.bos_id)
                masked[:, banned] = -float("inf")
                kth = masked.topk(k, -1).values[:, -1]
                toks = torch.as_tensor(toks, device=masked.device).long()
                gap = (kth - masked.gather(1, toks[:, None])[:, 0]).clamp_min(0)
                out[side]["served_gap"] = max(out[side]["served_gap"], float(gap.max()))
                out[side]["tokens_compared"] += n
    del P, ref, ctl
    return out
