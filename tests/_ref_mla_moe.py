"""Plain float32 reference of the ``mla_moe`` report decoder, for the tests.

Written from the published description, not from the port: DeepSeek-V2's
multi-head latent attention (arXiv 2405.04434) in its non-absorbed form (each
head's keys and values materialised from the latent), DeepSeek-V3's routing
(arXiv 2412.19437: sigmoid scores, the top-k of score + correction bias, the
chosen scores normalised and scaled, shared experts added) and RoPE with
DeepSeek's interleave permutation (HF ``modeling_deepseek``'s
``apply_rotary_pos_emb``), as Kimi-VL's language model uses them
(arXiv 2504.07491). One sequence at a time, no cache, no batching, a loop
over tokens for the experts; it imports no kernel of the port.

Departures from Kimi-VL, both the port's:
- the projector is LayerNorm -> Linear -> GELU -> Linear over EVOKE's 49
  co-attended patch tokens, without Kimi-VL's 2 x 2 pixel shuffle (a 7 x 7
  grid does not divide);
- EVOKE's encoder (ResNet-101, multiview fusion, the indication's
  co-attention) stands in MoonViT's place: the reference starts from its
  patch tokens ``att_feats`` [P, d_vf].

Parameters are a dict of float32 tensors under the port's state-dict names
of ``text_decoder`` (``prefix``); ``c`` is the language model's keys
(``core/config.mla_moe_keys``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

NEG = -1e9


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rotate_half(x):
    x1, x2 = x.chunk(2, -1)
    return torch.cat([-x2, x1], -1)


def rope(x, positions, theta, dim):
    """HF DeepSeek's apply_rotary_pos_emb on x [..., T, dim]: the interleave
    permutation, then the rotate-half form."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freqs = torch.outer(positions.float(), inv)
    emb = torch.cat([freqs, freqs], -1)
    cos, sin = emb.cos(), emb.sin()
    *lead, t, d = x.shape
    x = x.reshape(*lead, t, d // 2, 2).transpose(-1, -2).reshape(*lead, t, d)
    return x * cos + rotate_half(x) * sin


def swiglu(x, gate_up, down):
    g, u = (x @ gate_up.t()).chunk(2, -1)
    return (F.silu(g) * u) @ down.t()


def route(P, pre, c, x):
    """Routing of one token's normalised hidden x [H] -> (ids [k], weights [k])."""
    scores = torch.sigmoid(x @ P[f"{pre}.gate"].t())
    choice = scores + P[f"{pre}.e_score_correction_bias"]
    idx = torch.topk(choice, c["num_experts_per_tok"]).indices
    w = scores[idx]
    if c["norm_topk_prob"]:
        w = w / (w.sum() + 1e-20)
    return idx, w * c["routed_scaling_factor"]


def moe(P, pre, c, x, record: Optional[List] = None):
    """x [T, H] -> [T, H]; ``record`` gets each token's expert ids."""
    out = []
    for t in range(x.shape[0]):
        idx, w = route(P, pre, c, x[t])
        if record is not None:
            record.append(idx.tolist())
        y = swiglu(x[t], P[f"{pre}.shared_experts.gate_up_proj"],
                   P[f"{pre}.shared_experts.down_proj"])
        for e, we in zip(idx.tolist(), w):
            y = y + we * swiglu(x[t], P[f"{pre}.experts_gate_up"][e], P[f"{pre}.experts_down"][e])
        out.append(y)
    return torch.stack(out)


def mla(P, pre, c, x):
    """Causal MLA over x [T, H], keys and values per head from the latent."""
    t = x.shape[0]
    h, nope, r, vd = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    pos = torch.arange(t)
    q = (x @ P[f"{pre}.q_proj"].t()).view(t, h, nope + r).transpose(0, 1)     # [h, T, .]
    q_nope, q_pe = q.split([nope, r], -1)
    kv_a = x @ P[f"{pre}.kv_a_proj_with_mqa"].t()
    lat, k_pe = kv_a.split([c["kv_lora_rank"], r], -1)
    lat = rms(lat, P[f"{pre}.kv_a_layernorm.weight"], c["rms_norm_eps"])
    kv = (lat @ P[f"{pre}.kv_b_proj"].t()).view(t, h, nope + vd).transpose(0, 1)
    k_nope, v = kv.split([nope, vd], -1)
    q_pe = rope(q_pe, pos, c["rope_theta"], r)
    k_pe = rope(k_pe[None], pos, c["rope_theta"], r).expand(h, -1, -1)
    qq, kk = torch.cat([q_nope, q_pe], -1), torch.cat([k_nope, k_pe], -1)
    s = qq @ kk.transpose(-1, -2) / math.sqrt(nope + r)
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), NEG)
    ctx = (torch.softmax(s, -1) @ v).transpose(0, 1).reshape(t, h * vd)
    return ctx @ P[f"{pre}.o_proj"].t()


def project(P, att_feats, prefix="text_decoder"):
    """The projector over EVOKE's patch tokens [P, d_vf] -> [P, H]."""
    x = F.layer_norm(att_feats, att_feats.shape[-1:], P[f"{prefix}.proj_norm.weight"],
                     P[f"{prefix}.proj_norm.bias"], 1e-5)
    x = F.gelu(x @ P[f"{prefix}.proj_fc1"].t() + P[f"{prefix}.proj_fc1_bias"])
    return x @ P[f"{prefix}.proj_fc2"].t() + P[f"{prefix}.proj_fc2_bias"]


def logits(P: Dict[str, torch.Tensor], c: Dict, att_feats, ids, prefix="text_decoder",
           routing: Optional[Dict[int, List]] = None):
    """The teacher-forced forward over [projected patch tokens; embedded ids]
    -> logits [len(ids), V] of the token after each of ``ids``. ``routing``:
    layer -> every position's expert ids."""
    x = torch.cat([project(P, att_feats, prefix), P[f"{prefix}.embed_tokens"][ids]], 0)
    eps = c["rms_norm_eps"]
    for i in range(c["num_hidden_layers"]):
        pre = f"{prefix}.layers.{i}"
        x = x + mla(P, f"{pre}.self_attn", c, rms(x, P[f"{pre}.input_layernorm.weight"], eps))
        h = rms(x, P[f"{pre}.post_attention_layernorm.weight"], eps)
        if i < c["first_k_dense_replace"]:
            x = x + swiglu(h, P[f"{pre}.mlp.gate_up_proj"], P[f"{pre}.mlp.down_proj"])
        else:
            rec = routing.setdefault(i, []) if routing is not None else None
            x = x + moe(P, f"{pre}.mlp", c, h, rec)
    out = rms(x, P[f"{prefix}.norm.weight"], eps) @ P[f"{prefix}.lm_head"].t()
    return out[att_feats.shape[0]:]


def beam_search(P, c, att_feats, beam: int, max_len: int, bos: int, eos: int, pad: int,
                suppress=()) -> List[int]:
    """The serving loops' beam search (``decode/beam.BeamLoop`` with the fused
    tail, no length penalty, early stop) over full recomputation: each step
    every live beam's ``beam`` best next tokens by log-probability (``suppress``
    ids down by 1000 after the log-sum-exp), the ``beam`` best running sums
    survive (at the first step only beam 0's), a beam that emits EOS or reaches
    ``max_len`` is recorded and knocked down by 1000, and once every beam's
    lineage has finished nothing changes. -> the best recorded sequence,
    PAD after its first EOS."""
    seqs = [[] for _ in range(beam)]
    alive = torch.zeros(beam)
    done_score, done_seq = [NEG] * beam, [[pad] * max_len for _ in range(beam)]
    ever = [False] * beam
    for t in range(max_len):
        if all(ever):
            break
        cand = []
        for b in range(beam):
            lg = logits(P, c, att_feats, torch.tensor([bos] + seqs[b], dtype=torch.long))[-1]
            lse = torch.logsumexp(lg, -1)
            lg = lg.clone()
            for s in suppress:
                lg[s] -= 1000.0
            cand.append(alive[b] + lg - lse)
        cand = torch.stack(cand)
        if t == 0:
            cand[1:] = NEG
        flat = cand.reshape(-1)
        order = torch.sort(flat, descending=True, stable=True).indices[:beam]
        v = cand.shape[1]
        scores = flat[order]
        src, tok = (order // v).tolist(), (order % v).tolist()
        seqs = [seqs[s] + [w] for s, w in zip(src, tok)]
        fin = [w == eos or t == max_len - 1 for w in tok]
        pool = [(done_score[i], done_seq[i]) for i in range(beam)]
        pool += [(float(scores[i]) if fin[i] else NEG,
                  seqs[i] + [pad] * (max_len - t - 1)) for i in range(beam)]
        keep = sorted(range(len(pool)), key=lambda i: -pool[i][0])[:beam]
        done_score, done_seq = [pool[i][0] for i in keep], [pool[i][1] for i in keep]
        alive = scores - 1000.0 * torch.tensor(fin, dtype=torch.float32)
        ever = [ever[s] or f for s, f in zip(src, fin)]
    best = done_seq[0]
    if eos in best:
        cut = best.index(eos)
        best = best[:cut + 1] + [pad] * (max_len - cut - 1)
    return best
