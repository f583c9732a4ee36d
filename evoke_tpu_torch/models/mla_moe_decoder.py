"""A DeepSeek-V2 / V3 style language model as the report decoder
(``decoder_kind="mla_moe"``; no counterpart in the JAX package).

The language model of a vision-language report generator (Kimi-VL-A3B's at
its published sizes, ``core/config.MLA_MOE_KEYS``) behind EVOKE's encoder:

- ``encode`` is the MLP projector over the co-attended patch tokens:
  LayerNorm -> Dense -> exact GELU -> Dense, d_vf -> hidden -> hidden (Kimi-VL's
  projector without its pixel shuffle, which a 7 x 7 grid does not divide).
- The projected patch tokens are the prefix, positions 0 .. P-1;
  ``init_decode_state`` runs their causal prefill and keeps each layer's
  latents beam-invariant (one row a sample). Decode step t is position P + t
  and starts from BOS.
- Each layer: RMSNorm -> multi-head latent attention (MLA, DeepSeek-V2) ->
  RMSNorm -> SwiGLU MLP (the first ``first_k_dense_replace`` layers) or a
  DeepSeekMoE layer, each with a float32 residual stream.
- MLA without query compression: q = x W_q (per head ``qk_nope`` + ``qk_rope``
  wide); the compressed latent c = RMSNorm(x W_kv_a[:C]) and one shared rope
  key k_pe = RoPE(x W_kv_a[C:]); per-head keys and values come from
  c W_kv_b. Scores are scaled by 1 / sqrt(qk_nope + qk_rope). RoPE rotates
  the pairs (2i, 2i + 1) (DeepSeek's interleave permutation, stored permuted:
  the first half of a rope vector holds the even elements).
- Routing (DeepSeek-V3 ``noaux_tc`` with one group): float32 router logits
  of the float32 normalised residual, sigmoid scores, the top-k of score +
  ``e_score_correction_bias``, the chosen scores normalised to sum 1
  (``norm_topk_prob``) and times ``routed_scaling_factor``; the shared experts
  (one SwiGLU of ``n_shared_experts`` x the expert width) are added.

The decode step keeps MLA's latent form: each layer's cache holds the
normalised latent c [N, L, C] in ``cache_k`` and the rotated k_pe [N, L, R] in
``cache_v``, never per-head keys or values; the prefix's are the state's
``cross_k`` / ``cross_v`` [B, P, C] / [B, P, R]. The query absorbs W_UK
(q_nope W_UK against c, plus q_pe against k_pe) and the context is read in
the latent, then W_UV per head and ``o_proj``. A sample's beam rows attend
every physical row of the sample under a mask: their lineage through ``anc``
in ancestor mode (``ops/lineage_attention.lineage_masks``), their own row in
reorder mode. The routed experts run as two grouped GEMMs over the rows sorted
by expert (``torch._grouped_mm``, offsets on the device): every token gets
exactly its top-k experts, with no capacity and no host sync, so the step can
be captured in a CUDA graph. The head is untied and, with ``return_topk``, the
fused logit + top-k tail (K2) over a zero bias.

``expert_ledger`` counts, per kind of call (0 prefill, 1 decode step) and per
MoE layer, the rows routed to each expert and the experts a call touched,
summed over calls (replays included: the sums run on the device inside the
step).
``reset_expert_ledger`` zeroes it in place; ``read_expert_ledger`` copies it
to the host.

Int8 caches, the continuous engine and tensor parallelism are not
implemented for this decoder and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from evoke_tpu_torch.core.config import mla_moe_keys
from evoke_tpu_torch.core.profiling import span
from evoke_tpu_torch.models.layers import LayerNorm
from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
from evoke_tpu_torch.ops.lineage_attention import lineage_masks

NEG_INF = -1e9


def _weight(out_f: int, in_f: int, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(out_f, in_f, dtype=dtype))


def rms_norm(x, weight, eps: float, dtype):
    """RMSNorm in float32 (x * rsqrt(mean(x^2) + eps) * weight), out in ``dtype``."""
    x = x.float()
    return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight.float()).to(dtype)


class RMSNorm(nn.Module):
    """A float32 scale ``weight`` [n] applied by ``rms_norm``."""

    def __init__(self, n: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(n))

    def forward(self, x, dtype):
        return rms_norm(x, self.weight, self.eps, dtype)


def rope_table(theta: float, dim: int, positions: int, device) -> torch.Tensor:
    """[positions, 2, dim / 2] float32: cos and sin of position x theta^(-2i / dim)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    ang = torch.arange(positions, dtype=torch.float32, device=device)[:, None] * inv[None]
    return torch.stack([ang.cos(), ang.sin()], 1)


def apply_rope(x, cs):
    """Rotate the pairs (2i, 2i + 1) of ``x`` [..., T, R] by ``cs`` [T, 2, R / 2]
    in float32; out in the permuted layout (even elements, then odd), x's dtype."""
    xf = x.float().unflatten(-1, (-1, 2))
    a, b = xf[..., 0], xf[..., 1]
    cos, sin = cs[:, 0], cs[:, 1]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1).to(x.dtype)


def grouped_mm(rows, w, offs):
    """rows [R, K] sorted by expert, w [E, N, K], offs [E] int32 (each expert's
    end row) -> [R, N]: rows of expert e times w[e].T."""
    return torch._grouped_mm(rows, w.transpose(1, 2), offs=offs)


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)), gate and up as one [2I, H] weight."""

    def __init__(self, hidden: int, inter: int, dtype):
        super().__init__()
        self.gate_up_proj = _weight(2 * inter, hidden, dtype)
        self.down_proj = _weight(hidden, inter, dtype)

    def forward(self, x):
        g, u = F.linear(x, self.gate_up_proj).chunk(2, -1)
        return F.linear(F.silu(g) * u, self.down_proj)


class MoE(nn.Module):
    """DeepSeekMoE: routed SwiGLU experts ([E, 2I, H] and [E, H, I]), a float32
    router with its correction bias, and the shared experts."""

    def __init__(self, c: Dict[str, Any], dtype):
        super().__init__()
        h, i, e = c["hidden_size"], c["moe_intermediate_size"], c["n_routed_experts"]
        self.top_k, self.scale = c["num_experts_per_tok"], float(c["routed_scaling_factor"])
        self.norm_topk = bool(c["norm_topk_prob"])
        self.gate = _weight(e, h, torch.float32)
        self.register_buffer("e_score_correction_bias", torch.zeros(e))
        self.experts_gate_up = nn.Parameter(torch.empty(e, 2 * i, h, dtype=dtype))
        self.experts_down = nn.Parameter(torch.empty(e, h, i, dtype=dtype))
        self.shared_experts = SwiGLU(h, i * c["n_shared_experts"], dtype)

    def route(self, x32):
        """x32 [T, H] float32 -> (expert ids [T, k], weights [T, k] float32)."""
        scores = F.linear(x32, self.gate.float()).sigmoid()
        idx = torch.topk(scores + self.e_score_correction_bias.float(), self.top_k, -1).indices
        w = scores.gather(1, idx)
        if self.norm_topk:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * self.scale

    def forward(self, x, x32, counts_out=None):
        """x [T, H] (compute dtype), x32 the same rows in float32 (the router's
        input) -> [T, H] float32. ``counts_out`` [E] int64 receives the rows
        routed to each expert."""
        t, k = x.shape[0], self.top_k
        idx, w = self.route(x32)
        flat = idx.reshape(-1)
        order = torch.sort(flat, stable=True).indices
        counts = torch.zeros(self.gate.shape[0], dtype=torch.int64, device=x.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat))
        if counts_out is not None:
            counts_out.copy_(counts)
        offs = counts.cumsum(0).to(torch.int32)
        rows = x.index_select(0, order // k)
        g, u = grouped_mm(rows, self.experts_gate_up, offs).chunk(2, -1)
        y = grouped_mm(F.silu(g) * u, self.experts_down, offs)
        y = torch.empty_like(y).index_copy_(0, order, y)            # back to (token, choice)
        out = (y.view(t, k, -1).float() * w[..., None]).sum(1)
        return out + self.shared_experts(x).float()


class MLA(nn.Module):
    """Multi-head latent attention without query compression."""

    def __init__(self, c: Dict[str, Any], dtype):
        super().__init__()
        h, d = c["num_attention_heads"], c["hidden_size"]
        self.heads, self.nope, self.rope = h, c["qk_nope_head_dim"], c["qk_rope_head_dim"]
        self.vdim, self.latent = c["v_head_dim"], c["kv_lora_rank"]
        self.scale = 1.0 / math.sqrt(self.nope + self.rope)
        self.q_proj = _weight(h * (self.nope + self.rope), d, dtype)
        self.kv_a_proj_with_mqa = _weight(self.latent + self.rope, d, dtype)
        self.kv_a_layernorm = RMSNorm(self.latent, c["rms_norm_eps"])
        self.kv_b_proj = _weight(h * (self.nope + self.vdim), self.latent, dtype)
        self.o_proj = _weight(d, h * self.vdim, dtype)

    def project(self, x, cs):
        """x [..., T, H] -> (q_nope [..., T, h, nope], q_pe [..., T, h, R] rotated,
        latent c [..., T, C] normalised, k_pe [..., T, R] rotated)."""
        q = F.linear(x, self.q_proj).unflatten(-1, (self.heads, -1))
        q_nope, q_pe = q.split([self.nope, self.rope], -1)
        kv = F.linear(x, self.kv_a_proj_with_mqa)
        c, k_pe = kv.split([self.latent, self.rope], -1)
        c = self.kv_a_layernorm(c, x.dtype)
        q_pe = apply_rope(q_pe.transpose(-2, -3), cs).transpose(-2, -3)
        return q_nope, q_pe, c, apply_rope(k_pe, cs)

    def prefill(self, x, cs):
        """Causal attention over x [B, P, H] (per-head keys and values from the
        latent) -> (out [B, P, H], c [B, P, C], k_pe [B, P, R])."""
        b, p, _ = x.shape
        q_nope, q_pe, c, k_pe = self.project(x, cs)
        kv = F.linear(c, self.kv_b_proj).unflatten(-1, (self.heads, -1))
        k_nope, v = kv.split([self.nope, self.vdim], -1)
        q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)                     # [B, h, P, dq]
        k = torch.cat([k_nope, k_pe[:, :, None].expand(-1, -1, self.heads, -1)],
                      -1).transpose(1, 2)
        s = torch.matmul(q, k.transpose(-1, -2)).float() * self.scale
        causal = torch.ones(p, p, dtype=torch.bool, device=x.device).tril()
        prob = torch.softmax(s.masked_fill(~causal, float("-inf")), -1).to(x.dtype)
        ctx = torch.matmul(prob, v.transpose(1, 2)).transpose(1, 2).reshape(b, p, -1)
        return F.linear(ctx, self.o_proj), c, k_pe

    def decode(self, x, cs, cache_c, cache_r, pre_c, pre_r, mask, pos: int):
        """One step, absorbed: x [N, H]; writes slot ``pos`` of the caches
        [N, L, C] / [N, L, R] in place; the rows of sample s (its ``k`` beam
        rows) attend the prefix pre_c / pre_r [B, P, .] and every slot of the
        sample's k physical rows where ``mask`` [B, k, k * L] allows."""
        n = x.shape[0]
        b, p, _ = pre_c.shape
        kb, lmax = n // b, cache_c.shape[1]
        q_nope, q_pe, c, k_pe = self.project(x[:, None], cs)
        cache_c[:, pos] = c[:, 0]
        cache_r[:, pos] = k_pe[:, 0]
        w = self.kv_b_proj.view(self.heads, self.nope + self.vdim, self.latent)
        w_uk, w_uv = w[:, :self.nope], w[:, self.nope:]                        # [h, ., C]
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w_uk).transpose(0, 1)  # [N, h, C]
        qc = q_lat.reshape(b, kb * self.heads, self.latent)
        qr = q_pe[:, 0].reshape(b, kb * self.heads, self.rope)
        kc = cache_c.view(b, kb * lmax, self.latent)
        kr = cache_r.view(b, kb * lmax, self.rope)
        s_pre = (torch.bmm(qc, pre_c.transpose(1, 2)).float()
                 + torch.bmm(qr, pre_r.transpose(1, 2)).float())
        s_own = (torch.bmm(qc, kc.transpose(1, 2)).float()
                 + torch.bmm(qr, kr.transpose(1, 2)).float())
        s_own = s_own.view(b, kb, self.heads, kb * lmax).masked_fill(
            ~mask[:, :, None, :], NEG_INF).view(b, kb * self.heads, kb * lmax)
        prob = torch.softmax(torch.cat([s_pre, s_own], -1) * self.scale, -1).to(x.dtype)
        ctx = torch.bmm(prob[..., :p], pre_c) + torch.bmm(prob[..., p:], kc)   # [B, k h, C]
        ctx = ctx.view(n, self.heads, self.latent).transpose(0, 1)
        out = torch.bmm(ctx, w_uv.transpose(1, 2)).transpose(0, 1).reshape(n, -1)
        return F.linear(out, self.o_proj)


class Layer(nn.Module):
    def __init__(self, c: Dict[str, Any], moe: bool, dtype):
        super().__init__()
        h = c["hidden_size"]
        self.input_layernorm = RMSNorm(h, c["rms_norm_eps"])
        self.post_attention_layernorm = RMSNorm(h, c["rms_norm_eps"])
        self.self_attn = MLA(c, dtype)
        self.mlp = MoE(c, dtype) if moe else SwiGLU(h, c["intermediate_size"], dtype)

    def ffn(self, x32, dtype, counts_out=None):
        """The MLP half on the float32 residual rows x32 [T, H] -> [T, H]
        float32; the router reads the normalised rows in float32."""
        h32 = self.post_attention_layernorm(x32, torch.float32)
        if isinstance(self.mlp, MoE):
            return self.mlp(h32.to(dtype), h32, counts_out)
        return self.mlp(h32.to(dtype)).float()


class MLAMoEDecoder(nn.Module):
    """RMDecoder's surface over an MLA + DeepSeekMoE language model.

    ``vocab_size`` is the port's word count: the head has ``vocab_size + 1``
    rows, which must equal the language model's ``vocab_size`` key."""

    def __init__(self, vocab_size: int, d_vf: int = 2048, max_seq_len: int = 100,
                 dtype=torch.float32, lm: Optional[Dict[str, Any]] = None):
        super().__init__()
        c = self.cfg = mla_moe_keys(lm or {})
        if c["vocab_size"] != vocab_size + 1:
            raise ValueError(f"mla_moe: the head has vocab_size + 1 = {vocab_size + 1} rows; "
                             f"the language model's vocab_size is {c['vocab_size']}")
        h = self.d_model = c["hidden_size"]
        self.num_layers, self.max_seq_len, self.dtype = c["num_hidden_layers"], max_seq_len, dtype
        self.proj_norm = LayerNorm(d_vf, eps=1e-5, dtype=dtype)
        self.proj_fc1 = _weight(h, d_vf, dtype)
        self.proj_fc1_bias = nn.Parameter(torch.empty(h, dtype=dtype))
        self.proj_fc2 = _weight(h, h, dtype)
        self.proj_fc2_bias = nn.Parameter(torch.empty(h, dtype=dtype))
        self.embed_tokens = nn.Parameter(torch.empty(c["vocab_size"], h, dtype=dtype))
        self.layers = nn.ModuleList(
            Layer(c, i >= c["first_k_dense_replace"], dtype) for i in range(self.num_layers))
        self.moe_layers = [i for i in range(self.num_layers) if i >= c["first_k_dense_replace"]]
        self.norm = RMSNorm(h, c["rms_norm_eps"])
        self.lm_head = _weight(c["vocab_size"], h, dtype)
        # device-side work tables, made at the first init_decode_state on a device
        # and never moved afterwards (captured steps hold their addresses)
        self._rope: Optional[torch.Tensor] = None
        self._head_bias: Optional[torch.Tensor] = None
        self.expert_ledger: Optional[Dict[str, torch.Tensor]] = None

    # ---- device tables ----

    def _tables(self, device) -> None:
        if self._rope is None or self._rope.device != device:
            c = self.cfg
            self._rope = rope_table(float(c["rope_theta"]), c["qk_rope_head_dim"],
                                    c["max_position_embeddings"], device)
            self._head_bias = torch.zeros(c["vocab_size"], dtype=self.dtype, device=device)
            e, m = c["n_routed_experts"], len(self.moe_layers)
            self.expert_ledger = {
                "rows": torch.zeros(2, m, e, dtype=torch.int64, device=device),
                "touched": torch.zeros(2, m, dtype=torch.int64, device=device),
                "calls": torch.zeros(2, dtype=torch.int64, device=device)}

    @torch.inference_mode()
    def reset_expert_ledger(self) -> None:
        if self.expert_ledger is not None:
            for t in self.expert_ledger.values():
                t.zero_()

    def read_expert_ledger(self) -> Optional[Dict[str, np.ndarray]]:
        """{"rows": [2, MoE layers, E] rows routed to each expert, "touched":
        [2, MoE layers] experts touched by a call, summed over calls, "calls":
        [2] the calls}, the first index 0 for prefills and 1 for decode steps;
        None before any call."""
        if self.expert_ledger is None:
            return None
        return {k: v.cpu().numpy().copy() for k, v in self.expert_ledger.items()}

    def _count(self, counts: torch.Tensor, kind: int) -> None:
        """Add one call's per-layer counts [MoE layers, E] to the ledger's
        ``kind`` (0 prefill, 1 decode step)."""
        led = self.expert_ledger
        led["rows"][kind].add_(counts)
        led["touched"][kind].add_((counts > 0).sum(1))
        led["calls"][kind].add_(1)

    # ---- the model ----

    def encode(self, att_feats, att_mask=None, rng=None):
        """The projector over the patch tokens [B, P, d_vf] -> [B, P, H]."""
        x = self.proj_norm(att_feats)
        x = F.gelu(F.linear(x.to(self.dtype), self.proj_fc1, self.proj_fc1_bias))
        return F.linear(x, self.proj_fc2, self.proj_fc2_bias)

    def _causal(self, x32, counts=None, prefill: bool = False):
        """Every layer over x32 [B, T, H] (the float32 residual), causal, from
        position 0 -> (x32, each layer's (c, k_pe)). ``prefill``: stop after
        the last layer's attention (no later latent reads its output);
        ``counts`` [MoE layers, E] receives the routing counts."""
        b, t, h = x32.shape
        cs = self._rope[:t]
        lat = []
        j = 0
        for i, layer in enumerate(self.layers):
            hn = layer.input_layernorm(x32, self.dtype)
            out, c, k_pe = layer.self_attn.prefill(hn, cs)
            lat.append((c.contiguous(), k_pe.contiguous()))
            if prefill and i + 1 == self.num_layers:
                break
            x32 = x32 + out.float()
            moe = isinstance(layer.mlp, MoE)
            x32 = x32 + layer.ffn(x32.reshape(b * t, h), self.dtype,
                                  counts[j] if moe and counts is not None else None
                                  ).view(b, t, h)
            j += moe
        return x32, lat

    def forward(self, att_feats, att_mask, tgt_ids, tgt_mask, rng=None):
        return self.decode_train(self.encode(att_feats, att_mask), att_mask, tgt_ids, tgt_mask)

    def decode_train(self, enc, att_mask, tgt_ids, tgt_mask, rng=None):
        """Teacher-forced float32 log-probs [B, T, V] of the token after each
        of ``tgt_ids`` [B, T], over the prefix ``enc`` [B, P, H] (no dropout: the
        language model has none)."""
        p = enc.shape[1]
        self._tables(enc.device)
        x = torch.cat([enc.float(), F.embedding(tgt_ids.long(), self.embed_tokens).float()], 1)
        h = self.norm(self._causal(x)[0][:, p:], self.dtype)
        return torch.log_softmax(F.linear(h, self.lm_head), -1, dtype=torch.float32)

    def init_decode_state(self, enc, batch: int, max_len: Optional[int] = None,
                          kv_dtype: str = "") -> Dict[str, Any]:
        """The prefill of the prefix ``enc`` [B, P, H] (positions 0 .. P-1), and
        the decode state: per-layer latent caches [batch, L, C] (``cache_k``)
        and rope-key caches [batch, L, R] (``cache_v``), zero, and the prefix's
        beam-invariant latents ``cross_k`` [B, P, C] / ``cross_v`` [B, P, R]."""
        if kv_dtype:
            raise NotImplementedError(f"kv_dtype={kv_dtype!r}: the mla_moe decoder keeps its "
                                      "latent caches in the model dtype only")
        lmax = max_len or self.max_seq_len
        self._tables(enc.device)
        with span("generate.prefill"):
            counts = torch.zeros(len(self.moe_layers), self.cfg["n_routed_experts"],
                                 dtype=torch.int64, device=enc.device)
            lat = self._causal(enc.float(), counts, prefill=True)[1]
            self._count(counts, 0)

        def zeros(width):
            return tuple(torch.zeros(batch, lmax, width, dtype=self.dtype, device=enc.device)
                         for _ in range(self.num_layers))

        a = self.layers[0].self_attn
        return {"cache_k": zeros(a.latent), "cache_v": zeros(a.rope),
                "cross_k": tuple(c for c, _ in lat), "cross_v": tuple(r for _, r in lat)}

    def decode_step(self, tok, pos: int, state, att_mask=None, return_logits: bool = False,
                    return_topk: Optional[int] = None, topk_suppress=()):
        """tok [N], step ``pos`` (position P + pos) -> (log-probs [N, V], state),
        the caches written in place. ``return_logits``: raw logits instead;
        ``return_topk=k``: the fused logit + top-k tail's (vals [N, k] f32,
        idx [N, k] i32, lse [N] f32), ``topk_suppress`` ids knocked down by
        -1000 inside it."""
        pre_c = state["cross_k"]
        b, p = pre_c[0].shape[:2]
        n, lmax = tok.shape[0], state["cache_k"][0].shape[1]
        kb = n // b
        anc = state.get("anc")
        if anc is not None:
            mask = lineage_masks(anc, pos)[:, 0]                             # [B, k, k L]
        else:   # reorder mode: each row reads its own slots 0 .. pos
            own = torch.eye(kb, dtype=torch.bool, device=tok.device)
            mask = (own[:, :, None] & (torch.arange(lmax, device=tok.device) <= pos)
                    ).reshape(1, kb, kb * lmax).expand(b, -1, -1)
        cs = self._rope[p + pos:p + pos + 1]
        x32 = F.embedding(tok, self.embed_tokens).float()
        counts = torch.empty(len(self.moe_layers), self.cfg["n_routed_experts"],
                             dtype=torch.int64, device=tok.device)
        j = 0
        for i, layer in enumerate(self.layers):
            hn = layer.input_layernorm(x32, self.dtype)
            x32 = x32 + layer.self_attn.decode(
                hn, cs, state["cache_k"][i], state["cache_v"][i], pre_c[i],
                state["cross_v"][i], mask, pos).float()
            moe = isinstance(layer.mlp, MoE)
            x32 = x32 + layer.ffn(x32, self.dtype, counts[j] if moe else None)
            j += moe
        self._count(counts, 1)
        h = self.norm(x32, self.dtype)
        if return_topk:
            out = fused_logit_topk(h.contiguous(), self.lm_head, self._head_bias,
                                   int(return_topk), tuple(topk_suppress))
        else:
            logits = F.linear(h, self.lm_head)
            out = logits if return_logits else torch.log_softmax(logits.float(), dim=-1)
        return out, state
