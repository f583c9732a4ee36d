"""R2Gen-style report decoder (port of evoke_tpu/models/rm_decoder.py).

Relational memory + conditional LayerNorm, with KV-cached incremental decoding.
Dtypes follow the JAX package, which rounds at these places (bf16 compute):

- the token embedding is bf16 but the PE table is float32, so the decoder's
  residual stream is float32;
- ``RelationalMemory`` and its MHA carry no compute dtype and run float32;
- the CLN gamma/beta MLPs stay float32 on purpose (rm_decoder.py:101-110) and
  a CLN returns its input's dtype (float32 here);
- every other Dense rounds to bf16; caches are bf16; ``dec_norm`` returns bf16
  and so do the logits.

``decode_step`` computes the nine conditional norms' memory MLPs (3 layers x
cln1..3, a gamma and a beta MLP each, all on the same memory) as one stacked
float32 ``addmm`` and one ``baddbmm`` (``cln_scale_shift``) over a pack of
their weights, which ``init_decode_state`` brings up to date in place (the
captured steps keep its addresses). The pack is a cache: the state dict,
checkpoints and tp specs hold only the per-norm parameters. A decode step
keeps the per-norm MLPs where a norm's ``Dense`` is split over mp, and under
autograd (grad enabled), where the gradient must reach the parameters.

Unlike JAX, ``decode_step`` writes the new K/V into the caches IN PLACE (the
returned state holds the same cache tensors): a decode state is used once.
``init_decode_state(kv_dtype="int8")`` keeps the caches as int8 with a
float32 absmax scale per slot (``cache_k_scale`` / ``cache_v_scale`` [N, L]),
dequantized at the attention (``layers.quantized_cache_update``).

Under tensor parallelism (``parallel/tp.py``) the attention blocks hold the
rank's heads: the caches and cross K / V are ``D / mp`` wide, and a split
``logit`` is gathered before the log-softmax (at an odd vocab, 30001, it
stays whole). The fused logit + top-k tail reads the whole ``[V, D]``
weight and refuses a split one.

Training (``forward`` / ``decode_train``, teacher-forced over the whole
report): the relational memory rolls over the target embeddings one step at a
time (a Python loop where JAX scans) with its own attention dropout of 0.1;
``drop_prob_lm`` drops the embedded image tokens and ``dropout_rate`` acts in
every sublayer, as in the JAX module. Dropout draws from the generator
``rng``; ``rng=None`` is deterministic.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from evoke_tpu_torch.models.layers import (Dense, MultiHeadAttention, PositionwiseFFN,
                                           TokenEmbed, TorchLayerNorm,
                                           cached_self_attention, dropout, make_cross_mask,
                                           make_self_mask, quantized_cache_update)
from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk


class RelationalMemory(nn.Module):
    """Gated slot memory rolled over target embeddings (float32). Its
    attention carries dropout ``attn_dropout`` (the reference's MHA default,
    which no config field turns off)."""

    def __init__(self, num_slots: int, d_model: int, num_heads: int = 8,
                 attn_dropout: float = 0.1):
        super().__init__()
        self.num_slots, self.d_model = num_slots, d_model
        self.attn = MultiHeadAttention(num_heads, d_model, dtype=torch.float32,
                                       dropout_rate=attn_dropout)
        self.mlp1 = Dense(d_model, d_model)
        self.mlp2 = Dense(d_model, d_model)
        self.W = Dense(d_model, 2 * d_model)
        self.U = Dense(d_model, 2 * d_model)

    def init_memory(self, batch_size: int, device=None) -> torch.Tensor:
        """[B, S*D]: identity over slots, zero-padded to d_model."""
        s, d = self.num_slots, self.d_model
        eye = torch.eye(s, device=device)
        mem = (torch.cat([eye, torch.zeros(s, d - s, device=device)], dim=-1)
               if d > s else eye[:, :d])
        return mem.reshape(1, s * d).repeat(batch_size, 1)

    def step(self, x_t, memory, rng=None):
        """x_t [B, D], memory [B, S*D] -> next [B, S*D]."""
        b = x_t.shape[0]
        s, d = self.num_slots, self.d_model
        mem = memory.reshape(b, s, d)
        kv = torch.cat([mem, x_t[:, None, :]], dim=1)
        nxt = mem + self.attn(mem, kv, kv, rng=rng)
        nxt = nxt + F.relu(self.mlp2(F.relu(self.mlp1(nxt))))
        gates = self.W(x_t[:, None, :]) + self.U(torch.tanh(mem))
        input_gate, forget_gate = gates.split(d, dim=-1)
        nxt = torch.sigmoid(input_gate) * torch.tanh(nxt) + torch.sigmoid(forget_gate) * mem
        return nxt.reshape(b, s * d)

    def roll(self, xs, rng=None):
        """xs [B, T, D] -> the memory after each step [B, T, S*D]."""
        mem = self.init_memory(xs.shape[0], xs.device)
        outs = []
        for t in range(xs.shape[1]):
            mem = self.step(xs[:, t], mem, rng)
            outs.append(mem)
        return torch.stack(outs, dim=1)


class ConditionalLayerNorm(nn.Module):
    """LN whose scale/shift are offset by float32 MLPs of the memory."""

    def __init__(self, d_model: int, mem_dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(d_model))
        self.beta = nn.Parameter(torch.zeros(d_model))
        self.mlp_gamma_0 = Dense(mem_dim, d_model, torch.float32)
        self.mlp_gamma_1 = Dense(d_model, d_model, torch.float32)
        self.mlp_beta_0 = Dense(mem_dim, d_model, torch.float32)
        self.mlp_beta_1 = Dense(d_model, d_model, torch.float32)

    def forward(self, x, memory, scale_shift=None):
        """``scale_shift``: this norm's (gamma + dg, beta + db), computed
        ahead (``RMDecoder.cln_scale_shift``); else from ``memory``."""
        if scale_shift is None:
            m = memory.float()
            scale = self.gamma + self.mlp_gamma_1(F.relu(self.mlp_gamma_0(m)))
            shift = self.beta + self.mlp_beta_1(F.relu(self.mlp_beta_0(m)))
        else:
            scale, shift = scale_shift
        d = x.shape[-1]
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).sum(-1, keepdim=True) / max(d - 1, 1)
        y = (xf - mean) / (torch.sqrt(var) + self.eps)
        return (scale * y + shift).to(x.dtype)


class EncoderLayer(nn.Module):
    """Pre-LN self-attention + FFN."""

    def __init__(self, d_model: int, d_ff: int, num_heads: int, dtype=torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype, dropout_rate)
        self.ff = PositionwiseFFN(d_model, d_ff, dtype, dropout_rate)
        self.norm1 = TorchLayerNorm(d_model, dtype=dtype)
        self.norm2 = TorchLayerNorm(d_model, dtype=dtype)

    def forward(self, x, mask=None, rng=None):
        p = self.dropout_rate
        h = self.norm1(x)
        x = x + dropout(self.self_attn(h, h, h, mask=mask, rng=rng), p, rng)
        return x + dropout(self.ff(self.norm2(x), rng), p, rng)


class RMDecoderLayer(nn.Module):
    """Decoder layer with conditional-LN sublayers: the full-sequence form
    (``forward``, training) and the decode step."""

    def __init__(self, d_model: int, d_ff: int, num_heads: int, mem_dim: int,
                 dtype=torch.float32, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype, dropout_rate)
        self.src_attn = MultiHeadAttention(num_heads, d_model, dtype, dropout_rate)
        self.ff = PositionwiseFFN(d_model, d_ff, dtype, dropout_rate)
        self.cln1 = ConditionalLayerNorm(d_model, mem_dim)
        self.cln2 = ConditionalLayerNorm(d_model, mem_dim)
        self.cln3 = ConditionalLayerNorm(d_model, mem_dim)

    def forward(self, x, enc, self_mask, cross_mask, memory, rng=None):
        """x [B, T, D]; enc [B, P, D]; memory [B, T, S*D]."""
        p = self.dropout_rate
        h = self.cln1(x, memory)
        x = x + dropout(self.self_attn(h, h, h, mask=self_mask, rng=rng), p, rng)
        h = self.cln2(x, memory)
        x = x + dropout(self.src_attn(h, enc, enc, mask=cross_mask, rng=rng), p, rng)
        h = self.cln3(x, memory)
        return x + dropout(self.ff(h, rng), p, rng)

    def prepare_cross_kv(self, enc):
        return self.src_attn.project_kv(enc)

    def step(self, x, cross_k, cross_v, cross_mask, memory, cache_k, cache_v, pos: int,
             anc=None, age=None, kv_scales=None, cln=None):
        """x [N, 1, D]; memory [N, 1, S*D]; caches [N, L, D] written at ``pos``
        in place; anc optional [B, k, L]; age optional [N] ring ages;
        kv_scales (scale_k, scale_v) [N, L] when the caches are int8; cln
        optional: cln1..3's (scale, shift) [N, 1, D], computed ahead."""
        c1, c2, c3 = cln if cln is not None else (None, None, None)
        h = self.cln1(x, memory, c1)
        k_new, v_new = self.self_attn.project_kv(h)
        sk = sv = None
        if kv_scales is None:
            cache_k[:, pos] = k_new[:, 0].to(cache_k.dtype)
            cache_v[:, pos] = v_new[:, 0].to(cache_v.dtype)
        else:
            sk, sv = kv_scales
            quantized_cache_update(cache_k, sk, k_new, pos, self.self_attn.tp)
            quantized_cache_update(cache_v, sv, v_new, pos, self.self_attn.tp)
        x = x + cached_self_attention(self.self_attn, h, cache_k, cache_v, pos, anc, age=age,
                                      scale_k=sk, scale_v=sv)
        h = self.cln2(x, memory, c2)
        x = x + self.src_attn.attend(h, cross_k, cross_v, mask=cross_mask)
        h = self.cln3(x, memory, c3)
        return x + self.ff(h), cache_k, cache_v


class RMDecoder(nn.Module):
    """Image-token encoder + relational-memory decoder: the training forward
    (log-probs [B, T, V+1]) and the decode surface."""

    def __init__(self, vocab_size: int, d_model: int = 512, d_ff: int = 512,
                 d_vf: int = 2048, num_layers: int = 3, num_heads: int = 8,
                 dropout_rate: float = 0.0, drop_prob_lm: float = 0.5,
                 rm_num_slots: int = 3, rm_num_heads: int = 8, rm_d_model: int = 512,
                 max_seq_len: int = 100, dtype=torch.float32):
        super().__init__()
        if rm_d_model != d_model:
            raise ValueError("rm_d_model must equal d_model")
        self.vocab_size, self.d_model = vocab_size, d_model
        self.num_layers, self.max_seq_len, self.dtype = num_layers, max_seq_len, dtype
        self.drop_prob_lm = drop_prob_lm
        self.att_embed = Dense(d_vf, d_model, dtype)
        self.enc_layers, self.dec_layers = [], []
        for i in range(num_layers):
            enc = EncoderLayer(d_model, d_ff, num_heads, dtype, dropout_rate)
            self.add_module(f"enc_{i}", enc)
            self.enc_layers.append(enc)
        self.enc_norm = TorchLayerNorm(d_model, dtype=dtype)
        for i in range(num_layers):
            dec = RMDecoderLayer(d_model, d_ff, num_heads, rm_num_slots * rm_d_model, dtype,
                                 dropout_rate)
            self.add_module(f"dec_{i}", dec)
            self.dec_layers.append(dec)
        self.dec_norm = TorchLayerNorm(d_model, dtype=dtype)
        self.tgt_embed = TokenEmbed(vocab_size + 1, d_model, dtype=dtype,
                                    dropout_rate=dropout_rate)
        self.rm = RelationalMemory(rm_num_slots, rm_d_model, rm_num_heads)
        self.logit = Dense(d_model, vocab_size + 1, dtype)
        # the stacked CLN pack (w0, b0, w1, b1) and the parameters it was
        # made from with their (data_ptr, version); not module state
        self._cln_pack = None
        self._cln_made_from = None
        self.stacked_cln_steps = 0      # decode_step calls that used the pack
        self.cln_pack_refreshes = 0     # times the pack was written

    def encode(self, att_feats, att_mask, rng=None):
        """att_feats [B, P, d_vf], att_mask [B, P] -> [B, P, d_model]."""
        x = F.relu(self.att_embed(att_feats * att_mask[..., None]))
        x = dropout(x, self.drop_prob_lm, rng)
        mask = make_cross_mask(att_mask)
        for layer in self.enc_layers:
            x = layer(x, mask=mask, rng=rng)
        return self.enc_norm(x)

    def forward(self, att_feats, att_mask, tgt_ids, tgt_mask, rng=None):
        """Teacher-forced forward -> float32 log-probs [B, T, V+1]."""
        enc = self.encode(att_feats, att_mask, rng)
        return self.decode_train(enc, att_mask, tgt_ids, tgt_mask, rng)

    def decode_train(self, enc, att_mask, tgt_ids, tgt_mask, rng=None):
        x = self.tgt_embed(tgt_ids, rng)
        mem = self.rm.roll(x, rng)
        self_mask = make_self_mask(tgt_mask, causal=True)
        cross_mask = make_cross_mask(att_mask)
        for layer in self.dec_layers:
            x = layer(x, enc, self_mask, cross_mask, mem, rng)
        logits = self.logit(self.dec_norm(x))
        # upcast inside the softmax: no separate float32 copy of the logits
        return torch.log_softmax(logits, dim=-1, dtype=torch.float32)

    def _cln_sources(self):
        """(first-layer Dense, second-layer Dense, gamma or beta) of every
        conditional norm, in the pack's order: layer-major, then cln1..3,
        gamma before beta."""
        return [(getattr(c, f"mlp_{g}_0"), getattr(c, f"mlp_{g}_1"), getattr(c, g))
                for layer in self.dec_layers for c in (layer.cln1, layer.cln2, layer.cln3)
                for g in ("gamma", "beta")]

    @torch.no_grad()
    def sync_cln_pack(self) -> None:
        """Bring the stacked CLN pack up to date with the norms' parameters:
        written in place when one changed (an optimizer step,
        ``load_state_dict``, an import), so captured steps read the new
        values; dropped while a norm's ``Dense`` is split over mp. Checks
        each parameter's identity, address and version: a host check, no
        device work when nothing changed."""
        srcs = self._cln_sources()
        mem_dim = self.rm.num_slots * self.rm.d_model
        d, n = self.d_model, len(srcs)
        if any(tuple(m0.weight.shape) != (d, mem_dim) or tuple(m1.weight.shape) != (d, d)
               for m0, m1, _ in srcs):
            self._cln_pack = self._cln_made_from = None
            return
        params = [p for m0, m1, v in srcs for p in (m0.weight, m0.bias, m1.weight, m1.bias, v)]
        # an inference tensor keeps no version: such a pack is rewritten every time
        stamps = [(p.data_ptr(), None if p.is_inference() else p._version) for p in params]
        made = self._cln_made_from
        if (made is not None and all(a is b for a, b in zip(made[0], params))
                and made[1] == stamps and None not in (v for _, v in stamps)):
            return
        dev = params[0].device
        pack = self._cln_pack
        if pack is None or pack[0].device != dev:
            with torch.inference_mode(False):
                pack = (torch.empty(n * d, mem_dim, device=dev), torch.empty(n * d, device=dev),
                        torch.empty(n, d, d, device=dev), torch.empty(n, 1, d, device=dev))
        w0, b0, w1, b1 = pack
        torch.cat([m0.weight.float() for m0, _, _ in srcs], out=w0)
        torch.cat([m0.bias.float() for m0, _, _ in srcs], out=b0)
        torch.stack([m1.weight.float() for _, m1, _ in srcs], out=w1)
        torch.stack([m1.bias.float() for _, m1, _ in srcs], out=b1.view(n, d))
        b1.view(n, d).add_(torch.stack([v.float() for _, _, v in srcs]))
        self._cln_pack, self._cln_made_from = pack, (params, stamps)
        self.cln_pack_refreshes += 1

    def cln_scale_shift(self, mem):
        """Every conditional norm's (gamma + dg, beta + db) from the memory
        ``mem`` [N, S*D], in the pack's order -> [2 x 3 x layers, N, D]
        float32: all first layers as one ``addmm`` and ReLU, all second
        layers as one ``baddbmm`` whose bias holds gamma / beta."""
        w0, b0, w1, b1 = self._cln_pack
        h = torch.addmm(b0, mem.float(), w0.t()).relu_()             # [N, 2n * D]
        return torch.baddbmm(b1, h.view(h.shape[0], w1.shape[0], -1).transpose(0, 1),
                             w1.transpose(1, 2))

    def init_decode_state(self, enc, batch: int, max_len: Optional[int] = None,
                          kv_dtype: str = "") -> Dict[str, Any]:
        """Decode carry: relational memory, per-layer self-attn KV caches
        [batch, L, D] and beam-invariant cross K/V (one row per sample).
        ``kv_dtype="int8"``: int8 caches plus their per-slot scales. Brings
        the stacked CLN pack up to date (``sync_cln_pack``)."""
        self.sync_cln_pack()
        lmax = max_len or self.max_seq_len
        cross = [layer.prepare_cross_kv(enc) for layer in self.dec_layers]
        quant = kv_dtype == "int8"
        cache_dt = torch.int8 if quant else self.dtype

        def zeros(*shape, dtype=cache_dt):
            return tuple(torch.zeros(batch, lmax, *shape, dtype=dtype, device=enc.device)
                         for _ in range(self.num_layers))

        width = self.dec_layers[0].self_attn.kv_width      # D / mp under split heads
        state = {
            "memory": self.rm.init_memory(batch, enc.device),
            "cache_k": zeros(width),
            "cache_v": zeros(width),
            "cross_k": tuple(c[0] for c in cross),
            "cross_v": tuple(c[1] for c in cross),
        }
        if quant:
            state["cache_k_scale"] = zeros(dtype=torch.float32)
            state["cache_v_scale"] = zeros(dtype=torch.float32)
        return state

    def decode_step(self, tok, pos: int, state, att_mask, return_logits: bool = False,
                    age=None, return_topk: Optional[int] = None, topk_suppress=()):
        """tok [N], pos: step -> (log-probs [N, V+1], new state).

        ``return_logits``: the first element is the raw logits instead.
        ``return_topk=k``: the vocab tail runs as the fused logit + top-k
        kernel (ops/fused_logit_topk.py) and the first element is
        (vals [N, k] f32, idx [N, k] i32, lse [N] f32), ``topk_suppress`` ids
        knocked down by -1000 inside it."""
        x = self.tgt_embed.at_position(tok, pos, age=age)          # [N, 1, D]
        mem = self.rm.step(x[:, 0, :], state["memory"])            # [N, S*D]
        cln = [None] * self.num_layers
        if self._cln_pack is not None and not torch.is_grad_enabled():
            ss = self.cln_scale_shift(mem)[:, :, None, :]          # [6 x layers, N, 1, D]
            cln = [tuple((ss[6 * i + 2 * j], ss[6 * i + 2 * j + 1]) for j in range(3))
                   for i in range(self.num_layers)]
            self.stacked_cln_steps += 1
        cross_mask = make_cross_mask(att_mask)
        anc = state.get("anc")
        quant = "cache_k_scale" in state
        new_k, new_v = [], []
        for i, layer in enumerate(self.dec_layers):
            scales = ((state["cache_k_scale"][i], state["cache_v_scale"][i]) if quant
                      else None)
            x, ck, cv = layer.step(x, state["cross_k"][i], state["cross_v"][i], cross_mask,
                                   mem[:, None, :], state["cache_k"][i],
                                   state["cache_v"][i], pos, anc=anc, age=age,
                                   kv_scales=scales, cln=cln[i])
            new_k.append(ck)
            new_v.append(cv)
        x = self.dec_norm(x)
        if return_topk:
            if self.logit.out_width != self.logit.weight.shape[0]:
                raise ValueError("the fused logit + top-k tail needs the whole logit weight; "
                                 "it is split over mp (parallel/tp.py)")
            out = fused_logit_topk(x[:, 0, :].to(self.dtype).contiguous(),
                                   self.logit.weight, self.logit.bias,
                                   int(return_topk), tuple(topk_suppress))
        else:
            logits = self.logit(x)[:, 0, :]
            out = logits if return_logits else torch.log_softmax(logits.float(), dim=-1)
        new_state = dict(state, memory=mem, cache_k=tuple(new_k), cache_v=tuple(new_v))
        return out, new_state
