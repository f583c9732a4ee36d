"""The yardstick's arithmetic: the H100's peaks, and the operations and bytes
the model's parts need, counted from the configuration's shapes.

A FLOP is a multiply or an add (2 per multiply-accumulate). Only matrix
products, convolutions and attention are counted; norms, activations and
softmaxes are left out, so every count is a lower bound of the work.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

RESNET_STAGES = (3, 4, 23, 3)


def conv_flops(cin, cout, k, hout, wout):
    return 2 * cin * cout * k * k * hout * wout


def resnet101_flops(image_size: int) -> float:
    """One image through ResNet-101 up to C5 (no pooling head)."""
    s = image_size // 2                                   # conv1, stride 2
    total = conv_flops(3, 64, 7, s, s)
    s //= 2                                               # max pool
    cin = 64
    for stage, n in enumerate(RESNET_STAGES):
        f = 64 * 2 ** stage
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            so = s // stride
            total += conv_flops(cin, f, 1, s, s) + conv_flops(f, f, 3, so, so)
            total += conv_flops(f, 4 * f, 1, so, so)
            if i == 0:
                total += conv_flops(cin, 4 * f, 1, so, so)
            s, cin = so, 4 * f
    return float(total)


def dense(rows, din, dout):
    return 2.0 * rows * din * dout


def attention(tq, tk, width):
    """Scores and the weighted sum: q.k and p.v over ``width`` summed heads."""
    return 4.0 * tq * tk * width


def image_tokens(m: Dict, image_size: int) -> int:
    return 1 + (image_size // 32) ** 2


def bert_layer(m, tq, tk, d, inter, cross=False):
    """Self-attention (and cross-attention) + FFN of one BERT block."""
    f = dense(tq, d, d) * 2 + dense(tk, d, d) * 2 + attention(tq, tk, d)
    if cross:
        f += dense(tq, d, d) * 4 + attention(tq, tq, d)
    return f + dense(tq, d, inter) + dense(tq, inter, d)


def study_encoder_flops(m: Dict, image_size: int, n_images: int, n_partner_images: int,
                        inc_len: int) -> float:
    """One study's encoder: ResNet-101 on each of its images, the fusion of
    its anchor with its partner views, the heads, the text encoder over
    ``inc_len`` indication tokens, the cross layer, and the decoder's own
    encoder over the patch tokens (with its cross K / V per layer)."""
    t = image_tokens(m, image_size)
    dvf, out, d = m["d_vf"], m["output_dim"], m["d_model"]
    hd = m["proj_num_heads"] * (dvf if m["fusion_wide_qkv"] else dvf // m["proj_num_heads"])
    f = n_images * resnet101_flops(image_size)
    if n_partner_images:
        kv = t * n_partner_images
        f += dense(t, dvf, hd) + 2 * dense(kv, dvf, hd) + attention(t, kv, hd) + dense(t, hd, dvf)
    f += dense(t, dvf, out) + dense(t, out, out)                       # visual head
    h = m["encoder_hidden_size"]
    f += m["encoder_num_layers"] * bert_layer(m, inc_len, inc_len, h,
                                              m["encoder_intermediate_size"])
    f += dense(inc_len, h, out) + dense(inc_len, out, out)            # text head
    f += m["sk_fusion_num_layers"] * (bert_layer(m, t, inc_len, out,
                                                 m["fusion_intermediate_size"], cross=True))
    p = t - 1
    f += dense(p, out, d)
    f += m["num_layers"] * (dense(p, d, d) * 4 + attention(p, p, d) + 2 * dense(p, d, m["d_ff"]))
    f += m["num_layers"] * 2 * dense(p, d, d)                          # cross K / V
    if m["decoder_kind"] == "cmn":
        f += cmn_read(m, p)
    return f


def cmn_read(m, rows):
    """CMN's memory read for ``rows`` queries: q / o projections, the scores
    against every slot, the weighted sum of the top-k (the memory's K / V
    projections are per model, not per token, and left out)."""
    d = m["d_model"]
    return dense(rows, d, d) * 2 + 2.0 * rows * m["cmm_size"] * d + 2.0 * rows * m["cmn_topk"] * d


def decode_step_flops(m: Dict, t: int, image_size: int) -> float:
    """One beam row's decode step at position ``t`` (t + 1 cached rows):
    every layer's projections, self- and cross-attention and FFN, the
    relational memory and conditional norms (R2Gen) or the memory read
    (CMN), and the logits over the whole vocabulary."""
    d, L, p = m["d_model"], m["num_layers"], image_tokens(m, image_size) - 1
    f = L * (dense(1, d, d) * 6 + attention(1, t + 1, d) + attention(1, p, d)
             + 2 * dense(1, d, m["d_ff"]))
    if m["decoder_kind"] == "cmn":
        f += cmn_read(m, 1)
    else:
        s = m["rm_num_slots"]
        mem = s * m["rm_d_model"]
        f += dense(s, d, d) + 2 * dense(s + 1, d, d) + attention(s, s + 1, d) + dense(s, d, d)
        f += 2 * dense(s, d, d) + dense(1, d, 2 * d) + dense(s, d, 2 * d)
        f += L * 3 * 2 * (dense(1, mem, d) + dense(1, d, d))              # CLN MLPs
    return f + dense(1, d, m["vocab_size"] + 1)


def report_decode_flops(m: Dict, length: int, beam: int, image_size: int) -> float:
    """A report of ``length`` tokens: ``beam`` rows, steps 0 .. length - 1."""
    return beam * sum(decode_step_flops(m, t, image_size) for t in range(length))


# ---- the hand-written kernels ----

def k1_study_bytes(m: Dict, length: int, beam: int, dtype_bytes: int = 2) -> float:
    """Lineage attention (K1) over a report of ``length`` steps, all layers:
    what the study's calls need at the least. Each step reads the beam rows'
    queries and writes their outputs, reads the lineage rows of its cache
    (t + 1 of them when the beams share one lineage, the fewest the inputs
    allow) for K and V, and the ancestor entries of those rows."""
    d = m["d_model"]
    per_layer = 0.0
    for t in range(length):
        per_layer += 2 * beam * d * dtype_bytes + 2 * (t + 1) * d * dtype_bytes
        per_layer += beam * (t + 1) * 4
    return m["num_layers"] * per_layer


def k1_study_flops(m: Dict, length: int, beam: int) -> float:
    return m["num_layers"] * beam * sum(attention(1, t + 1, m["d_model"]) for t in range(length))


def k2_call_bytes(m: Dict, rows: int, k: int, dtype_bytes: int = 2) -> float:
    """The fused logit + top-k tail (K2) for ``rows`` rows: h and the whole
    weight and bias read once, the k candidates and the log-sum-exp written."""
    d, v = m["d_model"], m["vocab_size"] + 1
    return dtype_bytes * (rows * d + v * d + v) + rows * k * 8 + rows * 4


def k2_call_flops(m: Dict, rows: int) -> float:
    return dense(rows, m["d_model"], m["vocab_size"] + 1)


def bound_s(nbytes: float, flops: float) -> float:
    """The least time on the card at bf16: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
