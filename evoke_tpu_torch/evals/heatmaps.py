"""Attention heatmaps of generated tokens (port of evoke_tpu/evals/heatmaps.py).

The colour maths is the JAX package's, in numpy: a bilinear resize of the
min-max normalised patch weights, a JET colour map, blended 50/50 with the
denormalised image. PNGs are written with the standard library (zlib +
struct), so no imaging package is needed. The attention maps come from one
teacher-forced forward of the model over the generated sequences with the
decoder layers' cross-attention recorded (``recorded_attention``; the
decoder is causal, so query t attends as the decode step that chose word t
did).
"""

from __future__ import annotations

import contextlib
import os
import struct
import zlib
from typing import Dict, List

import numpy as np

from evoke_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD


def _bilinear_resize(arr: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = arr.shape
    ys = np.linspace(0, h - 1, out_h)
    xs = np.linspace(0, w - 1, out_w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    a = arr[np.ix_(y0, x0)]
    b = arr[np.ix_(y0, x1)]
    c = arr[np.ix_(y1, x0)]
    d = arr[np.ix_(y1, x1)]
    return a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """x in [0, 1] -> [..., 3] RGB in [0, 1] (cv2 COLORMAP_JET approximation)."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """Undo the ImageNet normalisation -> [0, 1] RGB."""
    return np.clip(img * IMAGENET_STD + IMAGENET_MEAN, 0.0, 1.0)


def token_heatmap(image: np.ndarray, patch_weights: np.ndarray) -> np.ndarray:
    """image [H, W, 3] normalised; patch_weights [P] over a square patch grid
    -> the blended heatmap [H, W, 3] in [0, 1]."""
    g = int(round(np.sqrt(patch_weights.shape[0])))
    if g * g != patch_weights.shape[0]:
        raise ValueError(f"{patch_weights.shape[0]} patches are not a square grid")
    w = patch_weights.reshape(g, g).astype(np.float64)
    w = w - w.min()
    w = w / max(w.max(), 1e-12)
    h, wd = image.shape[:2]
    return 0.5 * jet_colormap(_bilinear_resize(w, h, wd)) + 0.5 * denormalize_image(image)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(image01: np.ndarray, path: str) -> None:
    """Write an [H, W, 3] float image in [0, 1] as an 8-bit RGB PNG, each
    value truncated to a level as the JAX package's writer does."""
    px = (np.clip(image01, 0, 1) * 255).astype(np.uint8)
    h, w, _ = px.shape
    rows = b"".join(b"\x00" + px[i].tobytes() for i in range(h))   # filter 0 per row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows, 6)) + _chunk(b"IEND", b""))


@contextlib.contextmanager
def recorded_attention(modules):
    """Record the probabilities of every full-width ``attend`` of each
    ``layers.MultiHeadAttention`` in ``modules`` while the block runs; yields
    one list per module."""
    records = [[] for _ in modules]
    for m, rec in zip(modules, records):
        m.record = rec
    try:
        yield records
    finally:
        for m in modules:
            m.record = None


def cross_attention_modules(model) -> List:
    """The cross-attention of each decoder layer, ``dec_{i}.src_attn`` (the
    JAX package reads ``text_decoder/dec_{i}/src_attn/attn``: the R2Gen and
    CMN decoders)."""
    layers = getattr(model.text_decoder, "dec_layers", None)
    if not layers:
        raise ValueError(f"decoder_kind={getattr(model, 'decoder_kind', '?')!r} has no "
                         "dec_{i}/src_attn cross-attention to draw")
    return [layer.src_attn for layer in layers]


def render_generation_heatmaps(model, batch: Dict, seqs: np.ndarray, tokenizer, out_dir: str,
                               num_layers: int, study_ids: List[str] = None,
                               max_studies: int = 4,
                               with_indication: bool = False) -> List[str]:
    """Per decoder layer and generated word, a JET cross-attention overlay
    PNG ``{out_dir}/{study_id}/layer_{l}/{word_idx:04d}_{word}.png`` for the
    first ``max_studies`` studies (``render_generation_heatmaps``,
    heatmaps.py:96-152). ``batch``: the loader batch's tensors on the model's
    device (private ``_`` keys dropped); ``seqs`` [n_anchor, L] the generated
    ids. Returns the written paths."""
    import torch

    from evoke_tpu_torch.train.steps import maybe_normalize_images

    seqs = np.asarray(seqs)
    n = min(max_studies, seqs.shape[0])
    b = maybe_normalize_images(batch)
    dev = b["ids"].device
    # teacher-forced ids [BOS, w0, w1, ...]: query i predicts (and so attends for) word i
    bos = np.full((seqs.shape[0], 1), tokenizer.bos_id, seqs.dtype)
    dec_ids = np.concatenate([bos, seqs[:, :-1]], axis=1)
    dec_mask = np.concatenate([bos * 0 + 1, seqs[:, :-1] != tokenizer.pad_id],
                              axis=1).astype(np.int32)
    args = [b["images"], torch.as_tensor(dec_ids, device=dev),
            torch.as_tensor(dec_mask, device=dev), b["pids"], b["valid"]]
    if with_indication:
        args += [b["inc_ids"], b["inc_mask"]]
    modules = cross_attention_modules(model)
    with torch.no_grad(), recorded_attention(modules) as records:
        model(*args, train=False)
    images = b["images"].float().cpu().numpy()
    written: List[str] = []
    for layer_idx in range(num_layers):
        # [B, Tq, P]: the head mean, as the reference's .mean(0)
        att = records[layer_idx][0].mean(1).cpu().numpy()
        for i in range(n):
            sid = str(study_ids[i]) if study_ids is not None else f"{i:04d}"
            d = os.path.join(out_dir, sid.replace(os.sep, "_"), f"layer_{layer_idx}")
            os.makedirs(d, exist_ok=True)
            for word_idx in range(seqs.shape[1]):
                tok_id = int(seqs[i, word_idx])
                if tok_id in (tokenizer.pad_id, tokenizer.eos_id):
                    break
                word = tokenizer.decode_batch([[tok_id]])[0].strip() or str(tok_id)
                path = os.path.join(d, f"{word_idx:04d}_{word[:40]}.png")
                save_png(token_heatmap(images[i], att[i, word_idx]), path)
                written.append(path)
    return written
