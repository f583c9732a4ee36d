"""Shared set-up for the port's parity tests (tests/test_torch_port_*.py).

The same numpy-seeded inputs and the same JAX-initialised weights (carried
over by ``evoke_tpu_torch.params``) go through the JAX package and the port,
both on the CPU; JAX runs at float32 ``highest`` matmul precision
(tests/conftest.py)."""

import copy
import functools

import numpy as np
import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

TINY = dict(output_dim=64, encoder_hidden_size=32, encoder_num_layers=1,
            encoder_num_heads=2, encoder_intermediate_size=64, d_model=32, d_ff=64,
            num_heads=2, num_layers=2, rm_num_slots=3, rm_d_model=32,
            fusion_num_heads=2, fusion_intermediate_size=64, sk_fusion_num_layers=1,
            max_seq_len=16, fusion_wide_qkv=False)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def example_batch(rng, n_anchor, n_aux, image_size, seq_len, vocab_size):
    """The __graft_entry__._example_batch layout: anchors first, aux views of
    anchor (i % n_anchor), indication ids/mask."""
    total = n_anchor + n_aux
    pids = np.concatenate([np.arange(n_anchor), np.arange(n_aux) % n_anchor]).astype(np.int32)
    return {
        "images": rng.normal(size=(total, image_size, image_size, 3)).astype(np.float32),
        "ids": rng.integers(5, vocab_size - 3, size=(n_anchor, seq_len)).astype(np.int32),
        "mask": np.ones((n_anchor, seq_len), np.int32),
        "pids": pids,
        "valid": np.ones(total, bool),
        "inc_ids": rng.integers(5, vocab_size - 3, size=(n_anchor, seq_len)).astype(np.int32),
        "inc_mask": np.ones((n_anchor, seq_len), np.int32),
    }


@functools.lru_cache(maxsize=None)
def tiny_pair(vocab=50, seed=0, n_anchor=2, n_aux=2, image_size=32, sharpen=True):
    """(jax model, jax variables (numpy), port model loaded with them, batch),
    built once per process (JAX init of the tiny flagship takes ~30 s on the
    CPU); callers must not mutate what it returns.

    ``sharpen`` rescales the decoder's logit head so random weights produce
    varied tokens (and EOS) instead of one repeated word."""
    from evoke_tpu.models.finetune import FinetuneModel as JModel

    from evoke_tpu_torch.models.finetune import FinetuneModel as TModel
    from evoke_tpu_torch.params import load_flax_variables

    rng = np.random.default_rng(seed)
    batch = example_batch(rng, n_anchor, n_aux, image_size, 16, vocab)
    jm = JModel(vocab_size=vocab, drop_prob_lm=0.5, **TINY)
    v = jax.jit(lambda k: jm.init(k, batch["images"], batch["ids"], batch["mask"],
                                  batch["pids"], batch["valid"], batch["inc_ids"],
                                  batch["inc_mask"], method=jm.warmup))(jax.random.key(seed))
    v = to_np(v)
    if sharpen:
        lg = v["params"]["text_decoder"]["logit"]
        lg["kernel"] = (rng.normal(size=lg["kernel"].shape) * 1.5).astype(np.float32)
        lg["bias"] = (rng.normal(size=lg["bias"].shape) * 0.5).astype(np.float32)
    tm = TModel(vocab_size=vocab, **TINY).eval()
    load_flax_variables(tm, v)
    return jm, v, tm, batch


class Tok:
    """Minimal tokenizer surface of the generate steps (ids only)."""

    def __init__(self, vocab):
        self.vocab = vocab
        self.bos_id, self.eos_id, self.pad_id, self.unk_id = vocab - 2, vocab - 1, 0, 4

    def get_vocab_size(self):
        return self.vocab


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: every nn.Dropout call returns its input."""
    if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def recording(tx):
    """An optax transformation whose state also carries the gradients it was
    given (read after the jitted step)."""
    import optax

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        upd, inner = tx.update(grads, state[0], params)
        return upd, (inner, grads)

    return optax.GradientTransformation(init, update)


def damped(v):
    """Variables with each Bottleneck's bn3 scale x 0.1 (keeps a
    batch-statistics forward over a few images well conditioned)."""
    v = copy.deepcopy(v)
    for name, blk in v["params"]["visual_extractor"]["backbone"].items():
        if name.startswith("layer"):
            blk["bn3"]["scale"] = blk["bn3"]["scale"] * np.float32(0.1)
    return v


ZOO = dict(cmn=dict(cmm_size=48, cmm_dim=32, cmn_topk=6), causal={}, bertgen={})


def zoo_decoder(kind, vocab=50):
    """The JAX text decoder FinetuneModel(decoder_kind=kind, **TINY) builds
    (models/finetune.py's arguments)."""
    from evoke_tpu.models.causal_decoder import BertGenerationDecoder, CausalDecoder
    from evoke_tpu.models.cmn import CMNDecoder

    common = dict(vocab_size=vocab, d_model=TINY["d_model"], d_vf=TINY["output_dim"],
                  num_layers=TINY["num_layers"], num_heads=TINY["num_heads"],
                  dropout_rate=0.0, drop_prob_lm=0.5, max_seq_len=TINY["max_seq_len"])
    if kind == "cmn":
        z = ZOO["cmn"]
        return CMNDecoder(d_ff=TINY["d_ff"], cmm_size=z["cmm_size"], cmm_dim=z["cmm_dim"],
                          topk=z["cmn_topk"], **common)
    cls = BertGenerationDecoder if kind == "bertgen" else CausalDecoder
    return cls(d_ff=max(TINY["d_ff"], 4 * TINY["d_model"]), **common)


@functools.lru_cache(maxsize=None)
def zoo_pair(kind, vocab=50, seed=0):
    """``tiny_pair``'s model with the text decoder of ``kind``: (jax model,
    variables (tiny_pair's with the decoder's own init in ``text_decoder``,
    its logit head sharpened), port model loaded with them, batch)."""
    from evoke_tpu.models.finetune import FinetuneModel as JModel

    from evoke_tpu_torch.models.finetune import FinetuneModel as TModel
    from evoke_tpu_torch.params import load_flax_variables

    _, v0, _, batch = tiny_pair(vocab, seed)
    rng = np.random.default_rng(seed + 1)
    dec = zoo_decoder(kind, vocab)
    att = rng.normal(size=(2, 3, TINY["output_dim"])).astype(np.float32)
    ids = rng.integers(1, vocab, size=(2, 5)).astype(np.int32)
    dv = to_np(jax.jit(dec.init)(jax.random.key(seed + 1), att, np.ones((2, 3), np.int32), ids,
                                 np.ones((2, 5), np.int32)))
    head = dv["params"]["lm_head" if kind == "bertgen" else "logit"]
    head["kernel"] = (rng.normal(size=head["kernel"].shape) * 1.5).astype(np.float32)
    head["bias"] = (rng.normal(size=head["bias"].shape) * 0.5).astype(np.float32)
    v = copy.deepcopy(v0)
    v["params"]["text_decoder"] = dv["params"]
    jm = JModel(vocab_size=vocab, drop_prob_lm=0.5, decoder_kind=kind, **ZOO[kind], **TINY)
    tm = TModel(vocab_size=vocab, decoder_kind=kind, **ZOO[kind], **TINY).eval()
    load_flax_variables(tm, v)
    return jm, v, tm, batch
