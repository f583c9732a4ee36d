"""Port parity: the visual and text encoder side (ResNet-101 at full depth on
32 px images, projection heads in eval mode, multiview fusion in its grouped
and dense forms, the BERT text encoder). The whole encode_for_decode is in
tests/test_torch_port_slice.py.

Tolerance rtol 1e-3 (atol 1e-4) for the 101-layer depth; 1e-5/1e-4 where
the chain is short."""

import jax
import numpy as np
import pytest
import torch

from evoke_tpu.models import fusion as jf
from evoke_tpu.models.heads import ProjectionHead as JHead
from evoke_tpu.models.resnet import VisualExtractor as JVis
from evoke_tpu.models.text_encoder import TextEncoder as JText
from evoke_tpu_torch.models import fusion as tf
from evoke_tpu_torch.models.heads import ProjectionHead as THead
from evoke_tpu_torch.models.resnet import VisualExtractor as TVis
from evoke_tpu_torch.models.text_encoder import TextEncoder as TText
from evoke_tpu_torch.params import load_flax_variables

from _torch_port_util import to_np

torch.set_num_threads(1)
KEY = jax.random.key(0)
SHORT = dict(atol=1e-4, rtol=1e-4)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), b.detach().float().numpy(), **tol)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _perturb_stats(v, rng):
    """Non-trivial running statistics so inference-mode BN is exercised."""
    def f(path, x):
        name = path[-1].key
        if name == "mean":
            return (rng.normal(size=x.shape) * 0.1).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
        return x
    return {"params": v["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(f, v["batch_stats"])}


def test_visual_extractor_full_depth(rng):
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JVis()
    v = _perturb_stats(to_np(jax.jit(jm.init)(KEY, x)), rng)
    tm = TVis().eval()
    load_flax_variables(tm, v)
    jp, ja = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        tp, ta = tm(torch.as_tensor(x))
    assert tp.shape == (2, 1, 2048)
    _close(jp, tp, rtol=1e-3, atol=1e-4)
    _close(ja, ta, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("final_bn", [False, True])
def test_projection_head_eval(rng, final_bn):
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    jm = JHead(40, 16, final_bn=final_bn)
    v = _perturb_stats(to_np(jm.init(KEY, x)), rng)
    tm = THead(24, 40, 16, final_bn=final_bn).eval()
    load_flax_variables(tm, v)
    _close(jm.apply(v, x), tm(torch.as_tensor(x)), **SHORT)
    _close(jm.apply(v, x[:, 0]), tm(torch.as_tensor(x[:, 0])), **SHORT)


@pytest.mark.parametrize("max_partners,wide", [(None, False), (3, False), (2, True)])
def test_multiview_fusion(rng, max_partners, wide):
    """Dense masked and grouped forms; anchor 2 has no partner (pass-through),
    anchor 0 has two partners, an invalid aux view is ignored."""
    d, heads, t = 16, 2, 5
    pids = np.array([0, 1, 2, 0, 1, 0, 3], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 0], bool)
    x = rng.normal(size=(len(pids), t, d)).astype(np.float32)
    jm = jf.MultiviewFusion(d, heads, wide_qkv=wide, max_partners=max_partners)
    v = to_np(jm.init(KEY, x, pids, valid, 3))
    tm = tf.MultiviewFusion(d, heads, wide_qkv=wide, max_partners=max_partners).eval()
    load_flax_variables(tm, v)
    jo, jh = jm.apply(v, x, pids, valid, 3)
    to, th = tm(torch.as_tensor(x), torch.as_tensor(pids), torch.as_tensor(valid), 3)
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    _close(jo, to, **SHORT)
    assert tf.max_partners_in(pids, valid, 3) == jf.max_partners_in(pids, valid, 3) == 2


def test_text_encoder(rng):
    ids = rng.integers(0, 40, size=(3, 7)).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, 5:] = 0
    jm = JText(40, 32, 2, 4, 64)
    v = to_np(jm.init(KEY, ids, mask))
    tm = TText(40, 32, 2, 4, 64).eval()
    load_flax_variables(tm, v)
    _close(jm.apply(v, ids, mask), tm(torch.as_tensor(ids), torch.as_tensor(mask)), **SHORT)
