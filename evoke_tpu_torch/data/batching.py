"""Static-shape multiview batching and host-side prefetch for serving (the
port's counterparts of evoke_tpu/data/batching.py).

``MultiviewBatcher`` keeps the JAX package's static batch layout (the
reference's collate, dataloaders_v0401.py:60-116, made static): the first
``n_anchor`` image slots are study anchors aligned with the per-study texts,
the next ``n_aux_slots`` hold auxiliary views deduplicated by path (padding
slots invalid, with unique negative pid codes; views beyond capacity are
dropped and counted in ``aux_dropped``), text is padded to ``max_seq_len``.
Images are decoded and transformed in a thread pool.

``Prefetcher`` pulls loader batches on a background thread, and
``device_prefetch`` copies them from pinned host memory to the card with
``non_blocking=True``, ``depth`` batches ahead of the consumer (under a dp
mesh, each rank its own rows)."""

from __future__ import annotations

import collections
import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from evoke_tpu_torch.core.profiling import span
from evoke_tpu_torch.data.datasets import Example
from evoke_tpu_torch.data.tokenizer import WordTokenizer
from evoke_tpu_torch.data.transforms import ImageTransform, load_image


class MultiviewBatcher:
    """Yields static-shape batches from a list of Examples."""

    def __init__(self, examples: Sequence[Example], tokenizer: WordTokenizer,
                 transform: ImageTransform, *, n_anchor: int, n_aux_slots: Optional[int] = None,
                 max_seq_len: int = 100, image_dir: str = "", shuffle: bool = False,
                 with_indication: bool = False, multiview: bool = True,
                 text_field: str = "align_text", add_bos_eos: bool = False,
                 seed: int = 0, num_workers: int = 8, drop_last: bool = False):
        self.examples = list(examples)
        self.tokenizer = tokenizer
        self.transform = transform
        self.n_anchor = n_anchor
        self.n_aux = n_aux_slots if n_aux_slots is not None else (n_anchor if multiview else 0)
        self.max_seq_len = max_seq_len
        self.image_dir = image_dir
        self.shuffle = shuffle
        self.with_indication = with_indication
        self.multiview = multiview
        self.text_field = text_field
        self.add_bos_eos = add_bos_eos
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.aux_dropped = 0  # running count of truncated aux views (never silent)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Make the next pass the ``epoch``-th (from 0): its order and
        augmentation come from ``seed + epoch``, so a resumed run's epoch
        draws what an unbroken run's does."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.examples)
        if self.drop_last:
            return n // self.n_anchor
        return (n + self.n_anchor - 1) // self.n_anchor

    def _encode_text(self, text: str) -> np.ndarray:
        return self.tokenizer.encode_padded(text, self.max_seq_len,
                                            add_bos_eos=self.add_bos_eos)

    def _build_batch(self, group: List[Example], rng: np.random.Generator,
                     pool: ThreadPoolExecutor, mesh=None) -> Dict[str, np.ndarray]:
        n_a, n_x = self.n_anchor, self.n_aux
        total = n_a + n_x
        decode = range(total) if mesh is None else range(total)[mesh.rows(total)]
        s = self.transform.image_size
        img_dtype = np.uint8 if getattr(self.transform, "output_uint8", False) else np.float32
        images = np.zeros((total, s, s, 3), img_dtype)
        pids = np.arange(total, dtype=np.int32) * -1 - 1  # unique negatives by default
        valid = np.zeros(total, bool)
        ids = np.zeros((n_a, self.max_seq_len), np.int32)
        mask = np.zeros((n_a, self.max_seq_len), np.int32)
        inc_ids = np.zeros((n_a, self.max_seq_len), np.int32)
        image_ids: List[str] = [""] * n_a
        gts: List[str] = [""] * n_a

        # assign codes per study
        jobs = []  # (slot, path)
        aux_slot = n_a
        seen_info: Dict[str, int] = {}
        for i, ex in enumerate(group):
            pids[i] = i
            valid[i] = True
            image_ids[i] = ex.id
            gts[i] = ex.report
            text = getattr(ex, self.text_field)
            ids[i] = self._encode_text(text)
            if self.with_indication:
                inc_ids[i] = self.tokenizer.encode_padded(ex.indication, self.max_seq_len)
            jobs.append((i, ex.anchor_path))
            seen_info[ex.anchor_path] = i
            if self.multiview:
                for p in ex.aux_paths:
                    if p in seen_info:
                        continue  # dedup by image path (reference: patient_info)
                    if aux_slot >= total:
                        self.aux_dropped += 1
                        continue
                    seen_info[p] = aux_slot
                    pids[aux_slot] = i
                    valid[aux_slot] = True
                    jobs.append((aux_slot, p))
                    aux_slot += 1

        # each image's transform seed is drawn here, in slot order, so the
        # worker threads' scheduling cannot reorder the augmentation draws
        # (a dp rank draws every seed and decodes only its own image rows)
        seeds = [int(rng.integers(0, 2**31)) for _ in jobs]

        def work(job):
            (slot, path), seed = job
            img = load_image(path, self.image_dir)
            images[slot] = self.transform(img, rng=np.random.default_rng(seed))

        list(pool.map(work, [(j, sd) for j, sd in zip(jobs, seeds) if j[0] in decode]))
        mask = (ids != self.tokenizer.pad_id).astype(np.int32)
        batch = {"images": images, "ids": ids, "mask": mask, "pids": pids, "valid": valid,
                 "_image_ids": image_ids, "_gts": gts}
        if self.with_indication:
            batch["inc_ids"] = inc_ids
            batch["inc_mask"] = (inc_ids != self.tokenizer.pad_id).astype(np.int32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self._batches()

    def _batches(self, mesh=None) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.examples))
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        if self.shuffle:
            rng.shuffle(order)
        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(order), self.n_anchor):
                idx = order[start:start + self.n_anchor]
                if len(idx) < self.n_anchor and self.drop_last:
                    break
                group = [self.examples[i] for i in idx]
                yield self._build_batch(group, rng, pool, mesh)


class _RankView:
    """A ``MultiviewBatcher`` as one dp rank iterates it (see ``rank_view``)."""

    def __init__(self, batcher: MultiviewBatcher, mesh):
        self.batcher, self.mesh = batcher, mesh

    def __len__(self) -> int:
        return len(self.batcher)

    def __iter__(self):
        return self.batcher._batches(self.mesh)


def rank_view(loader, mesh):
    """``loader`` as the rank of a dp ``mesh`` iterates it: a
    ``MultiviewBatcher``'s batches keep the global layout (every text row,
    pid, flag and host extra; the auxiliary views deduplicated over the
    global batch) but decode only the image rows the rank owns
    (``mesh.rows``), the others left zero, so the host's decode work splits
    over the ranks. Any other loader (or no mesh) is returned as it is."""
    if mesh is None or mesh.dp == 1 or not isinstance(loader, MultiviewBatcher):
        return loader
    return _RankView(loader, mesh)


def to_device(batch, device: torch.device):
    """Split a loader batch into (device tensors, host extras): '_'-prefixed
    keys stay on the host. On the card the copy is pinned + non_blocking."""
    host = {k: v for k, v in batch.items() if k.startswith("_")}
    dev = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        t = torch.as_tensor(np.asarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        dev[k] = t
    return dev, host


def stage_batch(batch, device: torch.device, mesh=None):
    """One loader batch -> (device tensors, host extras): ``to_device``, or
    with a dp ``mesh`` only the rows this rank owns of every device entry
    (``core/mesh.shard_batch``: a leading dim that does not divide dp raises)
    on the rank's device; the host extras stay whole."""
    if mesh is None:
        return to_device(batch, device)
    from evoke_tpu_torch.core.mesh import shard_batch

    host = {k: v for k, v in batch.items() if k.startswith("_")}
    data = {k: v for k, v in batch.items() if not k.startswith("_")}
    return shard_batch(data, mesh), host


def device_prefetch(batches, device: torch.device, depth: int = 2, mesh=None,
                    stage=stage_batch):
    """Yield (device_batch, host_extras) with up to ``depth`` copies in flight,
    each batch staged by ``stage(batch, device, mesh)``. Under a dp ``mesh``
    every rank must iterate the same loader, so that each sees the same
    number of batches (the loaders pad the last one to the static shape); a
    rank decodes only its own images when the loader is its ``rank_view``."""
    pending: "collections.deque" = collections.deque()
    for batch in batches:
        pending.append(stage(batch, device, mesh))
        if len(pending) > depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


class Prefetcher:
    """Background-thread prefetch of an iterable of batches; each batch the
    iterable yields is the span ``loader.next`` on that thread (its ``batch``:
    the batch's number in this pass)."""

    def __init__(self, iterable, depth: int = 2):
        self.iterable = iterable
        self.depth = depth

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()
        err: List[BaseException] = []

        def producer():
            try:
                it = iter(self.iterable)
                for i in itertools.count():
                    with span("loader.next", batch=i):
                        item = next(it, sentinel)
                    if item is sentinel:
                        break
                    q.put(item)
            except BaseException as e:  # re-raised on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                t.join(timeout=10)
                if err:
                    raise err[0]
                return
            yield item
