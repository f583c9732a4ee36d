"""ctypes loader for the native C++ host components (port of
``evoke_tpu/native/__init__.py``; its own copy of ``evoke_native.cpp``).

A WordLevel encoder (the Python ``data/tokenizer.py``'s vocab and semantics)
and an exact top-k inner-product search with same-study exclusion (the host
counterpart of ``retrieval/topk.py``), mirroring where the reference leans on
native code (Rust tokenizers, FAISS — SURVEY §2.12). ``g++`` builds the
library at first use into ``evoke_tpu_torch/_build/`` (git-ignored) under a
name that hashes the source and flags, so an edited source is rebuilt and a
built one reused. Without a compiler (or on a failed build) ``load_native``
returns None, and ``NativeWordLevel`` / ``native_topk_ip`` raise
``RuntimeError``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import List, Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "evoke_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """The hashed .so path (source + flags)."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libevoke_native-{h.hexdigest()[:16]}.so")


def build_native(force: bool = False) -> Optional[str]:
    """Compile the shared library unless its hashed file exists; returns its
    path, or None when g++ is missing or fails."""
    path = library_path()
    if os.path.exists(path) and not force:
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        print(f"[native] build failed: {e}", file=sys.stderr)
        return None
    os.replace(tmp, path)
    return path


def load_native() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build_native()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.wl_create.restype = ctypes.c_void_p
        lib.wl_create.argtypes = [ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32]
        lib.wl_destroy.argtypes = [ctypes.c_void_p]
        lib.wl_token_id.restype = ctypes.c_int32
        lib.wl_token_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.wl_encode.restype = ctypes.c_int32
        lib.wl_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                                  ctypes.c_int32]
        lib.wl_encode_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                                        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                                        ctypes.c_int32]
        lib.topk_ip.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
                                ctypes.POINTER(ctypes.c_int32),
                                ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


class NativeWordLevel:
    """C++ WordLevel encoder sharing the Python WordTokenizer's vocab/semantics."""

    def __init__(self, vocab: dict, unk_id: int, lowercase: bool = True):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self.lib = lib
        ordered = sorted(vocab.items(), key=lambda kv: kv[1])
        assert [i for _, i in ordered] == list(range(len(ordered))), "vocab ids must be dense"
        blob = "\n".join(t for t, _ in ordered).encode()
        self.handle = lib.wl_create(blob, unk_id, int(lowercase))

    def __del__(self):
        if getattr(self, "handle", None) and self.lib:
            self.lib.wl_destroy(self.handle)
            self.handle = None

    def encode_padded_batch(self, texts: List[str], max_len: int, pad_id: int
                            ) -> np.ndarray:
        out = np.empty((len(texts), max_len), np.int32)
        blob = b"\x00".join(t.encode() for t in texts) + b"\x00"
        self.lib.wl_encode_batch(
            self.handle, blob, len(texts),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_len, pad_id)
        return out


def native_topk_ip(db: np.ndarray, queries: np.ndarray, db_codes: np.ndarray,
                   q_codes: np.ndarray, k: int):
    """Exact top-k inner product with same-study exclusion (FAISS replacement)."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native library unavailable")
    db = np.ascontiguousarray(db, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    db_codes = np.ascontiguousarray(db_codes, np.int64)
    q_codes = np.ascontiguousarray(q_codes, np.int64)
    q = queries.shape[0]
    out_idx = np.empty((q, k), np.int32)
    out_scores = np.empty((q, k), np.float32)
    lib.topk_ip(db.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), db.shape[0],
                db.shape[1], queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                q, db_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                q_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), k,
                out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out_scores, out_idx
