"""No module the benchmark runs is JAX or the JAX package, by whole top-level
name (the port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT
from pb import harness


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("evoke_tpu_torch_extra", "jaxtyping", "flaxen.sub"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(harness.forbidden_modules()) & {"evoke_tpu_torch_extra", "jaxtyping"}
    monkeypatch.setitem(sys.modules, "evoke_tpu.core", sys)
    assert "evoke_tpu" in harness.forbidden_modules()


def test_sources_import_no_jax():
    bad = []
    for d, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            for node in ast.walk(ast.parse(open(path).read())):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                         [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                bad += [(path, n) for n in names if n.split(".")[0] in harness.FORBIDDEN]
    assert not bad


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r, %r]\n"
            "from small import run_small\nrun_small('r2gen224.batch.lenmix', seconds=0.5)\n"
            "from pb.harness import forbidden_modules\nprint(forbidden_modules())\n"
            % (os.path.join(BENCH, "tests"), BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
