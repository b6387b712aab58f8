"""A run imports nothing of JAX or the JAX package (top-level names compared
whole), and the reference imports nothing of the port; without a card, or
without the port, the command prints no result and exits non-zero."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

from benchmark.cells import ROOT
from benchmark.run import FORBIDDEN

RUN_TINY = """
import json, sys, time, torch
sys.path.insert(0, {root!r})
from benchmark.run import run_cell, forbidden_modules
from benchmark.tests.tiny_cells import TINY_TRAIN, make_root
root = make_root({tmp!r})
run_cell(TINY_TRAIN, 11, 0.5, False, torch.device("cpu"), root=root, t_start=time.perf_counter())
print(json.dumps({{"forbidden": forbidden_modules(), "port": "dotaclient_tpu_torch" in sys.modules}}))
"""


def test_a_run_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", RUN_TINY.format(root=ROOT, tmp=str(tmp_path))], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"forbidden": [], "port": True}


def test_forbidden_names_compare_whole_top_level_names():
    assert "dotaclient_tpu" in FORBIDDEN and "dotaclient_tpu_torch" not in FORBIDDEN
    assert {"jax", "jaxlib", "flax", "optax", "orbax"} <= set(FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    ref_dir = os.path.join(ROOT, "benchmark", "reference")
    for path in glob.glob(os.path.join(ref_dir, "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("dotaclient_tpu_torch",) + FORBIDDEN, (path, n)
                if n.startswith("benchmark"):
                    assert n.startswith(("benchmark.reference",)), (path, n)
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.train; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('dotaclient_tpu_torch',) + %r))"
            % (ROOT, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "train_league5v5_lstm128",
                          "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "train_league5v5_lstm128",
                          "--seed", "7", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
