"""No module of the JAX package is loaded by a run, and the reference
loads nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from harness import runner

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def test_forbidden_names_are_compared_whole():
    names = ["audio_raytracer_tpu_torch", "audio_raytracer_tpu_torch.ops",
             "jaxtyping", "flaxen.x", "audio_raytracer_tpu.models", "jax",
             "jaxlib.xla_client", "flax"]
    assert runner.forbidden_modules(names) == [
        "audio_raytracer_tpu.models", "flax", "jax", "jaxlib.xla_client"]


RUN = """
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
from harness import runner
out = runner.run_cell("sample_scene.static_60hz", 7, 0.2, False,
                      device="cpu", root={broot!r}, overrides=dict(
                          config=dict(trace=dict(ray_count=32)),
                          traffic=dict(warmup_ticks=3, judged_frames=2)))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_module(bench_root):
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=ROOT, bench=BENCH_DIR,
                                          broot=bench_root)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "audio_raytracer_tpu_torch" in tops
    assert not tops & set(runner.FORBIDDEN)


def imports_of(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH_DIR, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in
                    imports_of(os.path.join(ref, name))}
            assert tops <= {"__future__", "math", "torch"}, (name, tops)
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{BENCH_DIR!r}]; "
         "import reference.frame; "
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        capture_output=True, text=True, timeout=300, cwd=BENCH_DIR)
    assert out.returncode == 0, out.stderr
    assert "audio_raytracer_tpu_torch" not in out.stdout
    assert "'jax'" not in out.stdout
