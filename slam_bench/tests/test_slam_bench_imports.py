"""Import guards: a run loads no module of JAX or of the JAX package
(top-level names compared whole: the port's own name begins with the
JAX package's), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from slam_bench.harness import core

BENCH = os.path.join(core.ROOT, "slam_bench")


def test_a_run_loads_no_jax_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from slam_bench.tests import small\n"
        "from slam_bench.harness import core\n"
        "small.run('vo_batch11.sweep', seconds=1.0)\n"
        "print('FOUND', core.forbidden_modules())\n"
        "print('PORT', 'aria_slam_tpu_torch' in sys.modules)\n" % core.ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
    assert "PORT True" in out.stdout  # the name check must not catch the port


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("aria_slam_tpu_torch_lookalike", sys)
    try:
        assert "aria_slam_tpu" not in core.forbidden_modules()
    finally:
        del sys.modules["aria_slam_tpu_torch_lookalike"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, name))}
            assert not tops & {"aria_slam_tpu_torch", "aria_slam_tpu", "jax", "flax"}, name
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import slam_bench.reference.compare, slam_bench.reference.yolo\n"
            "import slam_bench.reference.precision\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('aria')))"
            % core.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
