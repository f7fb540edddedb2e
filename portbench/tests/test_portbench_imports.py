"""No JAX: the static imports of every file under portbench/, compared by
whole top-level names, and the reference free of the program too."""
import ast
import importlib.util
from pathlib import Path

import pytest

from portbench.harness import env

BENCH = Path(__file__).resolve().parents[1]


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"reader_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imported(path):
    assert not set(top_level_imports(path)) & set(env.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not set(top_level_imports(path)) & {"controlar_tpu_torch", "portbench"}


def test_whole_names_are_compared():
    assert env.forbidden_modules(["controlar_tpu_torch", "controlar_tpu_torch.models",
                                  "jaxtyping", "numpy"]) == []
    assert env.forbidden_modules(["controlar_tpu.models.gpt", "numpy"]) == ["controlar_tpu"]
    assert env.forbidden_modules(["jax.numpy", "flax"]) == ["flax", "jax"]


def test_a_tiny_run_loads_no_jax(tmp_path):
    """A whole run in a fresh process: its modules at the end."""
    import subprocess
    import sys

    from portbench.tests import tiny

    root = tiny.make_root(tmp_path)
    code = (
        "import sys; sys.path.insert(0, %r); from portbench import run; "
        "run.run(['--workload', 'gen.gptxl_t2i512.b32', '--seed', '3', '--seconds', '0.5'],"
        " require_cuda=False, root=__import__('pathlib').Path(%r)); "
        "from portbench.harness import env; print(env.forbidden_modules())"
    ) % (str(BENCH.parent), str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={k: v for k, v in __import__("os").environ.items()
                                           if k != "JAX_PLATFORMS"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_means_no_result():
    """Without the cards a cell asks for: exit code 3, nothing printed."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "gen.gpt3b_c2i384.b32", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300,
                         env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 3 and out.stdout.strip() == ""
