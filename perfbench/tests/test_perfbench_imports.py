"""No module of the harness imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared by their
top level (before the first dot), whole: ssnt_tts_tpu_torch is not
ssnt_tts_tpu."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
EVERYWHERE = {"jax", "jaxlib", "flax", "optax", "ssnt_tts_tpu"}
REFERENCE = EVERYWHERE | {"ssnt_tts_tpu_torch"}


def top_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def banned(path: Path):
    return REFERENCE if "reference" in path.relative_to(HERE).parts \
        else EVERYWHERE


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_forbidden_import(path):
    assert not set(top_names(path)) & banned(path)


def imported(path: Path):
    """The full names of the modules that `path` imports, and of the names
    that its `from ... import` lines take from a package."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


# An architecture's modules (perfbench/arch.py): counts/<arch>.py beside
# the counts every architecture shares.
ARCHS = {p.stem for p in (HERE / "counts").glob("*.py")} - {"__init__",
                                                           "roofline"}
BY_NAME = {f"perfbench.{kind}.{a}" for a in ARCHS
           for kind in ("reference", "counts")}


@pytest.mark.parametrize("path", [p for p in MODULES if "tests" not in
                                  p.relative_to(HERE).parts],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_architecture_by_a_fixed_name(path):
    """Only perfbench/arch.py's lookup finds an architecture's modules."""
    own = {f"perfbench.{path.parent.name}.{path.stem}"}
    assert not (set(imported(path)) & BY_NAME) - own


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import ssnt_tts_tpu_torch.ops\nfrom jax import numpy\n")
    assert set(top_names(f)) == {"ssnt_tts_tpu_torch", "jax"}
    assert set(top_names(f)) & EVERYWHERE == {"jax"}


def test_span_files_name_no_jax_module():
    import json
    for p in (HERE / "spans").glob("*.json"):
        top = json.loads(p.read_text())["module"].split(".")[0]
        assert top not in EVERYWHERE
