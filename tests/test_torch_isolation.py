"""The port stands alone: every module of ``src/repro_torch`` and
``chip_smoke.py`` imports with ``jax`` and ``repro`` blocked, and no
source file of the port names either in an import."""
import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_import_names_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.name}:{node.lineno} imports {name}")


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = list(_modules())
    assert "repro_torch.kernels.event_topk" in mods
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {mods!r}:\n"
        "    importlib.import_module(mod)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')"
        " and sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_chip_smoke_fails_without_a_gpu():
    """Without a GPU the script must exit non-zero and print no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
