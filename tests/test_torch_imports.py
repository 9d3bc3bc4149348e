"""The port stands alone: nothing under src/repro_torch/ or tools/, not
chip_smoke.py and not the port's examples (examples/torch_*.py), imports
jax or the JAX package, and the port imports with jax made
unimportable."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
         + sorted((ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                raise AssertionError(f"{path}: relative import")
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    text = path.read_text()
    for needle in ("import jax", "from jax", "import repro.",
                   "from repro.", "from repro import"):
        assert needle not in text, f"{path.relative_to(ROOT)}: {needle!r}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch, repro_torch.bridge, repro_torch.launch.serve\n"
        "import repro_torch.serving, repro_torch.core\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.sparse_adamw\n"
        "import repro_torch.data, repro_torch.optim, repro_torch.runtime\n"
        "import repro_torch.training, repro_torch.launch.train\n"
        "import repro_torch.hub, repro_torch.hub.packio, repro_torch.hub.store\n"
        "import repro_torch.hub.serving, repro_torch.serving.kvcache\n"
        "import repro_torch.runtime.faults, repro_torch.kernels.flash_decode\n"
        "import repro_torch.kernels.flash_prefill, repro_torch.kernels.ref\n"
        "import repro_torch.kernels.masked_update, repro_torch.core.masks\n"
        "import repro_torch.runtime.ft, repro_torch.serving.loadgen\n"
        "import repro_torch.models.moe, repro_torch.launch.mesh\n"
        "import repro_torch.launch.sharding, repro_torch.launch.steps\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.actctx\n"
        "import repro_torch.analysis.profile\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
