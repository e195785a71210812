"""The port stands alone: no file of ``src/repro_torch``, not
``chip_smoke.py``, not the port's examples (the transport tour
``examples/uet_transport_tour_torch.py``, the serving example
``examples/serve_decode_torch.py``, the training example
``examples/train_lm_torch.py``, the quickstart
``examples/quickstart_torch.py``, the telemetry tour
``examples/fabric_telemetry_torch.py``) and not its trace export
``scripts/trace_export_torch.py`` imports JAX or the reference package
(the machine with the card has no JAX), and importing the port loads no
JAX."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "examples" / "uet_transport_tour_torch.py",
    REPO / "examples" / "serve_decode_torch.py",
    REPO / "examples" / "train_lm_torch.py",
    REPO / "examples" / "quickstart_torch.py",
    REPO / "examples" / "fabric_telemetry_torch.py",
    REPO / "scripts" / "trace_export_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.convert, repro_torch.kernels.build\n"
            "import repro_torch.network.fabric\n"
            "import repro_torch.network.traffic, repro_torch.distributed.plan\n"
            "import repro_torch.distributed.netmodel\n"
            "import repro_torch.ckpt.checkpointing\n"
            "import repro_torch.core.addressing, repro_torch.core.headers\n"
            "import repro_torch.core.matching, repro_torch.core.messaging\n"
            "import repro_torch.core.pdc, repro_torch.core.pds\n"
            "import repro_torch.core.scatter, repro_torch.core.tss\n"
            "import repro_torch.core.types\n"
            "import repro_torch.models.layers, repro_torch.models.lm\n"
            "import repro_torch.serve.serve_step, repro_torch.launch.mesh\n"
            "import repro_torch.train.optimizer, repro_torch.train.trainer\n"
            "import repro_torch.train.train_step, repro_torch.tree\n"
            "import repro_torch.data.pipeline, repro_torch.launch.train\n"
            "import repro_torch.launch.roofline\n"
            "import repro_torch.distributed.compression\n"
            "import repro_torch.distributed.sharding\n"
            "import runpy\n"
            "runpy.run_path('examples/serve_decode_torch.py')\n"
            "runpy.run_path('examples/uet_transport_tour_torch.py')\n"
            "runpy.run_path('examples/train_lm_torch.py')\n"
            "runpy.run_path('examples/quickstart_torch.py')\n"
            "runpy.run_path('examples/fabric_telemetry_torch.py')\n"
            "runpy.run_path('scripts/trace_export_torch.py')\n"
            "import chip_smoke\n"
            "from repro_torch import configs\n"
            "[configs.get(n) for n in configs.ARCH_NAMES]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
