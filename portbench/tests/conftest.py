"""Fixtures of the benchmark's tests: the paths the harness needs, a
card where one is present, and a copy of the benchmark that holds two
cells at a size the CPU runs in seconds (``data/``)."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = Path(__file__).resolve().parent / "data"
TINY = {"tiny-ai_full.tiny-perm2-b2": ("tiny-ai_full", "tiny-perm2-b2"),
        "tiny-resilient.tiny-faults-b4": ("tiny-resilient", "tiny-faults-b4")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def tiny_copy(dest: Path) -> Path:
    """The benchmark copied to ``dest``, with the test configurations and
    mixes of ``data/`` beside its own and a manifest of the tiny cells."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for kind in ("configs", "traffic"):
        for f in (DATA / kind).iterdir():
            shutil.copy(f, dest / "portbench" / kind / f.name)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["workloads"] = [
        {"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
        for n, (c, t) in TINY.items()]
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return tiny_copy(tmp_path_factory.mktemp("tiny"))
