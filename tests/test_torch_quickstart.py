"""The port's quickstart (``examples/quickstart_torch.py``) on the CPU
against the JAX package's: each section held here prints the block that
``examples/quickstart.py`` printed, byte for byte
(``tests/golden/torch_port_entry.npz``, written by
``scripts/torch_port_reference.py --which entry``).

The sections held on the CPU, chosen by their seconds here: [4] (the ROD
lane's in-order check through ``rx_base_per_tick`` as uint32), [6] (a
batch of four per-scenario profiles with INC), [8] (a flap and a gray
link under the recovery loop), [9] (a plan priced on the simulator:
the float seconds and tokens/s) and [10] (the probe rings). All twelve
are held on the card by ``chip_smoke.py`` phase 11 (a); the CPU runs the
plain PyTorch versions of the kernels.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
ENTRY = REPO / "tests" / "golden" / "torch_port_entry.npz"
HELD = (4, 6, 8, 9, 10)


@pytest.fixture(scope="module")
def quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", REPO / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def blocks() -> "dict[int, list[str]]":
    """The golden transcript's section blocks: section n's lines run from
    the blank line before ``[n] `` to the blank line before the next."""
    lines = [str(x) for x in np.load(ENTRY)["quickstart"]]
    heads = [i for i, ln in enumerate(lines) if ln.startswith("[")]
    ends = [h - 1 for h in heads[1:]] + [len(lines)]
    return {n: lines[h - 1:e]
            for n, (h, e) in enumerate(zip(heads, ends), start=1)}


def test_sections_and_header_are_the_references(quickstart, blocks):
    assert len(quickstart.SECTIONS) == len(blocks) == 12
    lines = [str(x) for x in np.load(ENTRY)["quickstart"]]
    assert lines[0] == quickstart.HEADER
    assert [quickstart.HEADER] + sum(blocks.values(), []) == lines


@pytest.mark.parametrize("n", HELD)
def test_section_prints_the_references_block(quickstart, blocks, n):
    assert quickstart.SECTIONS[n - 1]("cpu") == blocks[n]
