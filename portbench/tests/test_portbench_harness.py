"""The harness is driven by data, the manifest keeps the contract's
character rules, and nothing of the benchmark loads JAX or the JAX
package."""
import ast
import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, tiny_copy

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_new_config_cell_and_metric_take_files_only(tmp_path):
    root = tiny_copy(tmp_path)
    bench = root / "portbench"
    (bench / "configs" / "tiny-hpc.json").write_text(json.dumps(
        {"topology": {"builder": "fat_tree3", "k": 4, "pods": 4},
         "profile": "hpc", "params": {}, "reduced": ["topology"]}))
    (bench / "traffic" / "tiny-perm1-b2.json").write_text(json.dumps(
        {"generator": "permutations", "perms": 1, "packets": 8,
         "lanes": 2, "max_ticks": 256, "faults": None}))
    (bench / "metrics" / "driver.sweeps.py").write_text(
        "def read(ctx):\n"
        "    return len(ctx['horizons']) if ctx['shapes']['B'] == 2 "
        "else None\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "tiny-hpc.tiny-perm1-b2",
                           "config": "tiny-hpc", "traffic": "tiny-perm1-b2",
                           "chips": 1, "why": "added"})
    m["per_layer"].append({"name": "driver.sweeps", "unit": "sweeps",
                           "better": "higher", "source": "program_counter",
                           "layer": "driver",
                           "moves": "scenario_ticks_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    manifest = harness.load_manifest(root)
    cell = harness.Cell.load(bench, harness.workload_entry(
        manifest, "tiny-hpc.tiny-perm1-b2"))
    assert cell.config["profile"] == "hpc" and cell.lanes == 2
    res = harness.run_cell(root, "tiny-hpc.tiny-perm1-b2", 3, 0.1, True,
                           torch.device("cpu"), 0.0)
    assert res["correct"]
    assert res["metrics"]["driver.sweeps"] == {"value": 1.0,
                                               "unit": "sweeps"}
    # a reader with nothing to read in a cell leaves its metric out there
    other = harness.run_cell(root, "tiny-resilient.tiny-faults-b4", 3, 0.1,
                             True, torch.device("cpu"), 0.0)
    assert "driver.sweeps" not in other["metrics"]


def test_manifest_names_units_and_files():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    names += [w[k] for w in m["workloads"] for k in ("config", "traffic")]
    names += [r for c in m["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(x["unit"]) for k in ("end_to_end", "per_layer")
               for x in m[k])
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in m[k]]
        assert len(got) == len(set(got)), k
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in m["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
    for x in m["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{x['name']}.py"
                ).is_file()
        assert x["moves"] in {e["name"] for e in m["end_to_end"]}
    assert m["paths"] == ["portbench"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path


def test_the_reference_loads_nothing_of_jax_nor_of_either_package():
    code = ("import sys; sys.path[:0] = [{root!r}]\n"
            "import portbench.reference.fabric, portbench.reference.kops\n"
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))")
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=str(ROOT))], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    tops = set(eval(out))  # noqa: S307 - a list of names this test printed
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    import repro_torch  # noqa: F401 - its name begins with "repro"
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


@pytest.mark.parametrize("only_bench", [False, True])
def test_no_result_without_a_card(tmp_path, only_bench):
    """Without a card (here) the run exits non-zero and prints no result;
    so does a directory that holds only BENCHMARK.json and portbench/."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    root = ROOT
    if only_bench:
        shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        root = tmp_path
    r = subprocess.run([sys.executable, str(root / "portbench" / "run.py"),
                        "--workload", "ft1024-ai_full.perm2-b8", "--seed",
                        "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       cwd=root)
    assert r.returncode != 0
    assert not r.stdout.strip()
