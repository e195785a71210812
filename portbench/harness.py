"""The benchmark's machinery, found by name from ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``: the topology
builder and its arguments, the transport profile, the ``SimParams``) and
a traffic mix (``traffic/<traffic>.json``: a generator of ``traffic/``
and its parameters, the lanes B of a sweep and its tick budget). A
per-layer metric is a reader, ``metrics/<name>.py``. Adding any of them
takes new files and an entry in ``BENCHMARK.json``, and no edit here.

A run drives ``repro_torch.network.fabric.simulate_batch``, one call per
sweep of B scenario lanes, back to back for the window. Every sweep
draws its traffic, its LB seeds and its faults from ``(--seed, sweep
index)``. The same inputs, rebuilt from the same seeds, go to the plain
reference (``reference/``), which decides ``correct`` after the window
has closed: every lane of one sweep, drawn from the seed, bit for bit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
#: top-level module names a run must not have loaded when it ends: JAX,
#: and the JAX package the port was made from (``repro_torch`` is a
#: different name: names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory, NVIDIA's data sheet
GIB = 2 ** 30


# ------------------------------------------------------------ manifest --

def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload_entry(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in manifest['workloads']]}")


def load_module(path: Path):
    """A file of the benchmark as a module of its own (its name may hold
    dots, so it is loaded by path, not imported by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass(frozen=True)
class Cell:
    """One cell: its configuration and its traffic mix, as files."""

    name: str
    config: dict
    mix: dict
    bench: Path

    @staticmethod
    def load(bench: Path, entry: dict) -> "Cell":
        read = lambda kind, n: json.loads(  # noqa: E731
            (bench / kind / f"{n}.json").read_text())
        return Cell(entry["name"], read("configs", entry["config"]),
                    read("traffic", entry["traffic"]), bench)

    @property
    def lanes(self) -> int:
        return int(self.mix["lanes"])

    @property
    def max_ticks(self) -> int:
        return int(self.mix["max_ticks"])

    def generator(self, name: str):
        return load_module(self.bench / "traffic" / f"{name}.py")

    def topology(self):
        """The reference's topology of the configuration: the hosts, pods
        and uplinks that the generators draw from."""
        from portbench.reference import topology
        cfg = dict(self.config["topology"])
        return getattr(topology, cfg.pop("builder"))(**cfg)


# -------------------------------------------------------------- inputs --

def sweep_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of sweep ``index`` of a run with ``--seed``: any
    whole number, taken modulo 2**64."""
    return np.random.default_rng([int(seed) % 2 ** 64, int(index)])


def sweep_inputs(cell: Cell, topo, seed: int, index: int) -> dict:
    """Sweep ``index``'s inputs as plain numpy arrays: the flows (one
    workload for every lane), the B LB seeds and the fault lanes (None
    for a healthy sweep). ``topo`` is the reference's topology, which
    names the hosts, pods and uplinks the generators draw from."""
    rng = sweep_rng(seed, index)
    mix = cell.mix
    flows = cell.generator(mix["generator"]).generate(rng, topo, mix)
    seeds = rng.integers(0, 2 ** 32, size=cell.lanes, dtype=np.uint64)
    faults = None
    if mix.get("faults"):
        spec = mix["faults"]
        faults = cell.generator(spec["generator"]).generate(
            rng, topo, cell.lanes, spec)
    return {"flows": flows, "seeds": seeds.astype(np.uint32),
            "faults": faults}


FAULT_LANES = ("fail_at", "heal_at", "loss_p", "corrupt_p", "seed",
               "host_fail_at", "host_heal_at", "nic_stall_at", "nic_heal_at")


class Engine:
    """One implementation of the fabric engine at a cell's
    configuration: the program (``repro_torch.network``) or the
    reference (``portbench.reference``), which share the API. Each builds
    its own topology and routing tables from the configuration."""

    def __init__(self, mods: dict, config: dict, device: torch.device):
        self.mods, self.device = mods, device
        topo = dict(config["topology"])
        self.g = getattr(mods["topology"], topo.pop("builder"))(**topo)
        self.profile = getattr(mods["profile"].TransportProfile,
                               config["profile"])()
        self.params = mods["fabric"].SimParams(**config["params"])

    def sweep(self, inputs: dict, lanes: int, max_ticks: int,
              trace: str = "stats") -> list:
        fab, dev = self.mods["fabric"], self.device
        f = inputs["flows"]
        wl = fab.Workload.of(f["src"], f["dst"], f["size"], device=dev)
        faults = None
        if inputs["faults"] is not None:
            lanes_ = {k: np.ascontiguousarray(inputs["faults"][k])
                      for k in FAULT_LANES}
            lanes_["seed"] = lanes_["seed"].astype(np.uint32).view(np.int32)
            faults = self.mods["faults"].FaultSchedule(
                **{k: torch.as_tensor(v).to(dev) for k, v in lanes_.items()})
        return fab.simulate_batch(
            self.g, fab.Workload.stack([wl] * lanes), self.profile,
            self.params, faults=faults, seeds=inputs["seeds"],
            trace=trace, max_ticks=max_ticks, device=dev)


def program_modules() -> dict:
    from repro_torch.network import fabric, faults, profile, topology
    return {"fabric": fabric, "faults": faults, "profile": profile,
            "topology": topology}


def reference_modules() -> dict:
    from portbench.reference import fabric, faults, profile, topology
    return {"fabric": fabric, "faults": faults, "profile": profile,
            "topology": topology}


# ------------------------------------------------------------- outputs --

STATS = ("stat_completion", "stat_src_completion", "stat_win_delivered",
         "qlen_peak", "stat_abandon_tick")


def _leaves(obj, path: str, out: dict) -> None:
    if isinstance(obj, torch.Tensor):
        out[path] = obj.detach().cpu().numpy()
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _leaves(getattr(obj, f.name), f"{path}.{f.name}", out)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _leaves(obj[k], f"{path}.{k}", out)


def lane_outputs(results: list) -> list:
    """Each lane's outputs on the host: its horizon, its stats and every
    lane of its final state ({path: numpy array})."""
    out = []
    for r in results:
        lane = {"horizon": np.asarray(r.horizon, np.int64)}
        for k in STATS:
            lane[k] = np.asarray(getattr(r, k))
        _leaves(r.state, "state", lane)
        out.append(lane)
    return out


def _differing(a: np.ndarray, b: np.ndarray) -> int:
    """Elements of ``a`` whose bits differ from ``b``'s (all of ``b``'s
    where dtype or shape differ)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return max(int(b.size), 1)
    if a.dtype.kind == "f":
        a, b = (x.view(f"i{x.itemsize}") for x in (a, b))
    return int(np.count_nonzero(a != b))


def compare(got: list, want: list) -> dict:
    """The program's lanes against the reference's, key by key of the
    reference: elements and horizons that differ, and where."""
    elements = horizons = lanes = 0
    where: dict = {}
    for b, (g, w) in enumerate(zip(got, want, strict=True)):
        lane = 0
        for k, wv in w.items():
            n = (max(int(wv.size), 1) if k not in g
                 else _differing(np.asarray(g[k]), wv))
            if n:
                lane += n
                where[f"lane{b}:{k}"] = n
        elements += lane
        lanes += int(lane > 0)
        horizons += int(int(g["horizon"]) != int(w["horizon"]))
    return {"elements_differing": elements, "horizons_differing": horizons,
            "lanes_differing": lanes, "where": where}


#: each number that ``correct`` compares, and its limit: an exact
#: comparison (a lane's horizon is one of its elements)
LIMITS = {"elements_differing": 0}


# ---------------------------------------------------------- the device --

def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_kernels(dev: torch.device) -> None:
    """Load every kernel library of the port (built once per checkout,
    into its ``build/`` directory), so no build falls in the window."""
    if dev.type != "cuda":
        return
    from repro_torch.kernels import build
    build.build_all()
    for name in build.SIGNATURES:
        build.load(name)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


# ------------------------------------------------------------- the run --

def run_window(cell: Cell, prog: Engine, topo, seed: int, seconds: float,
               dev: torch.device) -> dict:
    """Sweeps back to back until ``seconds`` have passed, the last one
    finished. Returns the window's wall time, its peak device memory,
    the kernel launches in it and each sweep's lane outputs."""
    from repro_torch.kernels import ops
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    sweeps, ends = [], []
    t0 = time.perf_counter()
    while True:
        inputs = sweep_inputs(cell, topo, seed, len(sweeps))
        rs = prog.sweep(inputs, cell.lanes, cell.max_ticks)
        sweeps.append(lane_outputs(rs))      # ends in a copy to the host
        del rs
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    return {"window_s": window_s, "peak_bytes": int(peak),
            "launches": int(sum(ops.LAUNCHES.values())),
            "sweep_s": np.diff([0.0] + ends).tolist(),
            "horizons": [[int(lane["horizon"]) for lane in s]
                         for s in sweeps],
            "outputs": sweeps}


def check(cell: Cell, ref: Engine, topo, seed: int, window: dict) -> dict:
    """Every lane of one sweep of the window, drawn from the seed,
    against the reference run on the same inputs."""
    k = int(np.random.default_rng([int(seed) % 2 ** 64, 2 ** 32])
            .integers(len(window["outputs"])))
    t0 = time.perf_counter()
    inputs = sweep_inputs(cell, topo, seed, k)
    want = lane_outputs(ref.sweep(inputs, cell.lanes, cell.max_ticks))
    res = compare(window["outputs"][k], want)
    res.update(sweep=k, lanes=len(want), seconds=time.perf_counter() - t0)
    return res


def trace_stretch(cell: Cell, prog: Engine, topo, seed: int,
                  window: dict, dev: torch.device) -> dict:
    """The window's first sweep again, under ``torch.profiler``: each
    device operation's name and interval, the sweep's group ticks (its
    largest horizon), its wall time traced and, from the window,
    untraced. Only the device's activity is recorded: the host's
    operations would triple the events of a whole sweep, and the time to
    read them."""
    inputs = sweep_inputs(cell, topo, seed, 0)
    acts = ([torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda"
            else [torch.profiler.ProfilerActivity.CPU])
    with torch.profiler.profile(activities=acts) as prof:
        sync(dev)
        t0 = time.perf_counter()
        rs = prog.sweep(inputs, cell.lanes, cell.max_ticks)
        sync(dev)
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    ticks = max(r.horizon for r in rs)
    del rs
    cpu = torch.autograd.DeviceType.CPU
    device = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() != cpu]
    print(f"trace: traced sweep {wall:.3f} s, profiler stop "
          f"{t1 - t0 - wall:.3f} s, {len(device)} device events read in "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    return {"ticks": ticks, "wall_s": wall,
            "plain_wall_s": window["sweep_s"][0],
            "flows": int(inputs["flows"]["src"].size), "device": device}


def busy_intervals(device: list) -> list:
    """The union of the device operations' [start, end) intervals (ns),
    in order."""
    merged: list = []
    for _, s, e in sorted(device, key=lambda r: r[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(device: list) -> float:
    return sum(e - s for s, e in busy_intervals(device)) / 1e9


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time, and the idle gaps
    summed by the device operation that ended them: what the host was
    preparing while the device waited (the ten largest sums)."""
    by_op: dict = {}
    for name, s, e in trace["device"]:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e9
    by_gap: dict = {}
    end = None
    for name, s, e in sorted(trace["device"], key=lambda r: r[1]):
        if end is not None and s > end:
            key = f"before {name}"
            by_gap[key] = by_gap.get(key, 0.0) + (s - end) / 1e9
        end = e if end is None else max(end, e)
    top = lambda d: [[k[:200], v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def shapes(cell: Cell, prog: Engine, topo, flows: int) -> dict:
    """The tick's shapes, which the byte counts of the metric readers
    take: B lanes, F flows, W ring words, Q queues, the NACK lanes a
    scenario hands the mark (Q + 2F), and the routing tables' entries."""
    F = int(flows)
    tables = {n: int(np.asarray(getattr(topo, a)).size) for n, a in (
        ("stage", "stage"), ("next_switch", "queue_next_switch"),
        ("host_leaf", "host_leaf"), ("host_queue", "host_queue"),
        ("host_pod", "host_pod"), ("up1", "up1_table"),
        ("down1", "down1_table"), ("up2", "up2_table"),
        ("down2", "down2_table"))}
    Q = int(topo.num_queues)
    return {"B": cell.lanes, "F": F, "W": int(prog.params.mp_range) // 32,
            "Q": Q, "L": Q + 2 * F, "tables": tables}


def read_metrics(bench: Path, metrics: list, ctx: dict) -> dict:
    """Each per-layer metric from its reader; a reader that finds nothing
    to read returns None and its metric is left out."""
    out = {}
    for m in metrics:
        v = load_module(bench / "metrics" / f"{m['name']}.py").read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             dev: torch.device, t_start: float) -> dict:
    """One run of the cell ``name``: set-up, the window, the traced
    stretch (``trace``), then the check against the reference. Returns
    the result line (without the check of loaded modules)."""
    stages = {"imports": time.perf_counter() - t_start}
    manifest = load_manifest(root)
    entry = workload_entry(manifest, name)
    bench = root / BENCH.name
    cell = Cell.load(bench, entry)
    topo = cell.topology()
    stages["fat tree"] = time.perf_counter() - t_start
    load_kernels(dev)
    stages["kernels"] = time.perf_counter() - t_start
    prog = Engine(program_modules(), cell.config, dev)
    stages["engine"] = time.perf_counter() - t_start
    # warm-up: one chunk of the first sweep at the cell's own shapes
    prog.sweep(sweep_inputs(cell, topo, seed, 0), cell.lanes,
               int(prog.params.chunk_ticks))
    sync(dev)
    setup_s = time.perf_counter() - t_start
    stages["warm-up"] = setup_s
    print("set-up, seconds from the start to the end of each stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()),
          file=sys.stderr)

    window = run_window(cell, prog, topo, seed, seconds, dev)
    metrics = {}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": window["peak_bytes"]}
    out: dict = {}
    if not trace:
        useful = sum(sum(h) for h in window["horizons"])
        values = {"scenario_ticks_per_s": useful / window["window_s"],
                  "peak_mem_gib": window["peak_bytes"] / GIB,
                  "setup_s": setup_s}
        for m in manifest["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        stretch = trace_stretch(cell, prog, topo, seed, window, dev)
        ctx = {"horizons": window["horizons"],
               "launches": window["launches"], "trace": stretch,
               "shapes": shapes(cell, prog, topo, stretch["flows"]),
               "hbm_bytes_per_s": HBM_BYTES_PER_S}
        metrics = read_metrics(bench, manifest["per_layer"], ctx)
        dev_info["busy_s"] = busy_seconds(stretch["device"])
        dev_info["window_s"] = stretch["wall_s"]
        out["breakdown"] = breakdown(stretch)
    del prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = Engine(reference_modules(), cell.config, dev)
    verdict = check(cell, ref, topo, seed, window)
    checks = {k: {"value": verdict[k], "limit": lim}
              for k, lim in LIMITS.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct,
            "attempted": len(window["horizons"]) * cell.lanes,
            "failed": verdict["lanes_differing"],
            "metrics": metrics, "device": dev_info, **out,
            "window": {"seconds": window["window_s"],
                       "sweep_s": window["sweep_s"],
                       "horizons": window["horizons"]},
            "check": {"sweep": verdict["sweep"], "lanes": verdict["lanes"],
                      "horizons_differing": verdict["horizons_differing"],
                      "reference_s": verdict["seconds"],
                      "where": dict(list(verdict["where"].items())[:20])},
            "checks": checks}
