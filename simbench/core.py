"""One run of one cell: set-up, the measured window, the output check and
the result line.

Everything a cell is made of is found by name under ``simbench/``: the
cell (``workloads/<name>.json``: its configuration, its traffic mix, the
sample it checks and the limits of the numbers it compares), the
configuration (``configs/``), the traffic mix (``traffic/``), the port's
side of the configuration's experiment (``experiments/``) and the plain
reference's (``reference/``), each per-layer metric's reader
(``metrics/<metric>.py``) and each kernel's count (``counts/``).

An experiment's module (``experiment``) owns what its traffic units do.
The port's side has ``Program(config, device, dtype, **made)`` with
``frames``, ``rollout(draws, span) -> (spec, lanes-first trajectory)``
and, for a fit, ``fit_state(traffic, targets, starts, span) -> state``
(a dict holding the targets' trajectory under ``"target"``, the
parameters and the optimizer's state) and ``fit_step(state, span) ->
(spec, trajectory, answers)`` (per lane ``loss``, ``grad``, ``param``);
the reference has ``Reference(config, device, **made)`` with
``rollout(draws)`` and ``fit_step(traffic, targets, starts)``, which
return the same.
"""

from __future__ import annotations

import concurrent.futures as cf
import importlib
import importlib.util
import json
import multiprocessing
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import compare, inputs, tracing

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diffsdfsim_tpu")
PROGRAM_THREADS = 1  # the host's threads while the program runs: one process, few threads
REFERENCE_THREADS = 4  # the reference's threads in the run's own process, once the window has closed
REFERENCE_WORKERS = 8  # a fit's CPU reference: worker processes of one thread, one sampled lane each
TIE_EPS = 1e-13  # the relative change of a lane's start at which the reference looks for a contact tie
PROFILE_ON_S, PROFILE_EVERY_S = 2.0, 5.0  # the traced unit's profiled slices
WARM_UP = -1  # the unit index of a rollout's warm-up draws
MIN_TRACE_UNITS = 2  # profiled in slices, sync-counted


def read_json(path) -> dict:
    return json.loads(Path(path).read_text())


def find(root: Path, kind: str, name: str, suffix: str = ".json") -> Path:
    path = Path(root) / kind / f"{name}{suffix}"
    if not path.is_file():
        raise LookupError(f"no {kind} entry named {name!r} ({path})")
    return path


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def experiment(side: str, config: dict, unit: str):
    """The module of the configuration's experiment on one side
    (``experiments``: the port's; ``reference``: the plain reference's) for
    a traffic unit: ``<experiment>_<unit>`` where a cell added one (a fit
    of an experiment whose module runs rollouts only, say), else
    ``<experiment>``."""
    for name in (f"{config['experiment']}_{unit}", config["experiment"]):
        if importlib.util.find_spec(f"simbench.{side}.{name}") is not None:
            return importlib.import_module(f"simbench.{side}.{name}")
    raise LookupError(f"no module simbench.{side}.{config['experiment']}")


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Cell:
    """A workload of ``BENCHMARK.json`` and the files it names."""

    def __init__(self, name: str, bench: dict | None = None, root: Path = ROOT):
        self.root = Path(root)
        self.bench = read_json(REPO / "BENCHMARK.json") if bench is None else bench
        entry = [w for w in self.bench["workloads"] if w["name"] == name]
        if not entry:
            raise LookupError(f"BENCHMARK.json has no workload {name!r}")
        self.entry = entry[0]
        self.name = name
        self.workload = read_json(find(self.root, "workloads", name))
        for key in ("config", "traffic"):
            if self.workload[key] != self.entry[key]:
                raise ValueError(f"{name}: BENCHMARK.json names {key} {self.entry[key]!r}, the workload file "
                                 f"{self.workload[key]!r}")
        self.config = read_json(find(self.root, "configs", self.entry["config"]))
        self.traffic = read_json(find(self.root, "traffic", self.entry["traffic"]))
        self.end_to_end = [m for m in self.bench["end_to_end"] if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.bench["per_layer"]
                          if name in m.get("workloads", [name]) and m["moves"] in moved]

    def reader(self, metric: str):
        return load_file(find(self.root, "metrics", metric, ".py"), "simbench_metric_" + metric.replace(".", "_"))

    def counts(self) -> dict:
        """The count modules of the kernels this cell's roofline metrics read."""
        out = {}
        for m in self.per_layer:
            mod = getattr(self.reader(m["name"]), "KERNEL_COUNT", None)
            if mod:
                out[mod] = load_file(find(self.root, "counts", mod, ".py"), f"simbench.counts.{mod}")
        return out


class Record:
    """What the traced run read, for the metric readers."""

    def __init__(self, cell: Cell, peaks: dict):
        self.cell, self.peaks = cell, peaks
        self.units = []  # per unit: wall, lane steps, substeps, launches, spans, syncs
        self.profile = None  # the profiled slices: device events, windows, launch sizes, spans
        self.peak_window_bytes = None

    def roofline(self, kid: str):
        """The percentage of its least time that the kernel ``kid`` took in
        the profiled unit (None where it ran no launch there)."""
        p = self.profile
        if p is None or not p["sizes"].get(kid):
            return None
        cm = p["counts"][kid]
        least = 0.0
        for s in p["sizes"][kid]:
            ops, nbytes = cm.count(s)
            least += max(ops / self.peaks["flops"][cm.PEAK], nbytes / self.peaks["hbm_bytes_per_s"])
        device = sum(sec for name, sec in p["kernel_s"].items() if cm.KERNEL in name)
        return 100.0 * least / device if device > 0 else None


def window(step, seconds: float, min_units: int = 1, clock=time.perf_counter):
    """The measured window of a closed loop: ``step(u)`` runs unit u to its
    end; a unit starts only before ``seconds`` have passed (and at least
    ``min_units`` run), the one in flight finishes and counts. Returns
    (units, window start, end of the last unit): the rate is taken over all
    of that time."""
    t0 = clock()
    u = 0
    while u < min_units or clock() - t0 < seconds:
        step(u)
        u += 1
    return u, t0, clock()


def sample_lanes(seed: int, lanes: int, n: int) -> list:
    """``n`` lanes (at most all of them) drawn from the seed, spread over as
    many equal parts of the batch (one from each half for n = 2)."""
    rng = np.random.default_rng(inputs.stream_seed(seed, 3))
    n = min(n, lanes)
    edges = [round(i * lanes / n) for i in range(n + 1)]
    return [int(rng.integers(edges[i], max(edges[i + 1], edges[i] + 1))) for i in range(n)]


def lanes_of(traj, idx):
    return type(traj)(*(t[idx] for t in traj))


def to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(to_cpu(v) for v in x))
    return x


def made_inputs(config: dict, device) -> dict:
    """Inputs the configuration needs beyond the draws: a decoder's weights."""
    if "decoder" not in config:
        return {}
    w, b, codes = inputs.decoder_weights(config, device)
    return dict(weights=w, biases=b, codes=codes)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def warm_forward_ad(device, dtype):
    """torch's first forward-mode product through a matrix product imports
    ``torch._dynamo`` and registers the JVP decompositions (some 840
    modules). A fit's backward takes one (the TOC backward's
    ``torch.func.jvp``), so a fit's set-up pays that here, on a 3x3
    product, and not its first iteration."""
    h = torch.zeros(2, device=device, dtype=dtype)
    a = torch.eye(3, device=device, dtype=dtype).expand(2, 3, 3)
    torch.func.jvp(lambda x: (a * x[:, None, None]) @ a, (h,), (torch.ones_like(h),))
    sync(device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, device=None, dtype=None,
        overrides: dict | None = None):
    """One run: the program's set-up and window, then the output check.
    Returns (result dict, check rows, run info)."""
    result, job, info = run_program(cell, seed, seconds, trace, t_start, device, dtype, overrides)
    t_ref = time.perf_counter()
    numbers, notes = check_in_workers(job)
    info["reference_s"] = time.perf_counter() - t_ref
    info.update(notes)
    return finish(cell, result, numbers) + (info,)


def finish(cell: Cell, result: dict, numbers: dict):
    """The result with ``correct`` and ``checks`` filled in, and the rows."""
    correct, rows = compare.judge(numbers, cell.workload["limits"])
    result["correct"] = correct
    result["checks"] = {k: dict(value=v, limit=lim) for k, v, lim in rows}
    return result, rows


def check_in_workers(job: dict):
    """``check(job)``: a fit's lanes on the CPU each in a worker process of
    one thread (``REFERENCE_WORKERS``, all stopped before it returns), any
    other reference in this process."""
    n = min(REFERENCE_WORKERS, len(job["sample"]))
    if job["traffic"]["unit"] != "fit" or job["reference_device"] != "cpu" or n <= 1:
        return check(dict(job, threads=REFERENCE_THREADS))
    with cf.ProcessPoolExecutor(n, mp_context=multiprocessing.get_context("spawn")) as pool:
        return check(dict(job, threads=1), pool.map)


def check(job: dict, map_=map):
    """(numbers the comparison reads, notes): the plain reference run over
    the job's sampled lanes and set beside the program's answers. ``job``
    holds only plain data and CPU tensors, so that worker processes can
    take its parts; ``map_`` runs the reference's jobs (a pool's ``map``).

    A fit's lanes are independent worlds, so each sampled lane is a job of
    its own. A lane whose loss, gradient or stepped parameter misses its
    limit is run again at its start times 1 +- ``TIE_EPS``; where the
    reference's own loss or gradient moves there by more than its limit, a
    contact tie decides it (``notes['ties']``): that lane's loss is held
    against the nearest of the reference's three readings, and its gradient
    and parameter are left out."""
    if job["traffic"]["unit"] != "fit":
        (ref,) = map_(reference_rollout, [dict(job, lanes=job["sample"])])
        return compare.trajectory_gaps(job["program"], ref), {}
    sample, limits, prog = job["sample"], job["limits"], job["program"]
    ref = cat(list(map_(reference_fit, [dict(job, lanes=[lane], scale=[1.0]) for lane in sample])))
    gaps = compare.fit_lane_gaps(prog, ref)
    over = [i for i in range(len(sample)) if any(gaps[k][i] > limits[k] for k in ("loss", "grad", "param"))]
    moved = list(map_(reference_fit, [dict(job, lanes=[sample[i]] * 2, scale=[1.0 + TIE_EPS, 1.0 - TIE_EPS])
                                      for i in over]))
    moves, ties = {}, {}
    for i, r in zip(over, moved):
        moves[sample[i]] = {k: float(compare.relative(r[k], ref[k][i:i + 1]).max()) for k in ("loss", "grad")}
        if any(moves[sample[i]][k] > limits[k] for k in ("loss", "grad")):
            ties[i] = r["loss"]
    return compare.fit_gaps(prog, ref, ties), dict(ties=[sample[i] for i in ties], tie_moves=moves)


def cat(parts: list) -> dict:
    """The reference's per-lane answers joined along the lanes."""
    out = {k: torch.cat([p[k] for p in parts]) for k in parts[0] if k != "target"}
    out["target"] = compare.Traj(*(torch.cat(x) for x in zip(*(p["target"] for p in parts))))
    return out


def _reference(job: dict):
    if "threads" in job:
        torch.set_num_threads(job["threads"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mod = experiment("reference", job["config"], job["traffic"]["unit"])
    return mod.Reference(job["config"], device=job["reference_device"], **job["made"])


def _select(d: dict, lanes, scale=None) -> dict:
    out = {k: v[lanes] for k, v in d.items()}
    if scale is not None:
        s = torch.tensor(scale, dtype=torch.float64)
        out = {k: v * s.view((-1,) + (1,) * (v.dim() - 1)) if v.is_floating_point() else v for k, v in out.items()}
    return out


def reference_fit(job: dict) -> dict:
    """The reference's fit iteration over the lanes ``job['lanes']``, each
    lane's start draws times its ``job['scale']`` (CPU tensors)."""
    config, traffic, seed = job["config"], job["traffic"], job["seed"]
    r = _reference(job).fit_step(traffic, _select(inputs.draws(config, traffic, seed, "target"), job["lanes"]),
                                 _select(inputs.draws(config, traffic, seed, "start"), job["lanes"], job["scale"]))
    return to_cpu(dict(r, target=compare.plain(r["target"])))


def reference_rollout(job: dict):
    """The reference's rollout of the lanes ``job['lanes']`` of the checked
    unit's draws (CPU tensors)."""
    config, traffic = job["config"], job["traffic"]
    r = _reference(job).rollout(_select(inputs.draws(config, traffic, job["seed"], "lanes", job["unit"]),
                                        job["lanes"]))
    return to_cpu(compare.plain(r))


def run_program(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, device=None, dtype=None,
                overrides: dict | None = None):
    """The program's part of a run: set-up, the window and the reading of
    its trace. Returns (result without ``correct``, the check's job, run
    info). ``device`` None means the card; ``dtype`` the program's (the
    configuration's when None; the reference always runs in the
    configuration's); ``overrides`` merge into the configuration (the CPU
    tests' small sizes)."""
    config = dict(cell.config, **(overrides or {}))
    traffic = cell.traffic
    device = torch.device("cuda" if device is None else device)
    torch.set_num_threads(PROGRAM_THREADS)
    dtype = dtype or getattr(torch, config["dtype"])
    exp = experiment("experiments", config, traffic["unit"])
    if device.type == "cuda":
        from diffsdfsim_torch.ops import _build

        _build.build_all(exp.KERNELS[traffic["unit"]])
        for k in exp.KERNELS[traffic["unit"]]:
            _build.load(k)
    made = made_inputs(config, device)
    program = exp.Program(config, device, dtype, **made)
    lanes, frames = config["lanes"], program.frames
    sample = sample_lanes(seed, lanes, cell.workload["sample"]["lanes"])
    idx = torch.tensor(sample, device=device)
    peaks = read_json(cell.root / "peaks.json")
    rec = Record(cell, peaks)
    counts = cell.counts() if trace else {}
    sizes = tracing.LaunchSizes(counts)
    spans = tracing.Spans()
    tracer = tracing.SlicedTrace(sizes, PROFILE_ON_S, PROFILE_EVERY_S)
    ticking = [False]

    def tick():
        if ticking[0]:
            tracer.tick()

    patches = (tracing.fine_spans(spans, tick) + sizes.patches()) if trace else []

    unit_kind = traffic["unit"]
    state, checked = {}, {}
    if unit_kind == "fit":
        warm_forward_ad(device, dtype)
        # the experiment's own fit state: the targets (which the traffic
        # needs), the parameters and the optimizer's state
        state = program.fit_state(traffic, inputs.draws(config, traffic, seed, "target"),
                                  inputs.draws(config, traffic, seed, "start"), tracing.no_spans)
        checked["target"] = lanes_of(state["target"], idx)
    else:
        # one unit of warm-up draws: every shape of the window's units is
        # built, allocated and loaded in set-up
        program.rollout(inputs.draws(config, traffic, seed, "lanes", WARM_UP), tracing.no_spans)
    kept = []  # per rollout unit: the sampled lanes' answers (device)
    launch_counts = None
    if device.type == "cuda":
        from diffsdfsim_torch.parallel import launch_counts

    def one_unit(u, span):
        if unit_kind == "fit":
            spec, traj, ans = program.fit_step(state, span)
            if u == 0:  # the first iteration, from the start draws, is the one checked
                checked.update({k: v[idx] for k, v in ans.items()})
        else:
            spec, traj = program.rollout(inputs.draws(config, traffic, seed, "lanes", u), span)
            kept.append(lanes_of(traj, idx))
        return spec, traj

    sync(device)
    memory_setup = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    launches0 = launch_counts() if launch_counts else {}
    finite = []

    def step(u):
        before = launch_counts() if launch_counts else {}
        first_span = len(spans.done)
        syncs = None
        tu = time.perf_counter()
        if trace and u == 0:
            ticking[0] = True
            tracer.tick()
            spec, traj = one_unit(u, tracing.traced_spans(spans, tracer))
            ticking[0] = False
            if tracer.prof is not None:
                tracer._stop()
        elif trace and u == 1:
            (spec, traj), syncs = tracing.count_syncs(lambda: one_unit(u, spans))
        else:
            spec, traj = one_unit(u, spans if trace else tracing.no_spans)
        sync(device)
        walls.append(time.perf_counter() - tu - (tracer.paused(0, time.time_ns()) if trace and u == 0 else 0.0))
        last.update(spec=spec, traj=traj)
        finite.append(torch.isfinite(traj.pos.detach()).flatten(1).all(1).sum())
        if trace:
            after = launch_counts() if launch_counts else {}
            rec.units.append(dict(
                wall=walls[-1], lane_frames=lanes * frames, frames=frames,
                valid_substeps=int(traj.valid.sum()), spec_substeps=spec.stages["substep"],
                launches=sum(after[k] - before.get(k, 0) for k in after), syncs=syncs,
                spans=[(n, a, b, d, tracer.paused(a, b)) for n, a, b, d in spans.done[first_span:]]))
            if u == 0:
                tracer.close()
                rec.profile = dict(events=tracer.events, windows=tracer.slices, counts=counts,
                                   kernel_s=tracing.kernel_seconds(tracer.events),
                                   sizes={k: list(v) for k, v in sizes.sizes.items()},
                                   spans=spans.done[first_span:])

    last, walls = {}, []
    with tracing.patched(patches):
        n_units, t0, t_end = window(step, seconds, MIN_TRACE_UNITS if trace else 1)
    setup_s = t0 - t_start
    spec, traj = last["spec"], last["traj"]
    elapsed = t_end - t0
    mem_window = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    rec.peak_window_bytes = mem_window
    launches = {k: v - launches0.get(k, 0) for k, v in (launch_counts() if launch_counts else {}).items()}
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    attempted = n_units * lanes
    failed = attempted - int(sum(int(f) for f in finite))

    # the sample the reference checks, on the CPU; the program's state freed
    rng = np.random.default_rng(inputs.stream_seed(seed, 4))
    if unit_kind == "fit":
        checked_unit = 0
        prog_out = to_cpu(checked)
        prog_out["target"] = compare.plain(prog_out["target"])
    else:
        checked_unit = int(rng.integers(0, n_units))
        prog_out = compare.plain(to_cpu(kept[checked_unit]))
    made_cpu = {k: [to_cpu(x).to(torch.float64) for x in v] if isinstance(v, list) else to_cpu(v).to(torch.float64)
                for k, v in made.items()}
    del kept, state, checked, program, spec, traj, made
    last.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # the configuration names where its reference runs; a run on the CPU keeps it there
    ref_device = config["reference_device"] if device.type == "cuda" else "cpu"
    job = dict(config=config, traffic=traffic, seed=seed, sample=sample, unit=checked_unit, made=made_cpu,
               program=prog_out, reference_device=ref_device, limits=cell.workload["limits"])

    metrics = {}
    if not trace:
        values = dict(lane_steps_per_s=lanes * frames * n_units / elapsed, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    else:
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
               count=1, memory_peak_bytes=max(memory_setup, mem_window))
    result = dict(correct=None, attempted=attempted, failed=failed, metrics=metrics, device=dev)
    if trace and rec.profile is not None:
        p = rec.profile
        busy, gaps = tracing.busy_and_gaps(p["events"], p["windows"])
        dev.update(busy_s=busy, window_s=sum(b - a for a, b in p["windows"]) / 1e9)
        top = sorted(tracing.kernel_seconds(p["events"]).items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(tracing.label_gaps(gaps, p["spans"]).items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = dict(device_ops=[[k, v] for k, v in top], idle_gaps=[[k, v] for k, v in idle])
    rec.profile = None  # the trace's events, freed before the reference runs
    info = dict(units=n_units, window_s=elapsed, setup_s=setup_s, unit_walls=walls, lanes_checked=sample,
                unit_checked=checked_unit, launches=launches)
    return result, job, info


class ForbiddenImport(RuntimeError):
    pass


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="One run of one benchmark cell of diffsdfsim_torch.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Cell(args.workload)
    except (LookupError, FileNotFoundError, ValueError) as e:
        print(f"simbench: {e}", file=sys.stderr)
        return 2
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"simbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    try:
        result, rows, info = run(cell, args.seed, args.seconds, bool(args.trace), t_start)
    except ForbiddenImport as e:
        print(f"simbench: modules of JAX or the JAX package are loaded: {e.args[0]}", file=sys.stderr)
        return 3
    except Exception:  # noqa: BLE001 - any failure of a run is reported, with no result line
        traceback.print_exc()
        return 1
    print(f"simbench: {args.workload} seed {args.seed}: {json.dumps(info)}", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
