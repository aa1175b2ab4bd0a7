"""One run of one cell: set-up, a closed loop of stream blocks for a fixed
time, the check of the outputs against the plain reference, one JSON line.

The loop hands block i of the cell's ring to the path's entry into the port,
waits until the output is where its consumer reads it (a CUDA event after
the step, synchronised), and hands the next block.  ``step_ms_p95`` is the
95th percentile of the steps' latencies from that pair of CUDA events;
``msamples_per_s`` is every input sample of every completed step over the
window's length on the host clock; ``setup_s`` runs from the first line of
``run.py`` to the first timed step.

A path module (``paths/<name>.py``) defines ``Path(cell, seed, device,
mark, control, fault, row)`` with ``samples_per_step``, ``warm()``,
``step(i)``, ``keep(i, slot)``, ``release()`` and ``check()``; ``check``
returns ``[(name, value, limit), ...]`` and a value above its limit makes the
run not correct.  A path across cards also defines ``agree(stop)``, so that
its ranks stop after the same step; such a cell runs one worker process a
card (:func:`spawn_row`) and :func:`combine` merges their parts.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import random
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PB = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "libtsd_tpu")
WORKER_SECONDS = 1000   # a worker of a cell across cards, set-up included


class NoDevice(RuntimeError):
    pass


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = PB / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and
    metrics, read from their files."""

    def __init__(self, workload: str, bench: dict | None = None,
                 traffic: dict | None = None):
        bench = load_benchmark() if bench is None else bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        w = cells[workload]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.name = workload
        self.chips = int(w["chips"])
        self.config = json.loads((ROOT / conf["file"]).read_text())
        self.traffic = (json.loads((PB / "traffic" / f"{w['traffic']}.json")
                                   .read_text())
                        if traffic is None else traffic)
        self.path = self.traffic["path"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, workload)]
        self.per_layer = [m for m in bench["per_layer"]
                          if _applies(m, workload)]

    @classmethod
    def from_dict(cls, d: dict) -> "Cell":
        """A cell as a worker receives it (``vars(cell)``)."""
        cell = cls.__new__(cls)
        vars(cell).update(d)
        return cell


class _Clock:
    """Per-step latency: CUDA events on a card, the host clock on the CPU
    (tests only)."""

    def __init__(self, device):
        import torch
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.e0.record()
        else:
            self.t0 = time.perf_counter()

    def stop_ms(self) -> float:
        if self.cuda:
            self.e1.record()
            self.e1.synchronize()
            return self.e0.elapsed_time(self.e1)
        return 1e3 * (time.perf_counter() - self.t0)


def forbidden_modules() -> list:
    top = {k.split(".")[0] for k in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


class Row:
    """This process's place in a cell across cards: rank, process count,
    the coordinator's address, and the epoch time the parent started."""

    def __init__(self, rank: int, nproc: int, coordinator: str,
                 t0_epoch: float):
        self.rank, self.nproc = rank, nproc
        self.coordinator, self.t0_epoch = coordinator, t0_epoch


def _check_cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} card(s), the cell "
                       f"asks for {chips}")


def measure(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
            device=None, control: bool = False, fault: str | None = None,
            log=None, row: Row | None = None) -> dict:
    """Set up, run the window, read the trace, check: one process's part
    of a run (the whole run on one card).  ``device`` None: the process's
    card, or NoDevice.  ``control`` runs the path's lower-precision
    control in the program's place; ``fault`` breaks the timed path
    underneath (tests only)."""
    import torch
    from portbench import spans
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    marks = {"import_torch": time.perf_counter() - t0}
    if device is None:
        _check_cards(torch, cell.chips if row is None else 1)
        device = torch.device("cuda", 0 if row is None else row.rank)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        marks["cuda_context"] = time.perf_counter() - t0
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    def mark(name):
        if cuda:
            torch.cuda.synchronize(device)
        marks[name] = time.perf_counter() - t0

    mod = load_module("paths", cell.path)
    path = mod.Path(cell, seed, device, mark, control=control, fault=fault,
                    row=row)
    path.warm()
    mark("warm_up")
    clock = _Clock(device)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
        spans.enabled = True
    keep_n = int(cell.traffic.get("check_steps", 4))
    rng = random.Random(seed)
    agree = getattr(path, "agree", None)
    lat = []
    w0 = time.perf_counter()
    setup_s = (w0 - t0 if row is None
               else time.time() - row.t0_epoch)
    with spans.span("portbench.window"):
        i, stop = 0, False
        while not stop:
            with spans.span("portbench.step"):
                clock.start()
                path.step(i)
                lat.append(clock.stop_ms())
            # a uniform sample of the window's steps, drawn from the seed
            slot = i if i < keep_n else rng.randrange(i + 1)
            if slot < keep_n:
                path.keep(i, slot)
            i += 1
            stop = time.perf_counter() - w0 >= seconds
            if agree is not None:
                # the ranks stop together, after a multiple of 16 steps
                stop = agree(stop) if i % 16 == 0 else False
    window_s = time.perf_counter() - w0
    out = {"steps": i, "window_s": window_s, "setup_s": setup_s,
           "samples": i * path.samples_per_step, "lat": lat,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if cuda else 0),
           "per_layer": {}, "breakdown": None}
    if trace:
        spans.enabled = False
        prof.__exit__(None, None, None)
        from portbench.trace import Trace
        tr = Trace.from_profiler(prof, cell, i, window_s)
        del prof
        for m in cell.per_layer:
            out["per_layer"][m["name"]] = load_module(
                "metrics", m["name"]).read(tr)
        out["breakdown"] = tr.breakdown()
        out["busy_s"], out["trace_window_s"] = tr.busy_s, tr.window_s
    log(f"portbench: {cell.name} seed {seed}"
        + (f" rank {row.rank}" if row else "")
        + f": {i} steps in {window_s:.3f} s; step latency median "
        f"{statistics.median(lat):.4f} ms")
    log("portbench: set-up split (s from start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in marks.items()) + f", first step "
        f"{setup_s:.3f}")
    path.release()
    if cuda:
        torch.cuda.synchronize(device)
    c0 = time.perf_counter()
    out["checks"] = path.check()
    log(f"portbench: reference check {time.perf_counter() - c0:.3f} s")
    out["device"] = {"platform": "gpu" if cuda else "cpu",
                     "kind": (torch.cuda.get_device_name(device) if cuda
                              else "cpu")}
    return out


def _p95(lat: list) -> float:
    return statistics.quantiles(lat, n=100)[94] if len(lat) > 1 else lat[0]


def combine(cell: Cell, parts: list, trace: bool) -> dict:
    """The result line from the processes' parts (rank 0 first): work and
    time from rank 0, each step's latency the slowest rank's, per-layer
    metrics combined as each metric's module says (the mean by default),
    the memory peak of the fullest card, busy time the cards' mean."""
    p0 = parts[0]
    lat = [max(v) for v in zip(*(p["lat"] for p in parts))]
    metrics = {}
    if trace:
        for m in cell.per_layer:
            vals = [p["per_layer"][m["name"]] for p in parts
                    if p["per_layer"].get(m["name"]) is not None]
            if vals:
                fn = getattr(load_module("metrics", m["name"]), "combine",
                             statistics.fmean)
                metrics[m["name"]] = {"value": fn(vals), "unit": m["unit"]}
    else:
        e2e = {"msamples_per_s": sum(p["samples"] for p in parts)
               / p0["window_s"] / 1e6,
               "step_ms_p95": _p95(lat), "setup_s": p0["setup_s"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    checks = [c for p in parts for c in p["checks"]]
    bad = [(n, v, lim) for n, v, lim in checks
           if not (math.isfinite(v) and v <= lim)]
    cuda = p0["device"]["platform"] == "gpu"
    device = {**p0["device"], "count": len(parts) if cuda else 0,
              "memory_peak_bytes": int(max(p["memory_peak_bytes"]
                                           for p in parts))}
    if trace:
        device["busy_s"] = statistics.fmean(p["busy_s"] for p in parts)
        device["window_s"] = statistics.fmean(p["trace_window_s"]
                                              for p in parts)
    if cuda:
        device["power_limit"] = _power_limit()
    out = {"correct": not bad and bool(checks), "attempted": p0["steps"],
           "failed": len(bad), "metrics": metrics, "device": device}
    if trace:
        out["breakdown"] = p0["breakdown"]
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    if len(parts) > 1:
        # what the workers loaded (main() refuses the run on any of these)
        out["forbidden"] = [p.get("forbidden", []) for p in parts]
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
             device=None, log=None, nproc: int | None = None, **kw) -> dict:
    """One run: in this process on one card (or the CPU, tests), or one
    worker process a card (``nproc`` of them, the cell's chips by
    default) for a cell across cards."""
    n = nproc or cell.chips
    if n == 1:
        return combine(cell, [measure(cell, seed, seconds, trace, t0,
                                      device, log=log, **kw)], trace)
    return combine(cell, spawn_row(cell, seed, seconds, trace, t0, device,
                                   n, **kw), trace)


def spawn_row(cell: Cell, seed: int, seconds: float, trace: bool,
              t0: float, device, nproc: int, control: bool = False,
              fault: str | None = None) -> list:
    """Start one worker a card (``run.py --rank``), wait for all of them
    and return their parts, rank 0 first.  A worker that fails, or that
    outlives the deadline, stops them all."""
    import socket
    import subprocess
    import torch
    if device is None:
        _check_cards(torch, nproc)
        # build the kernels once, before the workers load them
        from libtsd_tpu_torch.ops.kernels import _build
        _build.build()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sock.getsockname()[1]}"
    t0_epoch = time.time() - (time.perf_counter() - t0)
    args = ["--workload", cell.name, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(int(trace)), "--nproc", str(nproc),
            "--coordinator", addr, "--t0-epoch", repr(t0_epoch)]
    if device is not None:
        args += ["--device", str(device)]
    if control:
        args += ["--control"]
    if fault:
        args += ["--fault", fault]
    args += ["--cell-json", json.dumps(vars(cell))]
    env = dict(os.environ)
    if device is not None:
        env["OMP_NUM_THREADS"] = "1"   # CPU workers (tests) share the cores
    # each worker's result line goes to a file of its own (a pipe could
    # fill and block it before it exits)
    outs = [tempfile.TemporaryFile("w+") for _ in range(nproc)]
    procs = [subprocess.Popen([sys.executable, str(PB / "run.py"), *args,
                               "--rank", str(r)], stdout=outs[r], text=True,
                              env=env) for r in range(nproc)]
    deadline = time.monotonic() + WORKER_SECONDS
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                raise RuntimeError(
                    "a worker " + (f"exited {bad[0].returncode}" if bad
                                   else "outlived the deadline"))
            time.sleep(0.05)
        parts = []
        for r, (p, f) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"worker {r} exited {p.returncode}")
            f.seek(0)
            parts.append(json.loads(f.read().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in outs:
            f.close()
    return parts




def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a worker of a cell across cards (started by spawn_row)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--nproc", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)
    ap.add_argument("--t0-epoch", type=float, help=argparse.SUPPRESS)
    ap.add_argument("--device", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cell-json", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    try:
        if a.rank is not None:
            cell = Cell.from_dict(json.loads(a.cell_json))
            row = Row(a.rank, a.nproc, a.coordinator, a.t0_epoch)
            part = measure(cell, a.seed, a.seconds, bool(a.trace), t0,
                           a.device, control=a.control, fault=a.fault,
                           row=row)
            part["forbidden"] = forbidden_modules()
            print(json.dumps(part), flush=True)
            return 0
        cell = Cell(a.workload)
        res = run_cell(cell, a.seed, a.seconds, bool(a.trace), t0)
    except NoDevice as e:
        print(f"portbench: no card to run on: {e}", file=sys.stderr)
        return 2
    found = sorted(set(forbidden_modules()).union(
        *res.pop("forbidden", [])))
    if found:
        print(f"portbench: the process loaded {found}: the benchmark "
              f"measures the PyTorch port alone", file=sys.stderr)
        return 3
    for n, c in res["checks"].items():
        print(f"check {n} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {res['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0
