"""One run of one cell: set-up, the measured window, the trace, the check.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, found as ``configs/<config>.json`` with its module
``configs/<config>.py``, and a traffic mix, ``traffic/<traffic>.json``;
``cells/<cell>.json`` holds its step rate.
Each metric is a reader ``metrics/<metric>.py``; the cell reports the
``end_to_end`` metrics (``--trace 0``) or the ``per_layer`` ones
(``--trace 1``) that ``BENCHMARK.json`` lists for it.

The window is one call of the program's public entry, ``run_simulation``,
from the cell's initial conditions, with the configuration's ``method``,
``precision`` and, where it names one, ``kernel``, its module's
``sim_kwargs``, the program's other defaults and snapshots off: its start
(the solver, the field's copy, the first force) and its end (the restart
file, the state back on the host) are inside it.  Its K steps (one more
than a multiple of 10, at least 21) are ``--seconds`` times the cell's
step rate, so that it lasts about ``--seconds`` and holds the same work in
every run.  The window writes its restart file at step K - 1 as well
(``restart_interval=K - 1``), and the harness keeps that state as the
program writes it.  The check (``reference/check.py``) then judges, against
the float64 reference, the first step from the initial conditions (the
warm-up call, which also builds or loads every kernel) and the window's
own last step, from its state at K - 1 to its final state.

A configuration names a ``kernel`` only for a method that takes one
(``method='scf'`` refuses it).  Its module may also define
``reference_gravity(cfg, device)``, the check's self-gravity (a callable
with the signature of ``reference.gravity.accel``, that softened direct
sum where the module has none), and ``FAULTS``, its own control faults
(``faults.planted``).
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import trace as tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "nbody_streams_tpu"}
# bases of the check numbers: the first step, and the window's last step
CHECKS = ("start", "window")


class NoDevice(RuntimeError):
    """The cell's cards are not there."""


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(man, name) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _load_module(path, tag):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(name):
    """(settings, module) of configuration ``name``."""
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return cfg, _load_module(HERE / "configs" / f"{name}.py",
                             f"portbench_config_{name}")


def traffic(name) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def cell_file(name) -> dict:
    return json.loads((HERE / "cells" / f"{name}.json").read_text())


def reader(name):
    return _load_module(HERE / "metrics" / f"{name}.py",
                        "portbench_metric_" + name.replace(".", "_"))


def metrics_for(man, cell, trace) -> list[dict]:
    """The metrics ``cell`` reports: its end-to-end ones, or with
    ``trace`` its per-layer ones (listed for it, or moving one of its
    end-to-end metrics when a metric lists no cells)."""
    e2e = [m for m in man["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _restart(f):
    """A restart's state as float64: x and v (the float32 values less
    their Kahan compensations), y (the float32 positions alone), its time
    and the friction's centre velocity where it has one; ``f`` is the
    file's path or what the program wrote into it."""
    if not isinstance(f, dict):
        with np.load(f) as z:
            return _restart(dict(z))
    xv = f["phase_space"]
    out = {"x": xv[:, :3] - f["state_pos_c"].astype(np.float64),
           "v": xv[:, 3:] - f["state_vel_c"].astype(np.float64),
           "y": xv[:, :3], "t": float(f["time"])}
    if "state_extra_v_com" in f:
        out["v_com"] = np.asarray(f["state_extra_v_com"], np.float64)
    return out


@contextlib.contextmanager
def kept_restart(step):
    """Keep what the program writes into its restart file at ``step`` (the
    arrays it hands ``numpy.savez``), though a later restart replaces the
    file; the dict is empty where no such restart was written."""
    kept = {}
    savez = np.savez

    def keep(file, *args, **kwargs):
        if "phase_space" in kwargs and int(kwargs.get("step", -1)) == step:
            kept.update(kwargs)
        return savez(file, *args, **kwargs)

    np.savez = keep
    try:
        yield kept
    finally:
        np.savez = savez


def steps_for(seconds, steps_per_second):
    """The window's K steps: one more than a multiple of 10, at least 21,
    so that the friction (every 10 steps) refreshes at step K - 1."""
    return max(21, int(seconds * steps_per_second / 10 + 0.5) * 10 + 1)


def run(cell, seed, seconds, trace, device="cuda", precision=None,
        n_body=None, t_proc=None):
    """Run ``cell``; returns (result line, check numbers with limits).

    ``precision`` overrides the configuration's (the control runs) and
    ``n_body`` the traffic's size (the CPU tests); ``device='cpu'`` skips
    the look for a card, for the tests."""
    t_proc = time.perf_counter() if t_proc is None else t_proc
    man = manifest()
    w = workload(man, cell)
    dev = torch.device(device)
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < w["chips"]):
        raise NoDevice(
            f"{cell} needs {w['chips']} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    os.environ["NBODY_TORCH_BUILD_DIR"] = str(ROOT / "build")
    from nbody_streams_tpu_torch.ops import cuda_direct
    from nbody_streams_tpu_torch.sim import run_simulation
    from nbody_streams_tpu_torch.species import Species

    cfg, cmod = config(w["config"])
    tr = traffic(w["traffic"])
    n_body = tr["n_body"] if n_body is None else n_body
    dt, t_end = cfg["dt"], cfg["t_end"]
    inputs = cmod.make_inputs(cfg, n_body, seed, dev)
    xv = torch.cat([inputs["pos"], inputs["vel"]], 1).cpu().numpy()
    n = xv.shape[0]
    species = [Species(name=k, N=m, mass=np.full(m, mk), softening=h)
               for k, m, mk, h in inputs["species"]]
    field = cmod.program_field(cfg, dev)
    kw = dict(method=cfg["method"], precision=precision or cfg["precision"],
              architecture="gpu" if dev.type == "cuda" else "cpu",
              external_potential=field, save_snapshots=False,
              verbose=False, **cmod.sim_kwargs(cfg, inputs))
    if "kernel" in cfg:
        kw["kernel"] = cfg["kernel"]
    out = Path(tempfile.mkdtemp(prefix=f"portbench-{cell}-"))

    def call(tag, t0, t1, **extra):
        _sync(dev)
        start = time.perf_counter()
        run_simulation(xv, species, t0, t1, dt, output_dir=str(out / tag),
                       **kw, **extra)
        _sync(dev)
        return time.perf_counter() - start

    # set-up: one call warms every kernel and path and is the check's
    # first step
    t_a = t_end - 2 * dt
    call("start", t_a, t_end - dt)
    k = steps_for(seconds, cell_file(cell)["steps_per_second"])
    if trace:
        k = max(21, (min(k, cfg["trace_steps_max"]) - 1) // 10 * 10 + 1)
    t0w = t_end - k * dt
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    branches = dict(cuda_direct.BRANCHES)
    setup_s = time.perf_counter() - t_proc

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with kept_restart(k - 1) as before, profile(activities=acts) as prof:
            with record_function("portbench.window"):
                window_s = call("window", t0w, t_end, restart_interval=k - 1)
    else:
        with kept_restart(k - 1) as before:
            window_s = call("window", t0w, t_end, restart_interval=k - 1)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"JAX or the JAX package was loaded: {bad}")
    if not before:
        raise RuntimeError(
            f"the window wrote no restart at step {k - 1} through "
            "numpy.savez: the check has no state to follow its last step from")

    rec = {"n": n, "steps": k, "evaluations": k + 1, "window_s": window_s,
           "setup_s": setup_s, "branches": {
               b: cuda_direct.BRANCHES[b] - branches[b] for b in branches}}
    if trace:
        rec["trace"] = tracing.read(prof)
        del prof
    del field
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers = _check(cfg, cmod, inputs, out, before, seed, dt, t_a, t0w,
                     t_end, dev, tr.get("check_sample", n))
    del before
    limits = cfg["limits"]
    checks = {f"{c}.{q}": {"value": numbers[c][q], "limit": limits[q]}
              for c in CHECKS for q in limits}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in checks.values())
    shutil.rmtree(out, ignore_errors=True)

    metrics = {}
    for m in metrics_for(man, cell, trace):
        val = reader(m["name"]).read(rec)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": w["chips"], "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": k, "failed": 0,
            "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = rec["trace"]["busy_s"]
        dev_info["window_s"] = rec["trace"]["window_s"]
        line["breakdown"] = tracing.breakdown(rec["trace"])
    line["checks"] = checks
    return line, numbers


def _check(cfg, cmod, inputs, out, before, seed, dt, t_a, t0w, t_end, dev,
           n_sample):
    """The check numbers of the first step and of the window's last step
    (from ``before``, what the window wrote at step K - 1), by the float64
    reference: the configuration's own self-gravity where its module has
    ``reference_gravity``, else the softened direct sum."""
    from portbench import ics
    from portbench.reference import check

    f64 = dict(dtype=torch.float64, device=dev)
    mass = torch.as_tensor(inputs["mass"], **f64)
    soft = torch.as_tensor(inputs["soft"], **f64)
    n = mass.numel()
    g = torch.Generator().manual_seed(int(seed) & 0x7FFF_FFFF_FFFF_FFFF)
    sample = torch.randperm(n, generator=g)[:min(n, n_sample)].sort()[0]
    sample = sample.to(dev)
    field, make_friction = cmod.reference_terms(cfg, dev)
    own = getattr(cmod, "reference_gravity", None)
    gravity = own(cfg, dev) if own is not None else None

    def state(d):
        return {k: (torch.as_tensor(v, **f64) if k != "t" else v)
                for k, v in d.items()}

    # the friction refreshes at both steps' starts: at the first from the
    # initial velocities, at the window's K - 1 from the positions with
    # the centre velocity the program took (the reference cannot make the
    # half-step velocities of every particle)

    # the program holds its state in float32: the first step starts from
    # the initial conditions rounded so, with no compensation
    x0 = inputs["pos"].to(torch.float32).to(torch.float64)
    v0 = inputs["vel"].to(torch.float32).to(torch.float64)
    steps = {"start": ({"x": x0, "y": x0, "v": v0, "t": t_a},
                       out / "start", 0.5 * (t_a + t_end - dt)),
             "window": (_restart(before), out / "window",
                        0.5 * (t0w + t_end))}
    numbers = {}
    for name, (a, path_b, t_mid) in steps.items():
        b = _restart(path_b / "restart.npz")
        b.pop("v_com", None)
        fric = (make_friction(float(inputs["mass"].sum()), t_mid)
                if make_friction else None)
        numbers[name] = check.step(state(a), state(b), sample, mass, soft,
                                   ics.G, dt, field=field, fric=fric,
                                   gravity=gravity)
    return numbers
