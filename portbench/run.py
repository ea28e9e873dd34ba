"""The benchmark of blitzdg_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

A cell is a file ``portbench/workloads/<cell>.json``: a configuration
(``portbench/configs/<config>.json``, driven by
``portbench/drivers/<driver>.py``), a load and the limits of its check.
The run builds the system under test, makes the request pool from the
seed, warms up with one short request, then sends requests in a closed
loop, one client, for ``--seconds``. After the window the plain reference
checks a seeded sample of the answers (``check.py``). The last line of
standard output is one JSON object; the compared numbers, each with its
limit, end standard error. With ``--trace 1`` the requests after the
first are traced (``trace.py``: the cell's ``trace_requests`` with the
device alone recorded, then a few with the host's operations too) and the
per-layer metrics are reported instead of the end-to-end ones. A request
of the window costs the harness one gather of its sampled rows (drawn from
the seed before the window), none in a traced request; whether each answer
is finite is tested after the window.

It needs an NVIDIA GPU, and exits 2 without one.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "blitzdg_tpu")
HOST_PASS = 2  # requests traced with the host's operations, for the gaps


def _fixed_caches() -> None:
    """Build and kernel caches of any library the run loads stay inside
    the checkout, at fixed paths (the port's own nvcc output goes to
    ``blitzdg_tpu_torch/_build``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _finite(resp) -> "torch.Tensor":
    import torch

    parts = [resp.controls, resp.cost, resp.history, *resp.plant]
    if resp.grad_norm is not None:
        parts.append(resp.grad_norm)
    return torch.stack([torch.isfinite(p).all() for p in parts]).all()


def _failed(costs: list, kept: list, kept_at: list) -> int:
    """Requests with a non-finite answer, counted after the window: any
    scenario's cost (a blow-up anywhere in a rollout reaches it) or any
    kept row."""
    import torch

    bad = ~torch.isfinite(torch.stack(costs)).all(dim=1)
    if kept:
        ok = torch.stack([_finite(k) for k in kept])
        bad[torch.as_tensor(kept_at, device=bad.device)] |= ~ok
    return int(bad.sum())


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t0: float, load_overrides: dict | None = None,
             system=None, min_requests: int = 0) -> tuple:
    """One run; returns (result, checks). ``load_overrides`` replaces keys
    of the cell's load (tests run a cell at a size a CPU holds);
    ``system`` stands in for the configuration's driver (the control puts
    the reference there); the window lasts at least ``min_requests``."""
    import torch
    from torch.profiler import record_function

    from portbench import check, spec, traffic
    from portbench import trace as tr
    from portbench.counts.peaks import bound_ms
    from portbench.counts.shapes import shape_of
    from portbench.counts.sw2d import COUNTS
    from portbench.reference.models import build_model
    from portbench.response import Response, cat

    wl = spec.workload(cell)
    cfg = spec.config(wl["config"])
    load = {**wl["load"], **(load_overrides or {})}
    phases = {"imports": time.perf_counter() - t0}
    mark = time.perf_counter()

    def phase(name: str) -> None:
        nonlocal mark
        now = time.perf_counter()
        phases[name], mark = now - mark, now

    drv = system or spec.driver(cfg["driver"])
    model = build_model(cfg)
    phase("reference_mesh")
    sut = drv.build(cfg, load, device)
    _sync(device)
    phase("program")
    pool = traffic.make_pool(load, model, seed, device)
    _sync(device)
    phase("pool")

    def request(batch, solver, spans: bool):
        span = record_function if spans else (
            lambda name: contextlib.nullcontext())
        with span("portbench.solve"):
            controls, cost, hist, gnorm = drv.solve(sut, batch, solver)
        with span("portbench.plant"):
            plant = drv.plant(sut, batch, controls[:, 0].contiguous())
        _sync(device)
        return Response(controls, cost, hist, gnorm, plant)

    request(pool[0], load["warm_solver"], False)
    phase("warm_up")
    # the reference's mesh serves the pool and the check, not the program
    setup_s = time.perf_counter() - t0 - phases["reference_mesh"]
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
          + f"; setup_s {setup_s:.3f} s", file=sys.stderr)
    # the rows of each request that the check may take, drawn before the
    # window so that a request costs the harness one gather of them
    table = traffic.sample_table(load, seed)
    rows = torch.as_tensor(table, device=device)

    wrappers = drv.wrappers()
    counters = lambda: {r: w.launches for r, w in wrappers.items()}
    # traced runs: requests 1..n_dev with the device alone recorded, then
    # HOST_PASS more with the host's operations too (trace.py)
    n_dev = load["trace_requests"] if trace else 0
    last = n_dev + HOST_PASS if trace else 0
    latencies, costs, kept, kept_at, origins = [], [], [], [], []
    traced = {}
    w0 = time.perf_counter()
    end = w0
    i = 0
    while end - w0 < seconds or i <= last or i < min_requests:
        if trace and i in (1, n_dev + 1):
            host = i > 1
            prof_cm = tr.profiled(host)
            holder = prof_cm.__enter__()
            if host:
                window_cm = record_function(tr.WINDOW)
                window_cm.__enter__()
            before, t_dev = counters(), time.perf_counter()
        p = i % len(pool)
        start = time.perf_counter()
        resp = request(pool[p], load["solver"], trace and n_dev < i <= last)
        end = time.perf_counter()
        latencies.append(end - start)
        costs.append(resp.cost.detach())
        if not (trace and 0 < i <= last):  # traced requests: the program alone
            r = i % len(table)
            kept.append(resp.rows(rows[r]))
            kept_at.append(i)
            origins.extend((p, int(j)) for j in table[r])
        if trace and i == n_dev:
            prof_cm.__exit__(None, None, None)
            after = counters()
            traced.update(tr.device_pass(holder["prof"]),
                          window_s=end - t_dev,
                          launches={r: after[r] - before[r] for r in after})
        elif trace and i == last:
            window_cm.__exit__(None, None, None)
            prof_cm.__exit__(None, None, None)
            traced["idle_gaps"] = tr.idle_gaps(holder["prof"])
        i += 1
    window_s = end - w0
    failed = _failed(costs, kept, kept_at)
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError("loaded in the measuring process: "
                           + ", ".join(loaded))

    rec = {"setup_s": setup_s, "window_s": window_s,
           "latencies_s": latencies, "scenarios": load["batch"] * i}
    if trace:
        rec["trace"] = traced
        shape = shape_of(model, cfg)
        n_cs, spc = load["horizon"], load["steps_per_control"]
        traced.update(
            requests=n_dev,
            roles={r: wl["kernels"][r] for r in traced["launches"]},
            bound_ms={r: bound_ms(*COUNTS[name](shape, load["batch"], n_cs,
                                                spc))[0]
                      for r, name in cfg["counts"].items()})

    # the check: the program's state goes first, the reference runs alone
    del sut
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    answers = cat(kept)
    sel = traffic.checked(load, seed, len(origins))
    idx = torch.as_tensor(sel, device=device)
    answers = answers.rows(idx)
    pick = [origins[k] for k in sel]
    state0 = tuple(torch.stack([pool[p].state[f][j] for p, j in pick])
                   for f in range(len(pool[0].state)))
    targets = torch.stack([pool[p].targets[j] for p, j in pick])
    ref = check.reference_readings(model, load, state0, targets,
                                   answers.controls, device)
    ok, checks = check.verdict(check.readings(answers, ref), wl["limits"])

    metrics = {}
    for m in spec.metrics_of(cell, trace):
        value = spec.metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    result = {
        "correct": bool(ok and failed == 0),
        "attempted": i,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": wl["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    sys.path.insert(0, str(ROOT))
    from portbench import spec

    try:
        chips = spec.workload(args.workload)["chips"]
    except (OSError, ValueError) as exc:
        print(f"portbench: no such cell: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} NVIDIA GPU(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
