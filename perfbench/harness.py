"""One run of one cell: find the cell's files by name, check the card, hand
the cell to its driver, read its metrics and print the result line.

Everything is found by name: ``perfbench/workloads/<cell>.json`` names its
configuration (``perfbench/configs/<config>.json``) and its driver
(``perfbench/drivers/<driver>.py``); the metrics a cell reports are those
``BENCHMARK.json`` gives it, each read by ``perfbench/metrics/<metric>.py``;
the limits of its check are ``perfbench/limits/<cell>.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from perfbench.reference.llama import Dims

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def dims(config: dict) -> Dims:
    """The model's sizes from a configuration file (the published
    ``config.json`` keys; the head size from ``assumed`` where the source
    leaves it out)."""
    h, nh = config["hidden_size"], config["num_attention_heads"]
    head = config.get("head_dim") or config.get("assumed", {}).get("head_dim") or h // nh
    return Dims(vocab=config["vocab_size"], hidden=h, inter=config["intermediate_size"],
                layers=config["num_hidden_layers"], heads=nh,
                kv_heads=config["num_key_value_heads"], head_dim=head,
                rope_theta=float(config["rope_theta"]), eps=float(config["rms_norm_eps"]))


@dataclasses.dataclass
class Ctx:
    """What a driver is handed."""
    cell: str
    workload: dict
    config: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    t0: float  # process start, perf_counter
    rehearsal: bool = False

    @property
    def dims(self) -> Dims:
        return dims(self.config)

    @property
    def dtype(self):
        """The type the configuration is served or trained in."""
        import torch

        return getattr(torch, self.config.get("dtype", "bfloat16"))

    def program_config(self, **kw):
        """The port's ``LlamaConfig`` for this configuration."""
        from ray_tpu_torch.models.llama import LlamaConfig

        d = self.dims
        if self.config.get("tie_word_embeddings"):
            raise ValueError("the benchmark's weights keep an untied lm_head")
        if self.config.get("sliding_window") is not None:
            raise ValueError("the port runs full attention only")
        return LlamaConfig(vocab_size=d.vocab, hidden_size=d.hidden, intermediate_size=d.inter,
                           num_layers=d.layers, num_heads=d.heads, num_kv_heads=d.kv_heads,
                           head_dim=d.head_dim, rope_theta=d.rope_theta, rms_eps=d.eps,
                           tie_embeddings=False, dtype=self.dtype, **kw)


@dataclasses.dataclass
class Run:
    """What a driver hands back; the metric readers read it."""
    ctx: Ctx
    setup_s: float
    window: tuple  # (t0_ns, t1_ns), host clock
    attempted: int
    failed: int
    checks: Dict[str, float]  # number compared -> value
    memory_peak_bytes: int
    requests: List[dict] = dataclasses.field(default_factory=list)
    steps: int = 0
    tokens_per_step: int = 0
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    recorder: Any = None
    trace: Any = None  # perfbench.trace.Trace of a --trace 1 run
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics ``BENCHMARK.json`` has this cell report: with tracing,
    the per-layer metrics that list it (or, without a list, that move one of
    its end-to-end metrics); without, its end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def metric_module(name: str):
    """``perfbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    module = "perfbench.metrics." + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """``perfbench/metrics/<name>.py``'s ``read``."""
    return metric_module(name).read


def read_metrics(metrics: List[dict], run: Run) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def traced_problems(run: Run, metrics: List[dict], read: Dict[str, dict]) -> List[str]:
    """Why a traced run's per-layer metrics cannot be trusted, if they
    cannot: a metric ``BENCHMARK.json`` lists for the cell that read nothing,
    a recorder that saw no decode chunk or no prefill (the engine no longer
    calls the methods it wraps, ``serving.Recorder``), or a kernel that a
    metric names (its module's ``KERNELS``) with no launch in the trace."""
    out = []
    rec = run.recorder
    if rec is not None and (not rec.chunks or not rec.prefills):
        out.append(f"the recorder saw {len(rec.chunks)} decode chunks and {len(rec.prefills)} "
                   "prefills: LLMEngine._decode or LLMEngine._prefill_group is no longer called")
    for m in metrics:
        for kernel in getattr(metric_module(m["name"]), "KERNELS", ()):
            n = run.trace.launches(kernel) if run.trace is not None else 0
            if n == 0:
                out.append(f"metric {m['name']}: no launch of a kernel named {kernel!r} "
                           "in the trace")
        if m["name"] not in read:
            out.append(f"metric {m['name']} read nothing in {run.ctx.cell}")
    return out


def forbidden_loaded() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: str, workload: dict, config: dict, limits: dict, seed: int, seconds: float,
             trace: bool, device, t0: float, rehearsal: bool = False) -> Run:
    driver = importlib.import_module(f"perfbench.drivers.{workload['driver']}")
    ctx = Ctx(cell=cell, workload=workload, config=config, limits=limits, seed=seed,
              seconds=seconds, trace=trace, device=device, t0=t0, rehearsal=rehearsal)
    return driver.run(ctx)


def verdict(run: Run) -> Dict[str, dict]:
    """Each number compared beside its limit (``value <= limit`` passes)."""
    out = {}
    for name, value in run.checks.items():
        limit = run.ctx.limits[name]["limit"]
        out[name] = {"value": value, "limit": limit}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def device_info(run: Run, count: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": run.memory_peak_bytes,
            "power_limit_w": power_limit()}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info


def power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def report(run: Run, bench: dict, chips: int) -> dict:
    """The result line. A rehearsal on the CPU reports no metric: every
    metric is a device metric, and a CPU number is never written under one."""
    checks = verdict(run)
    if run.ctx.rehearsal:
        metrics, device = {}, {"platform": "cpu", "count": 0, "rehearsal": True}
    else:
        metrics = read_metrics(cell_metrics(bench, run.ctx.cell, run.ctx.trace), run)
        device = device_info(run, chips)
    result = {"correct": passed(checks), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device}
    if run.trace is not None and not run.ctx.rehearsal:
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    return result


def main(args, t0: float) -> int:
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}",
              file=sys.stderr)
        return 2
    workload = load_json(HERE / "workloads" / f"{args.workload}.json")
    config = load_json(HERE / "configs" / f"{workload['config']}.json")
    limits = load_json(HERE / "limits" / f"{args.workload}.json")
    chips = cells[args.workload]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    run = run_cell(args.workload, workload, config, limits, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), t0)
    loaded = forbidden_loaded()
    if loaded:
        print(f"refusing to report: {', '.join(loaded)} loaded in the measuring process",
              file=sys.stderr)
        return 4
    result = report(run, bench, chips)
    problems = (traced_problems(run, cell_metrics(bench, args.workload, True), result["metrics"])
                if run.ctx.trace else [])
    checks = result["checks"]
    sys.stdout.flush()
    for line in problems:
        print(f"refusing to report: {line}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    if problems:
        return 5
    print(json.dumps(result), flush=True)
    return 0
