"""Train and Tune on the port's runtime (``ray_tpu_torch.train.GpuTrainer``,
``ray_tpu_torch.tune``) held against the JAX package's (``TpuTrainer``,
``ray_tpu.tune``).

Each scenario of ``tests/test_train.py`` and ``tests/test_tune.py`` is
written once, as a function of a namespace of one package's Train and Tune,
runs on each package's fresh ``LocalRuntime`` in turn, and must give the
same ``metrics_history``, the same trial configs for the same seed and the
same stopped trials. Schedulers whose decisions depend on the order in
which concurrent trials report (ASHA, the median rule, BayesOpt) run one
trial at a time here, so that order is the same in both runs. PBT ranks
only trials that are still running, so its case runs four side by side and
compares what does not depend on their order.

The tiny Llama trained through each trainer (``test_train_tiny_llama_e2e``)
starts from the same weights, carried across with
``ray_tpu_torch.train.step.train_state_from_jax``; per-step losses agree to
``tests/test_torch_train.py``'s tolerance (atol 1e-5, rtol 1e-4). Port-only
cases: restart from a ``torch.save``d ``TrainState``, a ``use_gpu`` fit with
no card, and the process group of ``use_torch_distributed``."""

import importlib
import json
import os
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import llama as jl
from ray_tpu.train import step as js
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.train import step as ts

PACKAGES = (ray_tpu, ray_tpu_torch)
SCENARIOS = {}
LOSS_ATOL, LOSS_RTOL = 1e-5, 1e-4  # tests/test_torch_train.py's


def _ns(pkg):
    """One package's Train and Tune under common names."""
    train = importlib.import_module(pkg.__name__ + ".train")
    return types.SimpleNamespace(
        pkg=pkg, train=train, session=importlib.import_module(pkg.__name__ + ".train.session"),
        tune=importlib.import_module(pkg.__name__ + ".tune"),
        search=importlib.import_module(pkg.__name__ + ".tune.search"),
        Trainer=train.GpuTrainer if pkg is ray_tpu_torch else train.TpuTrainer)


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _shutdown_all():
    for pkg in PACKAGES:
        if pkg.is_initialized():
            pkg.shutdown()


@pytest.fixture
def on_both(tmp_path):
    """``run(fn)`` runs ``fn(ns, storage)`` on ray_tpu's runtime, then on
    ray_tpu_torch's, each with its own storage directory, and returns both
    results; both runtimes are shut down whatever happens."""
    _shutdown_all()

    def run(fn):
        out = []
        for pkg in PACKAGES:
            pkg.init(num_cpus=8)
            try:
                out.append(fn(_ns(pkg), str(tmp_path / pkg.__name__)))
            finally:
                pkg.shutdown()
        return out

    yield run
    _shutdown_all()


@pytest.fixture
def port(tmp_path):
    _shutdown_all()
    ray_tpu_torch.init(num_cpus=8)
    yield str(tmp_path)
    _shutdown_all()


def _result(r):
    """What a caller reads of a train Result."""
    return {"metrics": r.metrics, "history": r.metrics_history,
            "error": None if r.error is None else [type(r.error).__name__, str(r.error)],
            "checkpoint": None if r.checkpoint is None else os.path.basename(r.checkpoint.path)}


def _trials(grid):
    return [(t.trial_id, t.config, t.status, t.iteration, t.last_result) for t in grid._trials]


# ---------------------------------------------------------------------- train


@scenario
def basic_fit_collects_metrics(N, storage):
    def train_fn(config):
        for step in range(3):
            N.session.report({"step": step, "loss": 1.0 / (step + 1)})

    r = N.Trainer(train_fn, scaling_config=N.train.ScalingConfig(num_workers=2, cpus_per_worker=1),
                  run_config=N.train.RunConfig(name="basic", storage_path=storage)).fit()
    assert r.error is None and len(r.metrics_history) == 3 and r.metrics["step"] == 2
    return _result(r)


@scenario
def rank_and_world_size(N, storage):
    def train_fn(config):
        ctx = N.session.get_context()
        N.session.report({"rank": ctx.world_rank, "world": ctx.world_size})

    r = N.Trainer(train_fn, scaling_config=N.train.ScalingConfig(num_workers=3, cpus_per_worker=1),
                  run_config=N.train.RunConfig(name="ranks", storage_path=storage)).fit()
    assert r.metrics == {"rank": 0, "world": 3}
    return _result(r)


@scenario
def checkpoint_saved_and_returned(N, storage):
    def train_fn(config):
        for step in range(2):
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "state.txt"), "w") as f:
                    f.write(f"step={step}")
                N.session.report({"step": step},
                                 checkpoint=N.session.Checkpoint.from_directory(d))

    r = N.Trainer(train_fn, scaling_config=N.train.ScalingConfig(num_workers=1),
                  run_config=N.train.RunConfig(name="ckpt", storage_path=storage)).fit()
    with open(os.path.join(r.checkpoint.path, "state.txt")) as f:
        content = f.read()
    assert content == "step=1"
    return [_result(r), content]


@scenario
def failure_restart_resumes_from_checkpoint(N, storage):
    def train_fn(config):
        start = 0
        ckpt = N.session.get_checkpoint()
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "step.txt")) as f:
                start = int(f.read()) + 1
        for step in range(start, 4):
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "step.txt"), "w") as f:
                    f.write(str(step))
                N.session.report({"step": step},
                                 checkpoint=N.session.Checkpoint.from_directory(d))
            if step == 1 and ckpt is None:
                raise RuntimeError("simulated mid-training crash")

    r = N.Trainer(train_fn, scaling_config=N.train.ScalingConfig(num_workers=1),
                  run_config=N.train.RunConfig(
                      name="restart", storage_path=storage,
                      failure_config=N.train.FailureConfig(max_failures=1))).fit()
    steps = [m["step"] for m in r.metrics_history]
    assert r.error is None and steps[-1] == 3 and 2 in steps
    return _result(r)


@scenario
def failure_exhausted_returns_error(N, storage):
    def train_fn(config):
        raise ValueError("always broken")

    r = N.Trainer(train_fn, scaling_config=N.train.ScalingConfig(num_workers=1),
                  run_config=N.train.RunConfig(
                      name="fail", storage_path=storage,
                      failure_config=N.train.FailureConfig(max_failures=1))).fit()
    assert "always broken" in str(r.error)
    return _result(r)


@scenario
def device_error_on_the_train_thread_reaches_the_result(N, storage):
    """An error raised on the trainer's thread (here a CUDA allocation
    failure, raised by hand) reaches Result.error with its class and text."""
    def train_fn(config):
        N.session.report({"step": 0})
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    r = N.Trainer(train_fn, scaling_config=N.train.ScalingConfig(num_workers=1),
                  run_config=N.train.RunConfig(name="oom", storage_path=storage)).fit()
    assert isinstance(r.error, torch.OutOfMemoryError)
    return _result(r)


# ----------------------------------------------------------------------- tune


def _quadratic_for(N):
    def quadratic(config):
        x = config["x"]
        for i in range(8):
            N.tune.report({"loss": (x - 3.0) ** 2 + 1.0 / (i + 1), "x": x})
    return quadratic


@scenario
def grid_and_random_search(N, storage):
    grid = N.tune.Tuner(
        _quadratic_for(N), param_space={"x": N.tune.grid_search([0.0, 3.0, 6.0])},
        tune_config=N.tune.TuneConfig(metric="loss", mode="min", num_samples=2,
                                      max_concurrent_trials=3),
        run_config=N.train.RunConfig(name="grid", storage_path=storage)).fit()
    best = grid.get_best_result("loss", "min")
    assert len(grid) == 6 and best.metrics["x"] == 3.0 and not grid.errors
    return [_trials(grid), [r.metrics_history for r in grid]]


@scenario
def search_space_sampling(N, storage):
    t = N.tune
    cfgs = N.search.generate_trial_configs(
        {"lr": t.loguniform(1e-5, 1e-1), "layers": t.randint(1, 4),
         "act": t.choice(["relu", "gelu"]), "bs": t.grid_search([8, 16])},
        num_samples=3, seed=42)
    assert len(cfgs) == 6 and {c["bs"] for c in cfgs} == {8, 16}
    return cfgs


@scenario
def asha_stops_bad_trials(N, storage):
    def trainable(config):
        for i in range(1, 17):
            N.tune.report({"loss": config["quality"] * 10.0 + 1.0 / i})

    grid = N.tune.Tuner(
        trainable, param_space={"quality": N.tune.grid_search([0, 1, 2, 3, 4, 5, 6, 7])},
        tune_config=N.tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=1,
            scheduler=N.tune.ASHAScheduler(metric="loss", mode="min", grace_period=2,
                                           reduction_factor=2, max_t=16)),
        run_config=N.train.RunConfig(name="asha", storage_path=storage)).fit()
    statuses = [t.status for t in grid._trials]
    assert "STOPPED" in statuses and "TERMINATED" in statuses
    assert grid.get_best_result("loss", "min").metrics["loss"] < 1.0
    return _trials(grid)


@scenario
def checkpoint_and_resume(N, storage):
    def trainable(config):
        ckpt = N.tune.get_checkpoint()
        start = 0
        if ckpt is not None:
            with open(os.path.join(ckpt.to_directory(), "state.json")) as f:
                start = json.load(f)["iter"] + 1
        for i in range(start, 4):
            d = tempfile.mkdtemp(dir=storage)
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"iter": i}, f)
            N.tune.report({"loss": 1.0 / (i + 1), "step": i},
                          checkpoint=N.session.Checkpoint(d))

    os.makedirs(storage, exist_ok=True)
    grid = N.tune.Tuner(
        trainable, param_space={},
        tune_config=N.tune.TuneConfig(num_samples=2, max_concurrent_trials=2),
        run_config=N.train.RunConfig(name="ckpt", storage_path=storage)).fit()
    exp_dir = os.path.join(storage, "ckpt")
    assert not grid.errors and os.path.exists(os.path.join(exp_dir, "experiment_state.json"))
    grid2 = N.tune.Tuner.restore(exp_dir, trainable).fit()
    assert all(r.metrics["step"] == 3 for r in list(grid) + list(grid2))
    return [[r.metrics_history for r in grid], [r.metrics for r in grid2], _trials(grid2)]


@scenario
def pbt_exploits(N, storage):
    def trainable(config):
        ckpt = N.tune.get_checkpoint()
        score = 0.0
        if ckpt is not None:
            with open(os.path.join(ckpt.to_directory(), "s.json")) as f:
                score = json.load(f)["score"]
        for _ in range(1, 13):
            score += config["rate"]
            d = tempfile.mkdtemp(dir=storage)
            with open(os.path.join(d, "s.json"), "w") as f:
                json.dump({"score": score}, f)
            N.tune.report({"score": score}, checkpoint=N.session.Checkpoint(d))

    os.makedirs(storage, exist_ok=True)
    pbt = N.tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"rate": N.tune.uniform(0.1, 2.0)})
    grid = N.tune.Tuner(
        trainable, param_space={"rate": N.tune.grid_search([0.1, 0.2, 1.5, 2.0])},
        tune_config=N.tune.TuneConfig(metric="score", mode="max", max_concurrent_trials=4,
                                      scheduler=pbt),
        run_config=N.train.RunConfig(name="pbt", storage_path=storage)).fit()
    scores = sorted(r.metrics.get("score", 0.0) for r in grid)
    assert scores[0] > 0.1 * 12 * 0.9, scores
    # which trial exploits which donor depends on the order the four report
    # in; that some did, and how every trial ends, does not
    exploited = sum(t.config["rate"] not in (0.1, 0.2, 1.5, 2.0) for t in grid._trials)
    return [[t.status for t in grid._trials], exploited > 0]


@scenario
def trainer_fit_routes_through_tune(N, storage):
    def loop(config):
        for i in range(3):
            N.train.report({"loss": 10.0 - i, "lr": config["lr"]})

    r = N.Trainer(loop, train_loop_config={"lr": 0.5},
                  scaling_config=N.train.ScalingConfig(num_workers=2),
                  run_config=N.train.RunConfig(name="fit_tune", storage_path=storage)).fit()
    state = os.path.join(storage, "fit_tune", "experiment_state.json")
    assert r.error is None and r.metrics == {"loss": 8.0, "lr": 0.5}
    return [_result(r), os.path.exists(state)]


@scenario
def bayesopt_search_converges(N, storage):
    grid = N.tune.Tuner(
        _quadratic_for(N), param_space={"x": N.tune.uniform(0.0, 6.0)},
        tune_config=N.tune.TuneConfig(
            metric="loss", mode="min", num_samples=14, max_concurrent_trials=1,
            search_alg=N.search.BayesOptSearch(n_initial=4, candidates=256, seed=1)),
        run_config=N.train.RunConfig(name="bo", storage_path=storage)).fit()
    assert len(grid) == 14 and not grid.errors
    assert abs(grid.get_best_result("loss", "min").metrics["x"] - 3.0) < 0.5
    return _trials(grid)


@scenario
def bayesopt_handles_mixed_space(N, storage):
    def trainable(config):
        base = (config["x"] - 2.0) ** 2 + config["layers"]
        if config["act"] == "gelu":
            base -= 0.5
        N.tune.report({"loss": base, "x": config["x"]})

    grid = N.tune.Tuner(
        trainable, param_space={"x": N.tune.uniform(0.0, 4.0), "layers": N.tune.randint(1, 4),
                                "act": N.tune.choice(["relu", "gelu"])},
        tune_config=N.tune.TuneConfig(
            metric="loss", mode="min", num_samples=8, max_concurrent_trials=1,
            search_alg=N.search.BayesOptSearch(n_initial=3, candidates=128, seed=0)),
        run_config=N.train.RunConfig(name="bo-mixed", storage_path=storage)).fit()
    assert len(grid) == 8 and not grid.errors
    return _trials(grid)


@scenario
def concurrency_limiter_bounds_inflight(N, storage):
    grid = N.tune.Tuner(
        _quadratic_for(N), param_space={"x": N.tune.uniform(0.0, 6.0)},
        tune_config=N.tune.TuneConfig(
            metric="loss", mode="min", num_samples=6, max_concurrent_trials=4,
            search_alg=N.search.ConcurrencyLimiter(N.search.BasicVariantGenerator(num_samples=6),
                                                   max_concurrent=2)),
        run_config=N.train.RunConfig(name="limit", storage_path=storage)).fit()
    assert len(grid) == 6 and not grid.errors
    return sorted((t.trial_id, t.config["x"], t.status) for t in grid._trials)


@scenario
def median_stopping_rule_stops_stragglers(N, storage):
    def trainable(config):
        for i in range(8):
            N.tune.report({"loss": config["base"] - 0.1 * i})

    grid = N.tune.Tuner(
        trainable, param_space={"base": N.tune.grid_search([1.0, 1.1, 1.2, 9.0])},
        tune_config=N.tune.TuneConfig(
            metric="loss", mode="min", num_samples=1, max_concurrent_trials=1,
            scheduler=N.tune.MedianStoppingRule(metric="loss", mode="min", grace_period=2,
                                                min_samples_required=2)),
        run_config=N.train.RunConfig(name="median", storage_path=storage)).fit()
    statuses = {t.config["base"]: t.status for t in grid._trials}
    assert statuses[9.0] == "STOPPED" and statuses[1.0] == "TERMINATED"
    return _trials(grid)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_result_in_both_packages(on_both, name):
    jax_result, port_result = on_both(SCENARIOS[name])
    assert port_result == jax_result


# ------------------------------------------------------- the tiny Llama, trained


JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32, remat=None, attention_impl="reference")
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=20)
STEPS = 4


def _tokens():
    tokens = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jax_train_fn(config):
    """tests/test_train.py's tiny-Llama loop inside TpuTrainer."""
    from ray_tpu.train import session as s

    tokens, targets = map(jnp.asarray, _tokens())
    opt = js.default_optimizer(**OPT)
    state = js.make_train_state_factory(JCFG, opt)(jax.random.key(0))
    step_fn = js.make_train_step(JCFG, opt, donate=False)
    with jax.default_matmul_precision("highest"):
        for i in range(STEPS):
            state, metrics = step_fn(state, tokens, targets)
            s.report({"step": i, "loss": float(metrics["loss"])})


def _port_train_fn(state, crash_at=None):
    """The same loop through the port's step inside GpuTrainer, from
    ``state`` (converted from the JAX init). Each step saves the TrainState
    with torch.save and reports it as a checkpoint; a run that finds one
    resumes from it. With ``crash_at``, the first attempt raises there."""
    def train_fn(config):
        from ray_tpu_torch.train import session as s

        cfg = tl.LlamaConfig.tiny(dtype=torch.float32, remat=None)
        step_fn = ts.make_train_step(cfg, ts.default_optimizer(**OPT))
        tokens, targets = map(torch.from_numpy, _tokens())
        st, start = state, 0
        ckpt = s.get_checkpoint()
        if ckpt is not None:
            st = torch.load(os.path.join(ckpt.path, "state.pt"), weights_only=False)
            start = st.step
        for i in range(start, STEPS):
            if i == crash_at and ckpt is None:
                raise RuntimeError("simulated crash")
            st, metrics = step_fn(st, tokens, targets)
            with tempfile.TemporaryDirectory() as d:
                torch.save(st, os.path.join(d, "state.pt"))
                s.report({"step": i, "loss": metrics["loss"].item()},
                         checkpoint=s.Checkpoint.from_directory(d))
    return train_fn


def _initial_port_state():
    jstate = js.make_train_state_factory(JCFG, js.default_optimizer(**OPT))(jax.random.key(0))
    return ts.train_state_from_jax(jstate)


def _fit_port(train_fn, storage, name, **run_kw):
    from ray_tpu_torch.train import GpuTrainer, RunConfig, ScalingConfig

    return GpuTrainer(train_fn, scaling_config=ScalingConfig(num_workers=1, cpus_per_worker=2),
                      run_config=RunConfig(name=name, storage_path=storage, **run_kw)).fit()


def test_train_tiny_llama_e2e(tmp_path):
    """tests/test_train.py's end-to-end case: the JAX step inside TpuTrainer
    and the port's inside GpuTrainer, from the same weights."""
    from ray_tpu.train import RunConfig, ScalingConfig, TpuTrainer

    _shutdown_all()
    try:
        ray_tpu.init(num_cpus=8)
        want = TpuTrainer(_jax_train_fn, scaling_config=ScalingConfig(num_workers=1, cpus_per_worker=2),
                          run_config=RunConfig(name="llama", storage_path=str(tmp_path))).fit()
        ray_tpu.shutdown()
        ray_tpu_torch.init(num_cpus=8)
        got = _fit_port(_port_train_fn(_initial_port_state()), str(tmp_path / "port"), "llama")
    finally:
        _shutdown_all()
    assert want.error is None and got.error is None, (want.error, got.error)
    want_losses = [m["loss"] for m in want.metrics_history]
    got_losses = [m["loss"] for m in got.metrics_history]
    assert [m["step"] for m in got.metrics_history] == list(range(STEPS))
    np.testing.assert_allclose(got_losses, want_losses, atol=LOSS_ATOL, rtol=LOSS_RTOL)
    assert got_losses[-1] < got_losses[0]


def test_restart_from_checkpoint_matches_an_uninterrupted_run(port):
    """FailureConfig(max_failures=1): the first attempt saves a TrainState
    after steps 0 and 1 and crashes before step 2; the second resumes from
    the checkpoint, and its losses equal an uninterrupted run's (the same
    CPU arithmetic: bit-equal)."""
    from ray_tpu_torch.train import FailureConfig

    state = _initial_port_state()
    whole = _fit_port(_port_train_fn(state), port, "whole")
    resumed = _fit_port(_port_train_fn(state, crash_at=2), port, "resumed",
                        failure_config=FailureConfig(max_failures=1))
    assert whole.error is None and resumed.error is None, (whole.error, resumed.error)
    assert [m["step"] for m in resumed.metrics_history] == list(range(STEPS))
    assert [m["loss"] for m in resumed.metrics_history] == [m["loss"] for m in whole.metrics_history]
    assert os.path.basename(resumed.checkpoint.path) == f"checkpoint_{STEPS - 1}_rank0"


# ----------------------------------------------------------------- port only


def test_scaling_config_asks_for_gpus():
    from ray_tpu_torch.train import ScalingConfig

    assert ScalingConfig().worker_resources() == {"CPU": 1.0}
    assert ScalingConfig(use_gpu=True).worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig(gpus_per_worker=2, num_workers=2).bundles() == [
        {"CPU": 1.0, "GPU": 2.0}, {"CPU": 1.0, "GPU": 2.0}]


def test_use_gpu_fit_without_a_card_is_infeasible(port):
    """Without a card, a use_gpu fit returns the infeasible placement group
    as its error: the train function never runs on the CPU."""
    if torch.cuda.device_count():
        pytest.skip("a CUDA device is present")
    from ray_tpu_torch.train import GpuTrainer, RunConfig, ScalingConfig

    ran = os.path.join(port, "ran")

    def train_fn(config):
        open(ran, "w").close()

    r = GpuTrainer(train_fn, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                   run_config=RunConfig(name="gpu", storage_path=port)).fit()
    assert type(r.error).__name__ == "PlacementGroupError", r.error
    assert "Infeasible placement group" in str(r.error) and "GPU" in str(r.error)
    assert not os.path.exists(ran) and r.metrics_history == []


def test_torch_distributed_at_world_size_1_on_gloo(port):
    """use_torch_distributed with one CPU worker: the worker forms a gloo
    group from worker 0's address, the train function sees it, and the
    group is destroyed when the fit ends."""
    from ray_tpu_torch.train import GpuTrainer, RunConfig, ScalingConfig

    assert not dist.is_initialized()

    def train_fn(config):
        from ray_tpu_torch.train import session as s

        t = torch.tensor([3.0])
        dist.all_reduce(t)
        s.report({"backend": dist.get_backend(), "world": dist.get_world_size(),
                  "rank": dist.get_rank(), "sum": t.item()})

    r = GpuTrainer(train_fn, scaling_config=ScalingConfig(num_workers=1),
                   run_config=RunConfig(name="dist", storage_path=port),
                   use_torch_distributed=True).fit()
    assert r.error is None, r.error
    assert r.metrics == {"backend": "gloo", "world": 1, "rank": 0, "sum": 3.0}
    assert not dist.is_initialized()


def test_torch_distributed_with_two_in_process_workers_raises(port):
    from ray_tpu_torch.train import GpuTrainer, RunConfig, ScalingConfig

    ran = []
    trainer = GpuTrainer(lambda: ran.append(1), scaling_config=ScalingConfig(num_workers=2),
                         run_config=RunConfig(name="two", storage_path=port),
                         use_torch_distributed=True)
    before = ray_tpu_torch.available_resources()["CPU"]
    with pytest.raises(ValueError, match="num_workers=2"):
        trainer.fit()
    assert not ran and ray_tpu_torch.available_resources()["CPU"] == before
    assert not dist.is_initialized()
