"""The port's operator shell (``python -m ray_tpu_torch``: the CLI, the job
SDK, the state API) held against the JAX package's (``python -m ray_tpu``,
``tests/test_ops_shell.py``).

Each scenario of ``tests/test_ops_shell.py`` is written once, as a function
of the package, and runs on a cluster that the JAX package's CLI started and
then on one that the port's CLI started (one 2-CPU head each, for the
module, each CLI under its own temp ``HOME``, no fixed port); both must give
the same observable result, with the reference test's own assertions.
Port-only: the session file's place, ``start --num-gpus`` without a card,
and a ``num_gpus=1`` task that stays pending where there is no card. Added:
``serve deploy/status/rollback`` from YAML files through both CLIs. Every
wait has a timeout of 120 s at most.
"""

import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
import time

import pytest

import ray_tpu
import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (ray_tpu, ray_tpu_torch)
# each CLI's session file, under its HOME
SESSION = {"ray_tpu": (".ray_tpu", "session"), "ray_tpu_torch": (".ray_tpu_torch", "session")}
# each package's importable serve apps (tests/serve_app_fixture.py and its copy)
SERVE_FIXTURE = {"ray_tpu": "tests.serve_app_fixture",
                 "ray_tpu_torch": "tests.torch_serve_app_fixture"}


def _mod(P, name):
    return importlib.import_module(f"{P.__name__}.{name}")


def _cli(P, *args, env, timeout=120):
    e = dict(os.environ)
    e.update(env)
    return subprocess.run(
        [sys.executable, "-m", P.__name__, *args],
        capture_output=True, text=True, timeout=timeout, env=e, cwd=REPO,
    )


def _start(P, home, *args):
    """``start --head`` through P's CLI under ``home`` (its session dir
    there too); returns (address, env)."""
    # CUDA_VISIBLE_DEVICES="": the head of a machine with a card takes none
    env = {"HOME": str(home), "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""}
    r = _cli(P, "start", "--head", "--session-dir", str(home / "session"), *args, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(home.joinpath(*SESSION[P.__name__])) as f:
        return json.load(f)["gcs_address"], env


@pytest.fixture(scope="module")
def cli_clusters(tmp_path_factory):
    """A cluster of each package started through its CLI, as an operator
    would: {package name: (address, env, home)}."""
    for P in PACKAGES:
        if P.is_initialized():
            P.shutdown()
    started = {}
    try:
        for P in PACKAGES:
            home = tmp_path_factory.mktemp(f"home_{P.__name__}")
            address, env = _start(P, home, "--num-cpus", "2")
            started[P.__name__] = (address, env, home)
        yield started
    finally:
        for P in PACKAGES:
            if P.is_initialized():
                P.shutdown()
        for name, (_, env, _) in started.items():
            _cli(importlib.import_module(name), "stop", env=env)


@pytest.fixture
def on_both(cli_clusters):
    """``run(fn)`` runs ``fn(P, address, env)`` on ray_tpu's cluster, then on
    ray_tpu_torch's, and returns both results."""
    def run(fn):
        return [fn(P, *cli_clusters[P.__name__][:2]) for P in PACKAGES]
    return run


def _same(on_both, fn):
    jax_result, port_result = on_both(fn)
    assert port_result == jax_result
    return port_result


def _client(P, address):
    return _mod(P, "job.sdk").JobSubmissionClient(address)


# --------------------------------------------------- tests/test_ops_shell.py
def test_cli_start_status_stop(on_both):
    def fn(P, address, env):
        r = _cli(P, "status", "--address", address, env=env)
        assert r.returncode == 0, r.stdout + r.stderr
        return "nodes alive:     1" in r.stdout, "CPU" in r.stdout

    assert _same(on_both, fn) == (True, True)


def test_state_api_lists(on_both):
    def fn(P, address, env):
        P.init(address=address, ignore_reinit_error=True)
        try:
            state = _mod(P, "util.state")

            @P.remote
            class Sentinel:
                def ping(self):
                    return "pong"

            s = Sentinel.options(name="state-sentinel").remote()
            assert P.get(s.ping.remote(), timeout=60) == "pong"
            ref = P.put({"state": "api"})
            logs = state.list_logs()
            return (any(n["Alive"] for n in state.list_nodes()),
                    any(a.get("name") == "state-sentinel" for a in state.list_actors()),
                    any(o["object_id"] == ref.id.hex() for o in state.list_objects()),
                    isinstance(state.list_tasks(), list),
                    state.cluster_summary()["nodes"] >= 1,
                    any(name.endswith(".log") for name in logs),
                    isinstance(state.get_log(logs[0]), bytes))
        finally:
            P.shutdown()

    assert _same(on_both, fn) == (True,) * 7


def test_job_submission_roundtrip(on_both, tmp_path):
    def fn(P, address, env):
        script = tmp_path / f"job_script_{P.__name__}.py"
        script.write_text(textwrap.dedent("""
            import sys
            sys.path.insert(0, %r)
            import %s as P

            P.init()  # picks up RAY_TPU_ADDRESS from the job env

            @P.remote
            def square(x):
                return x * x

            print("RESULT:", sum(P.get([square.remote(i) for i in range(5)], timeout=120)))
            P.shutdown()
        """ % (REPO, P.__name__)))
        client = _client(P, address)
        try:
            job_id = client.submit_job(f"{sys.executable} {script}")
            status = client.wait_until_finished(job_id, timeout=120)
            logs = client.get_job_logs(job_id)
            assert status == _mod(P, "job.sdk").JobStatus.SUCCEEDED, logs
            return (status, "RESULT: 30" in logs,
                    any(j["job_id"] == job_id for j in client.list_jobs()),
                    any(j["job_id"] == job_id for j in _list_jobs_cli(P, address, env)))
        finally:
            client.close()

    assert _same(on_both, fn) == ("SUCCEEDED", True, True, True)


def _list_jobs_cli(P, address, env):
    r = _cli(P, "list", "jobs", "--address", address, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout)


def test_job_failure_reported(on_both, tmp_path):
    script = tmp_path / "bad_job.py"
    script.write_text("import sys; print('about to fail'); sys.exit(3)\n")

    def fn(P, address, env):
        client = _client(P, address)
        try:
            job_id = client.submit_job(f"{sys.executable} {script}")
            status = client.wait_until_finished(job_id, timeout=60)
            info = client.get_job_info(job_id)
            return status, info["returncode"], "about to fail" in client.get_job_logs(job_id)
        finally:
            client.close()

    assert _same(on_both, fn) == ("FAILED", 3, True)


def test_job_stop_reports_stopped(on_both, tmp_path):
    script = tmp_path / "sleepy_job.py"
    script.write_text("import time; print('sleeping', flush=True); time.sleep(60)\n")

    def fn(P, address, env):
        client = _client(P, address)
        try:
            job_id = client.submit_job(f"{sys.executable} {script}")
            time.sleep(1.0)
            stopped = client.stop_job(job_id)
            return stopped, client.wait_until_finished(job_id, timeout=30)
        finally:
            client.close()

    assert _same(on_both, fn) == (True, "STOPPED")


def test_job_log_stream_past_tail_window(on_both, tmp_path):
    """Logs larger than the 64KiB tail window must stream completely via the
    absolute-offset reader."""
    script = tmp_path / "chatty_job.py"
    script.write_text(
        "for i in range(3000):\n"
        "    print(f'line-{i:05d} ' + 'x' * 40)\n"
    )  # ~140KB of output

    def fn(P, address, env):
        client = _client(P, address)
        try:
            job_id = client.submit_job(f"{sys.executable} {script}")
            client.wait_until_finished(job_id, timeout=120)
            text, offset = "", 0
            while True:
                chunk, offset = client.read_job_logs_from(job_id, offset)
                if not chunk:
                    break
                text += chunk
            return "line-00000" in text and "line-02999" in text, len(text)
        finally:
            client.close()

    found, size = _same(on_both, fn)
    assert found and size > 100_000


def test_cli_submit_streams_logs(on_both, tmp_path):
    script = tmp_path / "hello_job.py"
    script.write_text("print('hello from the job')\n")

    def fn(P, address, env):
        r = _cli(P, "submit", "--address", address, "--", sys.executable, str(script),
                 env=env, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
        job_id = r.stdout.split()[1].rstrip(":")
        logs = _cli(P, "logs", job_id, "--address", address, env=env)
        return ("hello from the job" in r.stdout, "SUCCEEDED" in r.stdout,
                logs.stdout == "hello from the job\n")

    assert _same(on_both, fn) == (True, True, True)


# ------------------------------------------------------------------- serve
def test_serve_deploy_status_rollback_from_yaml(on_both, tmp_path):
    """``serve deploy`` of two YAML configs, ``serve status`` after each, and
    ``serve rollback`` to the first, through each CLI. The test's driver
    starts serve without HTTP first, so no proxy takes a fixed port."""
    def fn(P, address, env):
        fixture = SERVE_FIXTURE[P.__name__]
        cfgs = []
        for i, apps in enumerate(([("adder", "adder_app")],
                                  [("adder", "adder_app"), ("adder100", "build_adder")])):
            path = tmp_path / f"serve_{P.__name__}_{i}.yaml"
            path.write_text("applications:\n" + "".join(
                f"  - name: {name}\n    import_path: {fixture}:{attr}\n" for name, attr in apps))
            cfgs.append(str(path))

        def status():
            """The config's apps and each app's running replicas, once every
            configured app runs one (rollback does not wait for readiness)."""
            deadline = time.monotonic() + 60
            while True:
                r = _cli(P, "serve", "status", "--address", address, env=env)
                assert r.returncode == 0, r.stdout + r.stderr
                out = json.loads(r.stdout)
                names = [a["name"] for a in out["config"]["applications"]]
                running = {name: app["running_replicas"]
                           for name, app in out["applications"].items()}
                if set(running) == set(names) and all(running.values()):
                    return names, running
                if time.monotonic() > deadline:
                    return names, running
                time.sleep(0.2)

        P.init(address=address, ignore_reinit_error=True)
        serve = _mod(P, "serve")
        serve.start(http=False)
        try:
            seen = []
            for path in cfgs:
                r = _cli(P, "serve", "deploy", path, "--address", address, env=env)
                assert r.returncode == 0, r.stdout + r.stderr
                seen += [json.loads(r.stdout), status()]
            r = _cli(P, "serve", "rollback", "--address", address, env=env)
            assert r.returncode == 0, r.stdout + r.stderr
            seen += [json.loads(r.stdout), status()]
            return seen
        finally:
            serve.shutdown()
            P.shutdown()

    got = _same(on_both, fn)
    assert got[0] == {"deployed": ["adder"], "errors": {}}
    assert got[3] == (["adder", "adder100"], {"adder": 1, "adder100": 1})
    assert got[5] == (["adder"], {"adder": 1})


# -------------------------------------------------------------- port only
def test_session_file_is_the_ports_own(tmp_path):
    """The port's CLI keeps its session under ~/.ray_tpu_torch and, unless
    told, its session dir under $TMPDIR/ray_tpu_torch; nothing under
    ~/.ray_tpu."""
    env = {"HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""}
    r = _cli(ray_tpu_torch, "start", "--head", "--num-cpus", "1", env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(tmp_path / ".ray_tpu_torch" / "session") as f:
        session = json.load(f)
    try:
        assert session["session_dir"].startswith(
            os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "session-"))
        assert f"GCS at {session['gcs_address']}" in r.stdout
        assert not (tmp_path / ".ray_tpu").exists()
    finally:
        assert _cli(ray_tpu_torch, "stop", env=env).returncode == 0
        shutil.rmtree(session["session_dir"], ignore_errors=True)


def test_start_num_gpus_without_a_card(tmp_path):
    """``start --num-gpus 1`` on a machine without a card advertises the
    count it was given; ``stop`` ends the session's processes."""
    address, env = _start(ray_tpu_torch, tmp_path, "--num-cpus", "1", "--num-gpus", "1")
    with open(tmp_path / ".ray_tpu_torch" / "session") as f:
        pids = json.load(f)["pids"]
    try:
        r = _cli(ray_tpu_torch, "status", "--address", address, env=env)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "GPU                  1.0 / 1.0" in r.stdout, r.stdout
        assert "TPU" not in r.stdout
    finally:
        r = _cli(ray_tpu_torch, "stop", env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert not (tmp_path / ".ray_tpu_torch" / "session").exists()
    for pid in pids:
        assert _gone(pid), pid


def _gone(pid, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return True
        except OSError:
            return True
        time.sleep(0.05)
    return False


def test_gpu_task_without_a_card_stays_pending(cli_clusters):
    """On the CLI's cluster without a card (its head started under
    CUDA_VISIBLE_DEVICES=""), a num_gpus=1 task never runs on the CPU."""
    address = cli_clusters["ray_tpu_torch"][0]
    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    try:
        assert "GPU" not in ray_tpu_torch.cluster_resources()

        @ray_tpu_torch.remote(num_gpus=1)
        def needs_card():
            return "ran"

        ref = needs_card.remote()
        with pytest.raises(ray_tpu_torch.exceptions.GetTimeoutError):
            ray_tpu_torch.get(ref, timeout=1)
        assert ray_tpu_torch.wait([ref], timeout=0.2)[0] == []
    finally:
        ray_tpu_torch.shutdown()
