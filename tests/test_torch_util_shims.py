"""The port's util shims (``ray_tpu_torch.util``: ``ActorPool``, the
distributed ``Queue``, ``multiprocessing.Pool`` and the joblib backend)
held against the JAX package's.

Each scenario of ``tests/test_util.py`` and ``tests/test_util_shims.py`` is
written once, as a function of the package, runs on each package's fresh
in-process runtime in turn with the reference test's own assertions, and
both must give the same observable result. joblib is optional: its case
skips without it (the port imports it only inside ``register_ray_tpu``).
Every wait is 30 s at most.
"""

import importlib
import time

import pytest

import ray_tpu
import ray_tpu_torch

PACKAGES = (ray_tpu, ray_tpu_torch)


def _mod(P, name):
    return importlib.import_module(f"{P.__name__}.{name}")


def _shutdown_all():
    for P in PACKAGES:
        if P.is_initialized():
            P.shutdown()


@pytest.fixture
def on_both():
    """``run(fn)`` runs ``fn(P)`` on ray_tpu's in-process runtime, then on
    ray_tpu_torch's, and returns both results."""
    _shutdown_all()

    def run(fn):
        out = []
        for P in PACKAGES:
            P.init(num_cpus=8)
            try:
                out.append(fn(P))
            finally:
                P.shutdown()
        return out

    yield run
    _shutdown_all()


def _same(results):
    jax_result, port_result = results
    assert port_result == jax_result
    return port_result


class _Doubler:
    def double(self, v):
        return 2 * v

    def slow_double(self, v):
        time.sleep(0.05 * (3 - v % 3))
        return 2 * v


def _pool(P, n=2):
    Doubler = P.remote(_Doubler)
    return _mod(P, "util").ActorPool([Doubler.remote() for _ in range(n)])


# ------------------------------------------------------- tests/test_util.py
def test_map_ordered(on_both):
    def fn(P):
        return list(_pool(P).map(lambda a, v: a.double.remote(v), range(6)))

    assert _same(on_both(fn)) == [0, 2, 4, 6, 8, 10]


def test_map_unordered(on_both):
    def fn(P):
        return sorted(_pool(P).map_unordered(lambda a, v: a.slow_double.remote(v), range(6)))

    assert _same(on_both(fn)) == [0, 2, 4, 6, 8, 10]


def test_submit_backlog_exceeds_pool(on_both):
    def fn(P):
        pool = _pool(P)
        # more submissions than actors: the backlog drains as actors free up
        for v in range(10):
            pool.submit(lambda a, v: a.double.remote(v), v)
        results = []
        while pool.has_next():
            results.append(pool.get_next())
        return results

    assert _same(on_both(fn)) == [2 * v for v in range(10)]


def test_mixed_ordered_unordered(on_both):
    def fn(P):
        pool = _pool(P)
        for v in range(4):
            pool.submit(lambda a, v: a.double.remote(v), v)
        first_unordered = pool.get_next_unordered()
        rest = []
        while pool.has_next():
            rest.append(pool.get_next())
        return sorted(rest + [first_unordered])

    assert _same(on_both(fn)) == [0, 2, 4, 6]


def test_get_next_empty_raises(on_both):
    def fn(P):
        with pytest.raises(StopIteration):
            _pool(P).get_next()
        return True

    assert _same(on_both(fn))


def test_push_and_idle(on_both):
    def fn(P):
        Doubler = P.remote(_Doubler)
        a, b = Doubler.remote(), Doubler.remote()
        pool = _mod(P, "util").ActorPool([a])
        out = [pool.has_free()]
        idle = pool.pop_idle()
        out += [idle is not None, pool.has_free()]
        pool.push(idle)
        pool.push(b)
        out += [pool.has_free(),
                list(pool.map(lambda ac, v: ac.double.remote(v), range(4)))]
        return out

    assert _same(on_both(fn)) == [True, True, False, True, [0, 2, 4, 6]]


# ------------------------------------------------- tests/test_util_shims.py
def test_queue_fifo_roundtrip(on_both):
    def fn(P):
        q = _mod(P, "util").Queue()
        for i in range(5):
            q.put(i)
        out = [[q.get(timeout=30) for _ in range(5)], q.empty()]
        q.shutdown()
        return out

    assert _same(on_both(fn)) == [[0, 1, 2, 3, 4], True]


def test_queue_nowait_and_maxsize(on_both):
    def fn(P):
        util = _mod(P, "util")
        q = util.Queue(maxsize=2)
        q.put(1)
        q.put(2)
        out = [q.full()]
        with pytest.raises(util.Full):
            q.put_nowait(3)
        out.append(q.get_nowait())
        with pytest.raises(util.Empty):
            util.Queue().get_nowait()
        q.shutdown()
        return out

    assert _same(on_both(fn)) == [True, 1]


def test_queue_get_timeout(on_both):
    def fn(P):
        util = _mod(P, "util")
        q = util.Queue()
        t0 = time.perf_counter()
        with pytest.raises(util.Empty):
            q.get(timeout=0.3)
        q.shutdown()
        return time.perf_counter() - t0 < 10

    assert _same(on_both(fn)) is True


def test_queue_cross_task_producer_consumer(on_both):
    def fn(P):
        q = _mod(P, "util").Queue()

        @P.remote
        def producer(q, n):
            for i in range(n):
                q.put(i)
            return n

        ref = producer.remote(q, 10)
        got = sorted(q.get(timeout=30) for _ in range(10))
        out = [got, P.get(ref, timeout=30)]
        q.shutdown()
        return out

    assert _same(on_both(fn)) == [list(range(10)), 10]


def _sq(x):
    return x * x


def _pool_cls(P):
    return _mod(P, "util.multiprocessing").Pool


def test_pool_map_and_apply(on_both):
    def fn(P):
        with _pool_cls(P)(processes=2) as p:
            return p.map(_sq, range(8)), p.apply(_sq, (7,))

    assert _same(on_both(fn)) == ([x * x for x in range(8)], 49)


def test_pool_starmap_and_async(on_both):
    def fn(P):
        with _pool_cls(P)(processes=2) as p:
            out = [p.starmap(lambda a, b: a + b, [(1, 2), (3, 4)])]
            r = p.map_async(_sq, [1, 2, 3])
            out += [r.get(timeout=30), r.ready()]
            return out

    assert _same(on_both(fn)) == [[3, 7], [1, 4, 9], True]


def test_pool_imap_orders_results(on_both):
    def fn(P):
        with _pool_cls(P)(processes=2) as p:
            return list(p.imap(_sq, [3, 1, 2])), sorted(p.imap_unordered(_sq, [3, 1, 2]))

    assert _same(on_both(fn)) == ([9, 1, 4], [1, 4, 9])


def test_pool_initializer_runs_per_worker(on_both):
    def fn(P):
        def init(v):
            import os

            os.environ["_POOL_INIT"] = str(v)

        def read(_):
            import os

            return os.environ.get("_POOL_INIT")

        with _pool_cls(P)(processes=2, initializer=init, initargs=(7,)) as p:
            return set(p.map(read, range(4)))

    assert _same(on_both(fn)) == {"7"}


def test_pool_closed_rejects_work(on_both):
    def fn(P):
        p = _pool_cls(P)(processes=1)
        p.close()
        with pytest.raises(ValueError):
            p.map(_sq, [1])
        p.terminate()
        return True

    assert _same(on_both(fn))


def test_joblib_backend(on_both):
    joblib = pytest.importorskip("joblib")

    def fn(P):
        _mod(P, "util.joblib").register_ray_tpu()
        # each package registers its own backend name
        with joblib.parallel_backend(P.__name__, n_jobs=2):
            return joblib.Parallel()(joblib.delayed(_sq)(i) for i in range(6))

    assert _same(on_both(fn)) == [0, 1, 4, 9, 16, 25]


def test_joblib_is_imported_lazily():
    """Port only: importing the shim needs no joblib (the card machine may
    not have it)."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['joblib'] = None\n"
            "import ray_tpu_torch.util.joblib as j\n"
            "try:\n    j.register_ray_tpu()\nexcept ImportError:\n    print('lazy')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60)
    assert out.stdout.strip() == "lazy", out.stderr
