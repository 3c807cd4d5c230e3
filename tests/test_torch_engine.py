"""Port parity, serving: ray_tpu_torch.serve.llm.LLMEngine(device="cpu")
against ray_tpu.serve.llm.LLMEngine on the same converted weights (fp32,
tiny config): the same greedy tokens for the same requests, paged and
dense."""

import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.llama import LlamaConfig as JConfig
from ray_tpu.models.llama import llama_init as j_llama_init
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu_torch.models.llama import LlamaConfig as TConfig
from ray_tpu_torch.models.llama import params_from_jax
from ray_tpu_torch.serve.llm import LLMDeployment, LLMEngine

ENGINE_KW = dict(num_slots=2, decode_chunk=4, max_seq_len=64, prefill_buckets=[16, 32],
                 page_size=16)
PROMPTS = [[3, 14, 15, 92, 65, 35], [1, 2, 3], [200, 17, 9, 9, 41, 5, 77, 3, 2, 8, 1, 90, 4],
           list(range(20, 45)), [7]]
MAX_TOKENS = [8, 6, 5, 7, 9]


def _run(engine):
    with cf.ThreadPoolExecutor(max_workers=len(PROMPTS)) as pool:
        futs = [pool.submit(engine.generate, p, n, None, 120)
                for p, n in zip(PROMPTS, MAX_TOKENS)]
        return [f.result()["tokens"] for f in futs]


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig.tiny(dtype=jnp.float32, remat=None, attention_impl="reference")
    jparams = j_llama_init(jcfg, jax.random.key(1))
    return jcfg, jparams, TConfig.tiny(dtype=torch.float32), params_from_jax(jparams)


@pytest.mark.parametrize("paged", [True, False])
def test_engine_greedy_tokens_match_jax(weights, paged):
    jcfg, jparams, tcfg, tparams = weights
    jeng = JEngine(jcfg, jparams, paged=paged, **ENGINE_KW)
    try:
        with jax.default_matmul_precision("highest"):
            want = _run(jeng)
    finally:
        jeng.stop()
    teng = LLMEngine(tcfg, tparams, device="cpu", paged=paged, **ENGINE_KW)
    try:
        got = _run(teng)
        stats = teng.stats()
    finally:
        teng.stop()
    assert not teng._thread.is_alive()
    assert got == want, (got, want)
    assert [len(t) for t in got] == MAX_TOKENS
    assert stats["tokens_generated"] == sum(MAX_TOKENS)
    assert stats["prefill_programs"] >= (2 if paged else len(PROMPTS))


def test_engine_stream_and_eos(weights):
    _, _, tcfg, tparams = weights
    eng = LLMEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    try:
        full = eng.generate(PROMPTS[0], max_tokens=8, timeout=120)
        assert full["ttft_s"] > 0 and full["latency_s"] >= full["ttft_s"]
        events = list(eng.generate_stream(PROMPTS[0], max_tokens=8, timeout=120))
        assert [e["token"] for e in events[:-1]] == full["tokens"]
        assert events[-1]["done"] and events[-1]["num_tokens"] == 8
        eos = full["tokens"][2]
        cut = eng.generate(PROMPTS[0], max_tokens=8, eos_token=eos, timeout=120)
        assert cut["tokens"] == full["tokens"][: full["tokens"].index(eos) + 1]
    finally:
        eng.stop()


def test_engine_rejects_oversized_requests(weights):
    _, _, tcfg, tparams = weights
    eng = LLMEngine(tcfg, tparams, device="cpu", total_pages=3, **ENGINE_KW)
    try:
        with pytest.raises(ValueError, match="exceeds max_seq_len"):
            eng.generate([1] * 60, max_tokens=8)
        with pytest.raises(ValueError, match="KV pages"):
            eng.generate([1] * 30, max_tokens=20, timeout=60)  # needs 4 pages, pool has 2
        assert len(eng.generate([1, 2], max_tokens=3, timeout=60)["tokens"]) == 3
    finally:
        eng.stop()


def test_deployment_wraps_engine():
    dep = LLMDeployment(model="tiny", num_slots=2, decode_chunk=2, max_seq_len=64,
                        device="cpu")
    try:
        out = dep({"tokens": [5, 6, 7], "max_tokens": 4, "timeout": 120})
        assert len(out["tokens"]) == 4
        assert dep.engine_stats()["tokens_generated"] == 4
        again = dep.generate({"tokens": [5, 6, 7], "max_tokens": 4, "timeout": 120})
        assert again["tokens"] == out["tokens"]  # greedy, seeded weights
    finally:
        dep.stop()
    with pytest.raises(ValueError, match="unknown model"):
        LLMDeployment(model="nope", device="cpu")


def test_engine_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(TConfig.tiny(dtype=torch.float32))
