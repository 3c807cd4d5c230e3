"""The yardstick's arithmetic against hand-worked values at each cell's
shapes, and against the bounds in PERF.md's table of kernels."""

import json
from pathlib import Path

import pytest

from perfbench import arith, harness
from perfbench.reference.llama import Dims

HERE = Path(__file__).resolve().parents[1]


def _dims(name):
    return harness.dims(json.loads((HERE / "configs" / f"{name}.json").read_text()))


def test_parameter_counts():
    # per layer: q,o 4096^2 each, k,v 4096*1024 each, 3 * 4096 * 14336, two norms
    per_layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336 + 2 * 4096
    assert per_layer == 218_112_000
    assert arith.num_params(_dims("mistral-7b-v0.3")) == 32 * per_layer + 2 * 32768 * 4096 + 4096
    assert arith.num_params(_dims("mistral-7b-v0.3")) == 7_248_023_552
    assert arith.num_params(_dims("mistral-7b-v0.3-stage8")) == 2_013_335_552


def test_train_flops_per_token():
    # 6 N + 6 L H S = 6 * 2,013,335,552 + 6 * 8 * 4096 * 4096
    m = _dims("mistral-7b-v0.3-stage8")
    assert arith.train_flops_per_token(m, 4096) == 12_080_013_312 + 805_306_368
    assert arith.train_flops_per_token(m, 16384) == 12_080_013_312 + 6 * 8 * 4096 * 16384


def test_serve_flops():
    m = _dims("mistral-7b-v0.3")
    n = 7_248_023_552 - 32768 * 4096  # the embedding table is a lookup
    assert arith.matmul_params(m) == n
    # a prompt of 3 tokens: 3 tokens x 2N plus 6 visible pairs x 4 x 32 layers x 32 heads x 128
    assert arith.prefill_flops(m, [3]) == 3 * 2.0 * n + 6 * 4.0 * 32 * 32 * 128
    # a decode token over 1000 cached rows
    assert arith.decode_flops(m, [1000]) == 2.0 * n + 1000 * 4.0 * 32 * 32 * 128


def test_k4_work_hand_worked():
    m = _dims("mistral-7b-v0.3")
    flops, nbytes = arith.k4_work(m, [100, 300])
    assert flops == 4.0 * 32 * 128 * 400
    # q and out (2 slots x 32 heads x 128) + K and V rows (400 x 8 heads x 128), bf16
    assert nbytes == 2 * (2 * 2 * 32 * 128 + 2 * 400 * 8 * 128)
    assert arith.bound_s(flops, nbytes) == nbytes / 3.35e12


def test_k1_work_counts_unpadded_prompts():
    m = _dims("mistral-7b-v0.3")
    flops, nbytes = arith.k1_work(m, [2, 3])
    assert flops == 4.0 * 32 * 128 * (3 + 6)
    assert nbytes == 2 * (2 * 5 * 32 * 128 + 2 * 5 * 8 * 128)


def test_flash_train_work_matches_the_kernel_table():
    # PERF.md's table: K1' 137.5 GFLOP (bound 0.13904 ms), K2 206.3, K3 275.0
    # at llama_1b's B8 S2048, 16 q heads over 4, D128, causal
    m = Dims(vocab=32000, hidden=2048, inter=5632, layers=22, heads=16, kv_heads=4,
             head_dim=128, rope_theta=1e4, eps=1e-5)
    w = arith.flash_train_work(m, 8, 2048)
    assert w["k1l"][0] / 1e9 == pytest.approx(137.5, abs=0.05)
    assert w["k2"][0] / 1e9 == pytest.approx(206.3, abs=0.05)
    assert w["k3"][0] / 1e9 == pytest.approx(275.0, abs=0.05)
    assert arith.bound_s(*w["k1l"]) * 1e3 == pytest.approx(0.13904, abs=5e-6)
    assert w["k1l"][1] / 1e9 == pytest.approx(0.236, abs=0.001)


def test_flash_train_work_at_the_train_cell():
    m = _dims("mistral-7b-v0.3-stage8")
    w = arith.flash_train_work(m, 4, 4096)
    assert w["k1l"][0] == 4.0 * 32 * 128 * 4 * (4096 * 4097 // 2)
