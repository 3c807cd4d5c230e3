"""One tiny cell end to end on the card, kernels and all (skips without one):
``python -m pytest perfbench/tests -q -m cuda``."""

import json
import time
from pathlib import Path

import pytest
import torch

from conftest import shrink
from perfbench import harness

HERE = Path(__file__).resolve().parents[1]
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
# head size 128 and a GQA group of 2, so the window runs K1 and K4
CARD_TINY = {"source": "tiny", "hidden_size": 512, "intermediate_size": 1024,
             "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
             "head_dim": 128, "vocab_size": 2048, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
             "tie_word_embeddings": False, "sliding_window": None, "dtype": "bfloat16"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_tiny_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    wl = shrink(harness.load_json(HERE / "workloads" / f"{cell}.json"))
    if wl["driver"].startswith("serve"):
        wl["engine"]["page_size"] = 64
        wl["engine"]["max_seq_len"] = 256
    limits = harness.load_json(HERE / "limits" / f"{cell}.json")
    run = harness.run_cell(cell, wl, CARD_TINY, limits, 2**31 + 7, 3.0, True,
                           torch.device("cuda", 0), time.perf_counter())
    result = harness.report(run, BENCH, 1)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]
    assert result["metrics"]
    assert harness.traced_problems(run, harness.cell_metrics(BENCH, cell, True),
                                   result["metrics"]) == []
