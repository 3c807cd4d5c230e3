"""Tests of the benchmark's harness. Run them from the checkout's root:

    python -m pytest perfbench/tests -q

``cuda``-marked tests need the card and skip here; on the card run
``python -m pytest perfbench/tests -q -m cuda``."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


TINY = {"source": "tiny", "hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32, "vocab_size": 512,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
        "sliding_window": None, "dtype": "bfloat16"}


def shrink(workload: dict) -> dict:
    """A cell's workload at a size the CPU runs in seconds; every setting
    the driver reads is kept, only sizes change."""
    import copy

    wl = copy.deepcopy(workload)
    if wl["driver"].startswith("serve"):
        wl["engine"].update(num_slots=8, max_seq_len=192, total_pages=None, page_size=16,
                            prefill_buckets=[64, 128], decode_chunk=4)
        wl["traffic"].update(prompt={"kind": "log_uniform", "min": 16, "max": 128},
                             output={"kind": "uniform", "min": 8, "max": 48}, block=16,
                             requests=400)
        if "clients" in wl["traffic"]:
            wl["traffic"]["clients"] = 8
            # a first-round prompt holds up to 48 tokens already produced; the
            # largest bucket is the whole context, as in the cell
            wl["engine"]["prefill_buckets"] = [64, 128, 192]
        else:
            wl["traffic"]["arrivals"]["rate"] = 4.0
            wl.update(ramp_seconds=1.0, drain_seconds=30)
        wl["trace_seconds"] = 1.0
        wl["check"] = {"min_tokens": 60, "max_requests": 3}
    else:
        wl["step"].update(batch=2, seq=64, trace_steps=2, trace_seconds=0.5)
    return wl


@pytest.fixture
def tiny():
    return dict(TINY)
