"""The command the driver runs: with no card it prints no result and exits
non-zero, as it does in a directory that holds only BENCHMARK.json and the
benchmark's own files."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = BENCH["workloads"][0]["name"]
ARGS = ["--workload", CELL, "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]


def _no_card():
    import torch

    return not torch.cuda.is_available()


def test_no_card_no_result():
    if not _no_card():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
