"""The operator's path on the card: a llama_1b job submitted through the
port's CLI runs on a GPU node that the autoscaler launched (chip_smoke.py's
ops_shell phase, (a)-(e), at llama_1b's width with 2 layers).

The references are the same actor's steps run in this process first: the
serve phase's engine settings over the serve phase's first 4 prompts, and 3
train steps at B8 S2048 from seed 0; the job's actor, in the autoscaled
node's GPU worker, must give the same tokens and bit-equal losses.

Marked ``cuda``: it skips without an NVIDIA card. On a machine with one
(and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ops_shell_gpu.py
"""

import gc
import os
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = 2


def test_job_through_the_cli_runs_on_an_autoscaled_gpu_node():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the job's actor runs on the autoscaled GPU node")
    sys.path.insert(0, REPO)
    import chip_smoke
    import ray_tpu_torch

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rng = torch.Generator().manual_seed(7)  # the serve phase's prompts
    prompts = [torch.randint(0, 32000, (n,), generator=rng).tolist() for n in (32, 64, 128, 256)]
    spec = {"layers": LAYERS, "prompts": prompts, "max_tokens": 64}
    here = chip_smoke.OpsShellActor()
    want_tokens = here.serve(spec)["tokens"]
    want_losses = here.train(spec)["losses"]
    del here
    gc.collect()
    torch.cuda.empty_cache()
    out, serve_launches, train_launches = chip_smoke.ops_shell_run(
        torch.cuda.get_device_name(0), LAYERS, want_tokens, want_losses, prompts)
    assert out["c"]["tokens_equal"] and out["c"]["losses_bit_equal"]
    assert serve_launches["flash_fwd"] > 0 and serve_launches["paged_attention"] > 0
    assert train_launches == {"flash_fwd_lse": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6}
