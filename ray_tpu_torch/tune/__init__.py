"""ray_tpu_torch.tune — hyperparameter search over the actor runtime (own
copy of ray_tpu.tune).

Reference capability: python/ray/tune (Tuner, search spaces, ASHA/PBT
schedulers, experiment checkpoint/resume). ``tune.report`` is the same
session plumbing as ``train.report`` (one trial == one training session),
so GpuTrainer-based trainables and plain functions share the code path.
"""

from ray_tpu_torch.train.session import get_checkpoint, report
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    BayesOptSearch,
    ConcurrencyLimiter,
    Searcher,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner

__all__ = [
    "ASHAScheduler",
    "BasicVariantGenerator",
    "BayesOptSearch",
    "ConcurrencyLimiter",
    "FIFOScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "ResultGrid",
    "Searcher",
    "TrialScheduler",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "loguniform",
    "randint",
    "report",
    "uniform",
]
