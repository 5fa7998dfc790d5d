"""Stage Advantage on the port: per-frame advantages from a trained estimator, and their AWBC labels.

The pipeline (reference ``stage_advantage/README.md:7-25``):
  0. ``stage_progress_gt`` annotated by hand in the LeRobot parquets;
  1. the estimator trained (``scripts/train_torch.py ADVANTAGE_TORCH_*``,
     ``models/advantage.AdvantageEstimator``);
  2. per-frame advantages predicted over the episode videos (``evaluator`` and
     ``annotate``; ``scripts/annotate_advantage_torch.py``);
  3. the advantages discretized into ``task_index`` labels and
     advantage-suffixed prompts (``discretize``;
     ``scripts/discretize_advantage_torch.py``);
  4. AWBC fine-tunes on them (``pi05_*_awbc``, whose prompt is the task).
"""

from kai0_tpu_torch.advantage.annotate import annotate_dataset  # noqa: F401
from kai0_tpu_torch.advantage.discretize import discretize_dataset  # noqa: F401
from kai0_tpu_torch.advantage.evaluator import SimpleValueEvaluator  # noqa: F401
