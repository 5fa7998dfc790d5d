"""Model Arithmetic on the port: mixing fine-tuned π₀ / π₀.₅ checkpoints in weight space (``core``).

Entry points: ``scripts/dump_data_torch.py`` pickles validation batches from
the training loader, and ``scripts/model_arithmetic_torch.py`` chooses the
weights (average, manual, inverse loss, gradient descent, greedy) and writes
the mixed ``model.safetensors`` and ``norm_stats.json``.
"""
