"""Measurement tools run on the card, e.g.
``python3 -m tpu_knn_torch.tools.groupmin_ablation``."""
