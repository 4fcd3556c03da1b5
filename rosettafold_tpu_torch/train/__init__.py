"""Training: 6D-geometry labels and losses, the train step with its optimizer,
checkpoints and the `fit` loop (port of rosettafold_tpu/train)."""
