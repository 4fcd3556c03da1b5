"""The benchmark's plain reference: a frozen copy of rosettafold_tpu_torch's
plain path (models/, ops/{knn,performer,sinusoidal,so3}.py, config.py and the
A3M featurizer), with the kernel entries and the mesh hooks replaced by
`_nokernels` and `_mesh`. It imports nothing of the program, so a later
change to the program cannot move the yardstick. It runs in float32 with
attn_impl="xla" (`reference_config`), works out its own FAVOR+ projections,
SO(3) bases, kNN neighbourhoods and bucket selection, and takes only the
weights that the benchmark drew (`portbench.weights`)."""
