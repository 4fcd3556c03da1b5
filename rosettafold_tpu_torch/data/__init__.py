"""Host-side data pipeline (numpy): A3M in, PDB out. The port's own copy of
what `predict` uses from rosettafold_tpu/data, held equal by tests."""
