"""Host-side data pipeline (numpy): A3M and PDB in, PDB out, and the training
batches. The port's own copy of rosettafold_tpu/data, held equal by tests."""
