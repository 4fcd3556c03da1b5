"""Seeded input makers: A3M files for the serving mixes and (A3M, PDB)
pairs for training, written under the run's TMPDIR, and `plan`, the one
generator that turns a mix file into the run's requests."""
