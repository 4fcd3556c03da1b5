"""Multi-GPU training: the ('dp', 'sp', 'tp') mesh over torch.distributed and
the dry run of one sharded step (port of rosettafold_tpu/parallel)."""
